"""Deterministic synthetic DLRM batches (Criteo-like).

The counterpart of ``repro.data.synthetic.dlrm_batches``: the batch at step
``s`` is a pure function of ``(seed, s)``, drawn with numpy exactly as the
reference draws it, and yielded as tensors on the device asked for.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.core.jagged import random_jagged_batch
from repro_torch.utils.device import resolve_device


def dlrm_batches(cfg: DLRMConfig, batch: int, *, seed: int = 0,
                 start_step: int = 0, zipf_a: Optional[float] = None,
                 fixed_pooling: bool = True,
                 device=None) -> Iterator[Dict]:
    """Yields {"dense", "batch": JaggedBatch, "labels"} per step, on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        jb = random_jagged_batch(
            rng, cfg.num_sparse_features, batch, cfg.pooling,
            cfg.rows_per_table, fixed_pooling=fixed_pooling, zipf_a=zipf_a,
            device=device)
        dense = rng.standard_normal(
            (batch, cfg.num_dense_features)).astype(np.float32)
        labels = (rng.random(batch) < 0.25).astype(np.float32)
        yield {"dense": torch.as_tensor(dense, device=device), "batch": jb,
               "labels": torch.as_tensor(labels, device=device)}
        step += 1
