"""Deterministic synthetic DLRM batches (Criteo-like).

The counterpart of ``repro.data.synthetic.dlrm_batches`` and
``dlrm_drift_batches``: the batch at step ``s`` is a pure function of
``(seed, s)``, drawn with numpy exactly as the reference draws it, and
yielded as tensors on the device asked for.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.core.jagged import (JaggedBatch,
                                     random_jagged_batch, zipf_ranks)
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


def dlrm_drift_batches(cfg: DLRMConfig, batch: int, *, seed: int = 0,
                       start_step: int = 0, zipf_a: float = 1.05,
                       rotate_every: int = 0,
                       rotate_shift: Optional[int] = None,
                       fixed_pooling: bool = True,
                       device=None) -> Iterator[Dict]:
    """Flash-crowd hot-set rotation: the drift detector's test signal, on
    ``device`` (None: the card).

    Ids are Zipfian ranks shifted by a phase offset that jumps every
    ``rotate_every`` steps: ``id = (rank + phase * shift) % rows`` with
    ``phase = step // rotate_every``.  Each jump relocates the whole
    popularity ranking, so a cache warmed (and a plan priced) on phase 0's
    hot set under-serves phase 1: the divergence
    ``repro_torch.obs.slo.DriftDetector`` must flag.  ``rotate_every=0``
    is the stationary control, bitwise the drifting stream's first phase.
    Yields {"dense", "batch": JaggedBatch, "labels", "phase"}."""
    if rotate_every < 0:
        raise ValueError(
            f"rotate_every must be >= 0 (0 = stationary control), got "
            f"{rotate_every}")
    device = resolve_device(device)
    R = cfg.rows_per_table
    shift = R // 3 if rotate_shift is None else int(rotate_shift)
    if rotate_every and not 0 < shift < R:
        raise ValueError(
            f"rotate_shift must be in (0, {R}) to move the hot set, "
            f"got {shift}")
    T, L = cfg.num_sparse_features, cfg.pooling
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        ranks = zipf_ranks(rng, zipf_a, R, (T, batch, L))
        phase = 0 if rotate_every == 0 else step // rotate_every
        idx = (ranks + phase * shift) % R
        if fixed_pooling:
            lengths = np.full((T, batch), L, dtype=np.int32)
        else:
            lengths = rng.integers(0, L + 1, size=(T, batch),
                                   dtype=np.int32)
        dense = rng.standard_normal(
            (batch, cfg.num_dense_features)).astype(np.float32)
        labels = (rng.random(batch) < 0.25).astype(np.float32)
        yield {"dense": torch.as_tensor(dense, device=device),
               "batch": JaggedBatch(
                   indices=torch.as_tensor(idx.astype(np.int32),
                                           device=device),
                   lengths=torch.as_tensor(lengths, device=device)),
               "labels": torch.as_tensor(labels, device=device),
               "phase": phase}
        step += 1
