"""Deterministic synthetic data: LM token batches and DLRM batches
(Criteo-like).

The counterpart of ``repro.data.synthetic``'s ``lm_batches``,
``dlrm_batches``, ``dlrm_drift_batches`` and ``Prefetcher``: the batch at
step ``s`` is a pure function of ``(seed, s)``, drawn with numpy exactly
as the reference draws it, so a trainer resumed at step k sees the same
batches from step k on.  ``lm_batches`` yields numpy arrays, bitwise the
reference's (the trainer moves them to its device); the DLRM streams
yield tensors on the device asked for.  :class:`Prefetcher` runs any
such iterator on a host thread behind a bounded queue.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.core.jagged import (JaggedBatch,
                                     random_jagged_batch, zipf_ranks)
from repro_torch.utils.device import resolve_device


def lm_batches(cfg: ModelConfig, batch: int, seq: int, *,
               seed: int = 0, start_step: int = 0,
               zipf_a: float = 1.2) -> Iterator[Dict[str, np.ndarray]]:
    """Yields numpy ``{"tokens" (B, S), "labels" (B, S)}`` int32, Zipf
    ranks clipped to the vocabulary (labels: the tokens shifted by one),
    plus ``"frames"`` (B, encoder_seq_len, d) for the audio family and
    ``"patches"`` (B, vision_tokens, vision_dim) for the vlm family,
    N(0, 1) f32."""
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        ranks = rng.zipf(zipf_a, size=(batch, seq + 1)).astype(np.int64)
        toks = np.minimum(ranks - 1, cfg.vocab_size - 1).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (batch, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
        yield out
        step += 1


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


class Prefetcher:
    """Bounded-queue host prefetch around any batch iterator: a daemon
    thread fills a queue of ``depth`` batches; :meth:`close` stops it."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
