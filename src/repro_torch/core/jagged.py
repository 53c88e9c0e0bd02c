"""Jagged sparse-feature batches -- the paper's (indices, lengths) format.

The counterpart of ``repro.core.jagged``: a padded-dense batch of
``indices (T, B, L)`` + ``lengths (T, B)`` tensors, slots ``>= lengths``
masked, plus the host-side CSR <-> padded conversions and the synthetic
generators (numpy, so that one seed gives the reference's exact draws).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class JaggedBatch:
    """A batch of multi-hot categorical features for ``T`` embedding tables.

    Attributes:
      indices: int (T, B, L) -- row ids; slots beyond ``lengths`` are
        padding and may hold anything that is masked downstream.
      lengths: int (T, B) -- valid lookups per sample (0 <= lengths <= L).
      weights: optional float (T, B, L) -- per-lookup weights.
    """

    indices: torch.Tensor
    lengths: torch.Tensor
    weights: Optional[torch.Tensor] = None

    @property
    def num_tables(self) -> int:
        return self.indices.shape[0]

    @property
    def batch_size(self) -> int:
        return self.indices.shape[1]

    @property
    def max_pooling(self) -> int:
        return self.indices.shape[2]

    def mask(self) -> torch.Tensor:
        """Bool (T, B, L): True where the lookup slot is valid."""
        L = self.max_pooling
        return (torch.arange(L, device=self.indices.device)[None, None, :]
                < self.lengths[:, :, None])

    def effective_weights(self) -> torch.Tensor:
        """Float32 (T, B, L): pooling weights with padding zeroed."""
        m = self.mask()
        if self.weights is None:
            return m.to(torch.float32)
        return torch.where(m, self.weights, 0.0).to(torch.float32)


# ---------------------------------------------------------------------------
# Host-side CSR (paper format) <-> padded-dense conversions
# ---------------------------------------------------------------------------

def csr_to_padded(indices: np.ndarray, lengths: np.ndarray,
                  max_pooling: Optional[int] = None):
    """Convert the paper's flat (indices, lengths) format to padded (B, L).

    Returns (padded_indices (B, L) int32, lengths (B,) int32)."""
    indices = np.asarray(indices, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    if indices.ndim != 1 or lengths.ndim != 1:
        raise ValueError("csr_to_padded expects 1-D indices and lengths")
    if int(lengths.sum()) != indices.shape[0]:
        raise ValueError(
            f"lengths.sum()={int(lengths.sum())} != len(indices)="
            f"{indices.shape[0]}")
    B = lengths.shape[0]
    L = int(max_pooling if max_pooling is not None
            else max(1, lengths.max(initial=0)))
    if lengths.max(initial=0) > L:
        raise ValueError(f"max length {lengths.max()} exceeds pad target {L}")
    out = np.zeros((B, L), dtype=np.int32)
    offsets = offsets_from_lengths(lengths)
    for b in range(B):
        out[b, : lengths[b]] = indices[offsets[b]: offsets[b + 1]]
    return out, lengths


def padded_to_csr(padded: np.ndarray, lengths: np.ndarray):
    """Inverse of :func:`csr_to_padded` -- recover flat indices."""
    padded = np.asarray(padded)
    lengths = np.asarray(lengths, dtype=np.int32)
    flat = [padded[b, : lengths[b]] for b in range(padded.shape[0])]
    return (np.concatenate(flat) if flat
            else np.zeros((0,), np.int32)).astype(np.int32), lengths


def offsets_from_lengths(lengths: np.ndarray) -> np.ndarray:
    """CSR row offsets: [0, cumsum(lengths)] -- length B + 1."""
    lengths = np.asarray(lengths, dtype=np.int64)
    return np.concatenate([[0], np.cumsum(lengths)])


# ---------------------------------------------------------------------------
# Synthetic generation (numpy: the same seed gives the reference's draws)
# ---------------------------------------------------------------------------

def zipf_ranks(rng: np.random.Generator, a: float, num_rows: int,
               size) -> np.ndarray:
    """0-based Zipfian rank samples over exactly ``num_rows`` ids.

    ``a > 1``: numpy's infinite-support sampler, ranks clipped to
    ``num_rows``.  ``0 < a <= 1``: inverse-CDF draws from the truncated
    zeta over ``num_rows`` ids.  Rank 0 is the hottest id."""
    if a <= 0:
        raise ValueError(f"zipf_a must be positive, got {a}")
    if a <= 1.0:
        pmf = np.arange(1, num_rows + 1, dtype=np.float64) ** -a
        cdf = np.cumsum(pmf)
        cdf /= cdf[-1]
        return np.searchsorted(cdf, rng.random(size))
    ranks = rng.zipf(a, size=size)
    return np.minimum(ranks - 1, num_rows - 1)


def random_jagged_batch(rng: np.random.Generator, num_tables: int,
                        batch_size: int, pooling: int, num_rows: int, *,
                        fixed_pooling: bool = True,
                        zipf_a: Optional[float] = None,
                        device=None) -> JaggedBatch:
    """Random batch matching the paper's generator (uniform random ids, or
    Zipfian with ``zipf_a``), as tensors on ``device`` (None: the card)."""
    device = resolve_device(device)
    T, B, L = num_tables, batch_size, pooling
    if zipf_a is None:
        idx = rng.integers(0, num_rows, size=(T, B, L), dtype=np.int64)
    else:
        idx = zipf_ranks(rng, zipf_a, num_rows, (T, B, L))
    if fixed_pooling:
        lengths = np.full((T, B), L, dtype=np.int32)
    else:
        lengths = rng.integers(0, L + 1, size=(T, B), dtype=np.int32)
    return JaggedBatch(
        indices=torch.as_tensor(idx.astype(np.int32), device=device),
        lengths=torch.as_tensor(lengths, device=device))
