"""``CachedEmbeddingBag`` -- tiered lookup: a device slot pool over a cold
tier (the serving host's memory, or row shards of simulated remote hosts).

The counterpart of ``repro.cache.cached_bag`` for one serving device.  The
serving protocol has two explicit steps:

  1. ``prefetch(batch)`` -- host side: the :class:`SlotPoolManager` admits
     the batch's working set (LFU/LRU), the missing rows are fetched from
     the cold tier and written into the flat ``(sum S_t, D)`` pool with one
     in-place scatter, :class:`CacheStats` is updated, and the batch comes
     back with ids remapped to table-local pool slots;
  2. ``lookup``/``device_lookup`` -- device side: ONE fused TBE launch over
     the pool, the same kernel as the uncached path.

Exactness: after ``prefetch`` every valid lookup's row is resident, and the
pooled output is bitwise-equal to the uncached lookup -- same kernel, same
weights, same summation order, same row payloads.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.cache.manager import PrefetchPlan, SlotPoolManager
from repro_torch.cache.stats import CacheStats
from repro_torch.cache.tiers import HostStore, RemoteStore, SlotPool, \
    TableStore
from repro_torch.core.cache_config import CacheConfig
from repro_torch.core.embedding_bag import EmbeddingBagConfig
from repro_torch.core.jagged import JaggedBatch
from repro_torch.kernels import ops as kops
from repro_torch.utils.device import resolve_device


def _valid_mask(indices: np.ndarray, lengths: Optional[np.ndarray]):
    """(T, B, L) ids + (T, B) lengths -> (indices, (T, B, L) bool valid);
    ``lengths`` None means every slot is a live lookup."""
    indices = np.asarray(indices)
    if lengths is None:
        return indices, np.ones(indices.shape, bool)
    L = indices.shape[-1]
    return indices, np.arange(L) < np.asarray(lengths)[..., None]


def make_cold_store(tables: torch.Tensor, cache: CacheConfig, *,
                    device=None) -> TableStore:
    """Build the cold tier named by ``cache.cold_tier``; a remote tier's
    shards live on ``device`` (None: the card)."""
    if cache.cold_tier == "host":
        return HostStore(tables)
    if cache.cold_tier == "remote":
        return RemoteStore(tables, hosts=cache.remote_hosts or None,
                           backend=cache.remote_backend, device=device)
    raise ValueError(
        f"unknown cold_tier {cache.cold_tier!r}; pick 'host' or 'remote'")


class CachedEmbeddingBag:
    """``cold_store``/``stats`` share another bag's cold tier and counters:
    the pipeline's later buffers reuse the first buffer's (one host copy
    of the tables, one set of remote shards, one ``CacheStats``)."""

    def __init__(self, tables: torch.Tensor, cfg: EmbeddingBagConfig, *,
                 device=None, cold_store: Optional[TableStore] = None,
                 stats: Optional[CacheStats] = None):
        if cfg.combiner not in ("sum", "mean"):
            raise NotImplementedError(
                f"CachedEmbeddingBag: combiner {cfg.combiner!r} is not "
                f"supported")
        self.cfg = cfg
        self.device = resolve_device(device)
        cc = cfg.cache
        if tables.dim() != 3:
            raise ValueError(
                f"tables must be (T, R, D), got {tuple(tables.shape)}")
        self.cold = cold_store if cold_store is not None \
            else make_cold_store(tables, cc, device=self.device)
        T, R, D = tables.shape
        self.dtype = tables.dtype
        # slot sizing: the per-table vector wins over the uniform scalar
        if cc.rows_per_table is not None:
            S = np.asarray(cc.rows_per_table, np.int64)
        else:
            S = int(cc.rows)
        if np.min(S) <= 0:
            raise ValueError(
                "cache rows must be > 0 (for every table) to build a "
                "CachedEmbeddingBag (set CacheConfig.rows / rows_per_table)")
        self.mgr = SlotPoolManager(
            T, R, S, cc.policy,
            rows_per_host=self.cold.rows_per_host, home=self.cold.home)
        self.hot = SlotPool(T, self.mgr.S, D, self.dtype, device=self.device,
                            slots_per_table=self.mgr.slots_per_table)
        # the kernel's per-table slot offsets, on the device once
        self._row_offsets = torch.as_tensor(
            self.mgr.slot_offsets[:-1], dtype=torch.int32, device=self.device)
        self.stats = stats if stats is not None else CacheStats()
        self.row_bytes = D * tables.element_size()
        if cc.warmup_freqs is not None:
            self.mgr.seed_frequencies(np.asarray(cc.warmup_freqs))
            self._apply_fetch(self.mgr.warmup_admit(), count_batch=False)

    @property
    def pool(self) -> torch.Tensor:
        """The hot tier's flat ``(sum S_t, D)`` device tensor."""
        return self.hot.array

    def _apply_fetch(self, plan: PrefetchPlan, *, count_batch: bool) -> None:
        """Execute a plan's cold fetch + pool scatter, update stats.

        prepare()/warmup_admit() already committed residency for the
        fetched rows, so any error between the cold fetch and the scatter
        rolls it back (``invalidate_fetch``): no slot ever claims a row
        that was not copied."""
        t0 = time.perf_counter()
        scatter_s = 0.0
        if plan.fetch_rows.size:
            try:
                rows = self.cold.fetch(plan.fetch_tables, plan.fetch_rows)
                ts = time.perf_counter()
                self.hot.scatter(plan.flat_addr(self.mgr.slot_offsets), rows)
                scatter_s = time.perf_counter() - ts
            except BaseException:
                self.mgr.invalidate_fetch(plan)
                raise
        self.stats.add_time("prefetch", time.perf_counter() - t0 - scatter_s)
        self.stats.add_time("scatter", scatter_s)
        self.stats.update(**plan.stats_kwargs(self.row_bytes),
                          count_batch=count_batch)

    def prefetch_arrays(self, indices: np.ndarray,
                        lengths: Optional[np.ndarray]) -> np.ndarray:
        """Host-array prefetch: (T, B, L) ids -> (T, B, L) pool slots.

        Pulls every missing row of the batch into the pool (one cold fetch,
        one scatter), updates stats, and returns the slot-remapped ids.
        ``lengths`` None means every slot is valid."""
        t0 = time.perf_counter()
        plan = self.mgr.prepare(*_valid_mask(indices, lengths))
        self.stats.add_time("prefetch", time.perf_counter() - t0)
        self._apply_fetch(plan, count_batch=True)
        return plan.remapped

    def prefetch(self, batch: JaggedBatch) -> JaggedBatch:
        """Admit ``batch``'s working set; return the slot-remapped batch."""
        remapped = self.prefetch_arrays(
            batch.indices.cpu().numpy(),
            None if batch.lengths is None else batch.lengths.cpu().numpy())
        return JaggedBatch(
            torch.as_tensor(remapped, device=batch.indices.device),
            batch.lengths, batch.weights)

    def device_lookup(self, pool: torch.Tensor, indices: torch.Tensor,
                      lengths: Optional[torch.Tensor],
                      weights: Optional[torch.Tensor]) -> torch.Tensor:
        """Hot path: flat (sum S_t, D) pool x (T, B, L) table-local slot
        ids -> (B, T, D), ONE fused TBE launch."""
        out = kops.embedding_bag_batched_flat(
            pool, self._row_offsets, indices, lengths, weights,
            combiner=self.cfg.combiner)
        return out.transpose(0, 1)

    def lookup(self, batch: JaggedBatch) -> torch.Tensor:
        """Tiered pooled lookup, drop-in for ``pooled_lookup_local``:
        prefetch, then the device lookup."""
        batch = self.prefetch(batch)
        return self.device_lookup(self.pool, batch.indices, batch.lengths,
                                  batch.weights)

    @property
    def pool_bytes(self) -> int:
        return self.hot.nbytes
