"""``DoubleBufferedSlotPool`` -- epoch-partitioned slot pools for pipelining.

The counterpart of ``repro.pipeline.double_buffer``.  The serialized
cached engine admits a micro-batch into ONE slot pool and then reads that
same pool, so cold fetch -> pool scatter -> forward is a chain.  This
module breaks the chain by splitting the slot space into ``depth``
independent buffers (each a full flat ``(sum S_t, D)``
:class:`~repro_torch.cache.SlotPool` with its own
:class:`~repro_torch.cache.manager.SlotPoolManager`), rotating over one
SHARED cold tier and one SHARED :class:`~repro_torch.cache.stats.CacheStats`:

  * the LIVE buffer (``buffers[epoch % depth]``) is what the in-flight
    forward's fused TBE kernel reads -- nothing writes it;
  * the SHADOW buffer (``buffers[(epoch + 1) % depth]``) receives the
    NEXT micro-batch's cold fetch and pool scatter while the live forward
    runs;
  * ``swap()`` rotates the ring: the shadow becomes live and its
    manager's epoch advances, which is what entitles the prepared batch to
    be served.

Epoch protocol (enforced, not assumed): :meth:`prepare_next` stamps the
plan with the ring epoch the batch will be SERVED in; :meth:`commit_next`
refuses a plan whose epoch is not the ring's next epoch (a dropped or
double swap would otherwise serve a batch from a pool that never received
its rows).  A failed cold fetch or scatter invalidates the plan's
residency (``SlotPoolManager.invalidate_fetch``), so no slot claims a row
whose payload never arrived.

Each buffer sees every ``depth``-th micro-batch, so per-buffer hit rates
trail the single-pool cache (the device memory cost is ``depth`` pools);
correctness never depends on residency history -- a batch's working set
is fully resident in ITS buffer before its forward runs, and the pooled
output is bitwise-invariant to slot layout.

The facade (``prefetch_arrays`` / ``pool`` / ``stats``) makes this class a
drop-in for :class:`~repro_torch.cache.cached_bag.CachedEmbeddingBag` in
``DLRMEngine.flush``: the serialized path serves from the live buffer,
which is the pipeline's capacity-overflow fallback.  Which device stream
each stage runs on is the scheduler's business (``pipeline/scheduler.py``);
this class only moves data on the current stream.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.cache.cached_bag import CachedEmbeddingBag, _valid_mask
from repro_torch.cache.manager import PrefetchPlan
from repro_torch.core.embedding_bag import EmbeddingBagConfig


class DoubleBufferedSlotPool:
    def __init__(self, tables: torch.Tensor, cfg: EmbeddingBagConfig, *,
                 depth: int = 2, device=None, remote_ctx=None):
        if depth < 2:
            raise ValueError(
                f"DoubleBufferedSlotPool needs depth >= 2 (got {depth}); "
                f"depth 1 is the serialized single-pool CachedEmbeddingBag")
        self.depth = depth
        first = CachedEmbeddingBag(tables, cfg, device=device,
                                   remote_ctx=remote_ctx)
        self.device = first.device
        self.stats = first.stats
        # later buffers share the first's cold store (one host copy of the
        # tables / one set of remote shards, or this rank's one shard when
        # the remote tier's hosts are ranks) and its stats record; each
        # keeps its own manager and pool.  cfg.cache.warmup_freqs seeds
        # EVERY buffer (the warmup fetch traffic is counted once per buffer)
        self.buffers = [first] + [
            CachedEmbeddingBag(tables, cfg, device=device,
                               cold_store=first.cold, stats=self.stats)
            for _ in range(depth - 1)]
        self.epoch = 0

    # -- ring state ----------------------------------------------------------

    @property
    def live(self) -> CachedEmbeddingBag:
        """The buffer the in-flight forward reads."""
        return self.buffers[self.epoch % self.depth]

    @property
    def shadow(self) -> CachedEmbeddingBag:
        """The buffer the NEXT micro-batch's prefetch targets."""
        return self.buffers[(self.epoch + 1) % self.depth]

    def swap(self) -> int:
        """Rotate the ring: the shadow buffer becomes live.

        Advances the shadow manager's epoch first, so the plan prepared by
        :meth:`prepare_next` (stamped ``epoch + 1``) is now the served
        epoch: the swap is what publishes the prepared batch."""
        self.shadow.mgr.advance_epoch()
        self.epoch += 1
        return self.epoch

    # -- pipeline stages (admit / fetch / scatter) ---------------------------

    def prepare_next(self, indices: np.ndarray,
                     lengths: Optional[np.ndarray]) -> PrefetchPlan:
        """ADMIT: plan the next micro-batch's working set into the shadow
        buffer (host metadata only -- no payload moves).

        Raises :class:`~repro_torch.cache.manager.CacheCapacityError`
        atomically when the working set overflows the shadow pool: the
        caller falls back to a serialized split flush (nothing to roll
        back)."""
        plan = self.shadow.mgr.prepare_next(*_valid_mask(indices, lengths))
        # re-stamp with the RING epoch: the buffer-local epoch repeats
        # every `depth` swaps, so only the ring epoch can tell a plan
        # prepared for THIS swap from one left over from a previous lap
        plan.epoch = self.epoch + 1
        return plan

    def _owner_of(self, plan: PrefetchPlan) -> CachedEmbeddingBag:
        """The buffer a plan's admissions live in: ring epoch p is served
        by ``buffers[p % depth]``, resolvable even after a swap moved
        ``shadow`` elsewhere, so a rollback always hits the right
        manager."""
        return self.buffers[plan.epoch % self.depth]

    def fetch_next(self, plan: PrefetchPlan) -> Optional[torch.Tensor]:
        """FETCH: pull the plan's missed rows from the cold tier.

        Touches only the shadow manager on failure, so it is safe on a
        background thread while the live forward computes.  A failed fetch
        invalidates the plan's committed residency, so the shadow never
        claims uncopied rows."""
        if not plan.fetch_rows.size:
            return None
        bag = self._owner_of(plan)
        try:
            return bag.cold.fetch(plan.fetch_tables, plan.fetch_rows)
        except BaseException:
            bag.mgr.invalidate_fetch(plan)
            raise

    def commit_next(self, plan: PrefetchPlan,
                    rows: Optional[torch.Tensor]) -> None:
        """SCATTER: write the fetched rows into the shadow pool and account
        the batch in the shared stats.

        Refuses a stale plan (epoch mismatch = a dropped swap or a double
        commit) AND rolls its residency back: the owning buffer's slots
        must not keep claiming rows whose payload never arrived (a
        double-committed plan's rows did arrive; dropping their residency
        only forces a harmless re-fetch).  A failed scatter rolls back like
        the serialized path."""
        bag = self._owner_of(plan)
        if plan.epoch != self.epoch + 1:
            bag.mgr.invalidate_fetch(plan)
            raise RuntimeError(
                f"stale prefetch plan: targets ring epoch {plan.epoch} but "
                f"the next epoch is {self.epoch + 1} — a swap was dropped "
                f"or the plan was committed twice")
        if rows is not None:
            try:
                bag.hot.scatter(plan.flat_addr(bag.mgr.slot_offsets), rows)
            except BaseException:
                bag.mgr.invalidate_fetch(plan)
                raise
        self.stats.update(**plan.stats_kwargs(bag.row_bytes))

    # -- serialized facade (CachedEmbeddingBag drop-in) ----------------------

    @property
    def pool(self) -> torch.Tensor:
        """The LIVE buffer's flat ``(sum S_t, D)`` device pool."""
        return self.live.pool

    def prefetch_arrays(self, indices: np.ndarray,
                        lengths: Optional[np.ndarray]) -> np.ndarray:
        """Serialized prefetch against the LIVE buffer: the path
        ``DLRMEngine.flush`` takes, and the pipeline's capacity-overflow
        fallback."""
        return self.live.prefetch_arrays(indices, lengths)

    @property
    def pool_bytes(self) -> int:
        """Device memory held by the ring (``depth`` pools)."""
        return sum(b.pool_bytes for b in self.buffers)

    @property
    def row_bytes(self) -> int:
        return self.buffers[0].row_bytes
