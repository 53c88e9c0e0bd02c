"""Host-side slot-pool state machine: id->slot indirection + LFU/LRU.

A numpy-only copy of ``repro.cache.manager``: the port keeps its own copy
so that it imports nothing of the reference package, and the two make the
same admission and eviction decisions on the same traffic.

``SlotPoolManager`` owns the *metadata* of the tiered cache — which table
row occupies which HBM slot — and decides admission/eviction per batch.
It never touches device memory: :meth:`prepare` returns a
:class:`PrefetchPlan` naming the rows to copy host->device and the
slot-remapped index tensor;
:class:`repro_torch.cache.cached_bag.CachedEmbeddingBag` executes the copy
and the kernel.

State (all numpy, vectorized across rows; a small python loop over the
T tables):

  * ``slot_of_id (T, R) int32`` — the indirection table: row id -> pool
    slot (TABLE-LOCAL, in ``[0, S_t)``), -1 when the row is host-only.
    Device lookups remap through it.
  * ``id_of_slot (sum S_t,) int64`` — reverse map over the FLAT slot
    space, -1 for free slots; table ``t``'s slots are the contiguous
    segment ``[slot_offsets[t], slot_offsets[t+1])``
    (:meth:`id_of_slot_t` returns the per-table view).
  * ``freq (T, R) int64``       — per-row batch-frequency counters,
    accumulated over every prefetch (they PERSIST across eviction, so a
    re-admitted hot row keeps its rank — CacheEmbedding's
    ``ids_freq_mapping`` made dynamic).
  * ``last_used (sum S_t,) int64`` — per-slot touch tick for LRU, same
    flat layout as ``id_of_slot``.

Heterogeneous capacity (the planner -> engine round trip): ``slots``
may be a PER-TABLE vector ``S_t`` — e.g. each ``Placement.cache_rows``
of a :class:`repro.core.sharding_plan.ShardingPlan` — instead of one
global size.  The slot space is FLAT: table ``t`` owns exactly its own
``S_t`` slots at offset ``slot_offsets[t] = sum(S_u, u < t)``, matching
the flat ``(sum S_t, D)`` device pool the fused TBE kernel addresses
through its scalar-prefetched per-table offsets.  No padding slots
exist, so there is nothing to mark dead and ``live_nbytes`` is exact.
Capacity checks, eviction and warmup admission all run against ``S_t``.

Eviction (policy "lfu"): victim = resident slot whose row has the
smallest frequency counter.  Policy "lru": victim = slot with the oldest
touch tick.  Rows referenced by the *current* batch are pinned for the
duration of the call (the evict backlist), so a batch whose working set
fits in the pool can always be made fully resident.
"""
from __future__ import annotations

import dataclasses

import numpy as np

POLICIES = ("lfu", "lru")


class CacheCapacityError(RuntimeError):
    """A batch's unique working set exceeds the slot pool.

    Dedicated type so callers (DLRMEngine's micro-batch splitter) can
    react to THIS condition without swallowing unrelated RuntimeErrors
    (e.g. a device OOM during the pool copy)."""


@dataclasses.dataclass
class PrefetchPlan:
    """One batch's cache actions, to be applied by the owning bag.

    The fetch list is split PER COLD TIER: ``fetch_owner`` names the host
    owning each fetched row (every row == ``home`` under a single-host
    cold tier), so the bag can account host-link vs network traffic and a
    RemoteStore can batch the cross-host rows into one ``fetch_rows``
    collective."""

    remapped: np.ndarray     # (T, B, L) int32 slot ids (non-resident -> 0)
    fetch_tables: np.ndarray  # (M,) int32 table of each row to copy h->d
    fetch_rows: np.ndarray    # (M,) int64 host row id of each copied row
    fetch_slots: np.ndarray   # (M,) int64 destination slot of each row
    fetch_owner: np.ndarray = None   # (M,) int32 owning host of each row
    home: int = 0             # the serving host's rank in the cold tier
    epoch: int = 0            # pool epoch this plan's batch is SERVED in
    hits: int = 0             # per-lookup (see stats.py counting semantics)
    misses: int = 0
    misses_host: int = 0      # misses whose row the serving host owns
    misses_remote: int = 0    # misses served by a peer host's shard
    evictions: int = 0
    # per-table splits of the totals above — (T,) int64, None for plans
    # that carry no lookups (warmup admission)
    hits_t: np.ndarray = None
    misses_t: np.ndarray = None
    evictions_t: np.ndarray = None

    @property
    def fetch_remote_rows(self) -> int:
        """Unique fetched rows owned by peer hosts (network traffic)."""
        return 0 if self.fetch_owner is None else \
            int((self.fetch_owner != self.home).sum())

    @property
    def fetch_host_rows(self) -> int:
        """Unique fetched rows the serving host owns (h2d traffic)."""
        return int(self.fetch_rows.size - self.fetch_remote_rows)

    def flat_addr(self, slot_offsets: np.ndarray) -> np.ndarray:
        """Flat pool addresses ``slot_offsets[t] + slot`` of the fetched
        rows — the SlotPool.scatter address layout, in one place.
        ``slot_offsets`` is the ``(T + 1,)`` cumulative-``S_t`` vector
        (``SlotPoolManager.slot_offsets``)."""
        return np.asarray(slot_offsets, np.int64)[self.fetch_tables] \
            + self.fetch_slots

    def stats_kwargs(self, row_bytes: int) -> dict:
        """The CacheStats.update counters this plan accounts for — used
        by both the serialized bag and the pipelined pool so the two
        paths can never diverge in accounting."""
        return dict(
            hits=self.hits, misses=self.misses,
            misses_host=self.misses_host, misses_remote=self.misses_remote,
            evictions=self.evictions,
            bytes_h2d=self.fetch_host_rows * row_bytes,
            bytes_remote=self.fetch_remote_rows * row_bytes,
            fetch_host=self.fetch_host_rows,
            fetch_remote=self.fetch_remote_rows,
            hits_t=self.hits_t, misses_t=self.misses_t,
            evictions_t=self.evictions_t)


class SlotPoolManager:
    def __init__(self, num_tables: int, rows: int, slots,
                 policy: str = "lfu", *, rows_per_host: int = None,
                 home: int = 0):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown cache_policy {policy!r}; pick one of {POLICIES}")
        # ``slots``: one global size, or a per-table vector S_t (the
        # planner -> engine round trip).  The slot space is FLAT: table
        # t owns [slot_offsets[t], slot_offsets[t+1]) — no padding.
        slots_t = np.asarray(slots, np.int64)
        if slots_t.ndim == 0:
            slots_t = np.full(num_tables, int(slots_t), np.int64)
        if slots_t.shape != (num_tables,):
            raise ValueError(
                f"per-table slots must be a scalar or a ({num_tables},) "
                f"vector, got shape {slots_t.shape}")
        if (slots_t <= 0).any():
            raise ValueError(
                f"slot pool must be positive for every table, got "
                f"{slots_t.tolist()}")
        self.slots_per_table = np.minimum(slots_t, rows)
        self.T, self.R = num_tables, rows
        # largest per-table width (the old padded rectangle's S); kept as
        # a capacity summary — flat addressing never uses it
        self.S = int(self.slots_per_table.max(initial=0))
        # flat slot space: table t owns [slot_offsets[t], slot_offsets[t+1])
        self.slot_offsets = np.zeros(self.T + 1, np.int64)
        np.cumsum(self.slots_per_table, out=self.slot_offsets[1:])
        self.total_slots = int(self.slot_offsets[-1])
        self.policy = policy
        # cold-tier ownership layout: row r lives on host r // rows_per_host;
        # rows the serving host (``home``) owns are HOST-tier traffic,
        # everything else is REMOTE-tier.  Single-host default: all local.
        self.rows_per_host = int(rows_per_host or rows)
        self.home = int(home)
        self.slot_of_id = np.full((self.T, self.R), -1, np.int32)
        self.id_of_slot = np.full(self.total_slots, -1, np.int64)
        self.freq = np.zeros((self.T, self.R), np.int64)
        self.last_used = np.full(self.total_slots, -1, np.int64)
        self.tick = 0
        # pool epoch: advanced by the pipeline's buffer swap.  prepare()
        # plans for the CURRENT epoch (serialized serving: admit-then-
        # read); prepare_next() plans for epoch+1 — the batch admitted
        # NOW but served only after the owning buffer swaps live.
        self.epoch = 0

    def _owner(self, row_ids: np.ndarray) -> np.ndarray:
        """Owning host of each row id under the cold tier's row split."""
        return (np.asarray(row_ids, np.int64)
                // self.rows_per_host).astype(np.int32)

    def id_of_slot_t(self, t: int) -> np.ndarray:
        """Table ``t``'s ``(S_t,)`` segment of the flat reverse map —
        a WRITABLE view (basic slice) indexed by table-local slot id."""
        return self.id_of_slot[self.slot_offsets[t]:self.slot_offsets[t + 1]]

    def last_used_t(self, t: int) -> np.ndarray:
        """Table ``t``'s ``(S_t,)`` segment of the flat LRU ticks (view)."""
        return self.last_used[self.slot_offsets[t]:self.slot_offsets[t + 1]]

    @property
    def resident_rows(self) -> int:
        return int((self.id_of_slot >= 0).sum())

    def prepare(self, indices: np.ndarray, valid: np.ndarray) -> PrefetchPlan:
        """Admit this batch's working set; return the slot remap + fetches.

        Args:
          indices: (T, B, L) table-local row ids (padding slots arbitrary).
          valid:   (T, B, L) bool — True where the lookup is within-length.
        """
        T = self.T
        indices = np.asarray(indices)
        valid = np.asarray(valid, bool)
        plan_t, plan_r, plan_s = [], [], []
        misses_remote = 0
        hits_t = np.zeros(T, np.int64)
        misses_t = np.zeros(T, np.int64)
        evictions_t = np.zeros(T, np.int64)
        remapped = np.zeros(indices.shape, np.int32)

        # Validate EVERY table before mutating ANY state: prepare must be
        # atomic — a mid-loop raise after table 0's admissions would leave
        # slot_of_id claiming rows whose payload the bag never copied, and
        # later lookups would silently serve stale pool slots.
        per_table = []
        for t in range(T):
            ids_t = indices[t][valid[t]].astype(np.int64)
            if ids_t.size and (ids_t.min() < 0 or ids_t.max() >= self.R):
                raise IndexError(
                    f"table {t}: lookup ids outside [0, {self.R})")
            uniq, counts = np.unique(ids_t, return_counts=True)
            if uniq.size > self.slots_per_table[t]:
                raise CacheCapacityError(
                    f"table {t}: batch working set ({uniq.size} unique rows)"
                    f" exceeds the slot pool ({self.slots_per_table[t]} "
                    f"slots) — raise CacheConfig.rows (or this table's "
                    f"rows_per_table entry) or shrink the batch")
            per_table.append((uniq, counts))

        for t in range(T):
            uniq, counts = per_table[t]
            self.freq[t, uniq] += counts
            # table t's (S_t,) writable views into the flat slot space;
            # slot ids below stay TABLE-LOCAL (the kernel's offsets and
            # PrefetchPlan.flat_addr re-add slot_offsets[t])
            ios = self.id_of_slot_t(t)
            lru = self.last_used_t(t)

            slots_u = self.slot_of_id[t, uniq]
            resident = slots_u >= 0
            hits_t[t] = int(counts[resident].sum())
            misses_t[t] = int(counts[~resident].sum())
            miss_ids = uniq[~resident]
            misses_remote += int(
                counts[~resident][self._owner(miss_ids) != self.home].sum())

            if miss_ids.size:
                free = np.flatnonzero(ios == -1)
                need = miss_ids.size - free.size
                if need > 0:
                    victims = self._pick_victims(t, need, slots_u[resident])
                    evicted = ios[victims]
                    self.slot_of_id[t, evicted] = -1
                    ios[victims] = -1
                    evictions_t[t] += need
                    free = np.concatenate([free, victims])
                target = free[: miss_ids.size]
                self.slot_of_id[t, miss_ids] = target
                ios[target] = miss_ids
                plan_t.append(np.full(miss_ids.size, t, np.int32))
                plan_r.append(miss_ids)
                plan_s.append(target.astype(np.int64))

            # LRU touch: every slot referenced by this batch (hit or fresh)
            lru[self.slot_of_id[t, uniq]] = self.tick

            slot = self.slot_of_id[t, np.clip(indices[t], 0, self.R - 1)]
            remapped[t] = np.where(slot >= 0, slot, 0)

        self.tick += 1
        cat = lambda xs, dt: (np.concatenate(xs) if xs
                              else np.zeros((0,), dt))
        fetch_rows = cat(plan_r, np.int64)
        misses = int(misses_t.sum())
        return PrefetchPlan(
            remapped=remapped,
            fetch_tables=cat(plan_t, np.int32),
            fetch_rows=fetch_rows,
            fetch_slots=cat(plan_s, np.int64),
            fetch_owner=self._owner(fetch_rows),
            home=self.home,
            epoch=self.epoch,
            hits=int(hits_t.sum()), misses=misses,
            misses_host=misses - misses_remote,
            misses_remote=misses_remote,
            evictions=int(evictions_t.sum()),
            hits_t=hits_t, misses_t=misses_t, evictions_t=evictions_t,
        )

    # -- pipelined serving: epoch-aware admission (repro/pipeline/) ----------

    def prepare_next(self, indices: np.ndarray,
                     valid: np.ndarray) -> PrefetchPlan:
        """Plan the NEXT micro-batch's working set at admission time.

        Identical admission/eviction to :meth:`prepare` — the manager
        already knows the next batch's working set when it is submitted
        — but the returned plan is stamped for epoch ``self.epoch + 1``:
        its scatter targets the SHADOW buffer while the live buffer is
        still being read, and the batch is served only after the swap
        calls :meth:`advance_epoch`.  Committing a plan whose epoch does
        not match the buffer's next epoch means a swap was dropped (the
        plan is stale) and must be refused — see
        ``DoubleBufferedSlotPool.commit_next``.
        """
        plan = self.prepare(indices, valid)
        plan.epoch = self.epoch + 1
        return plan

    def advance_epoch(self) -> int:
        """The owning buffer swapped live: its pool now serves the epoch
        the last ``prepare_next`` plan targeted."""
        self.epoch += 1
        return self.epoch

    # -- offline warmup (CacheEmbedding-style ids_freq_mapping) --------------

    def seed_frequencies(self, freqs: np.ndarray) -> None:
        """Seed the persistent per-row counters from logged frequencies.

        ``freqs`` is the offline ``ids_freq_mapping``: (T, R) observed
        lookup counts per row (a (R,) array broadcasts to every table).
        Counters ADD so re-seeding composes with live traffic; LFU
        eviction then ranks cold-start victims by the logged history
        instead of treating every fresh row as frequency ~1.
        """
        freqs = np.asarray(freqs)
        if freqs.ndim == 1:
            freqs = np.broadcast_to(freqs, (self.T, self.R))
        if freqs.shape != (self.T, self.R):
            raise ValueError(
                f"warmup freqs must be (T={self.T}, R={self.R}) or "
                f"(R={self.R},), got {freqs.shape}")
        if freqs.min() < 0:
            raise ValueError("warmup freqs must be non-negative")
        self.freq += freqs.astype(np.int64)

    def warmup_admit(self) -> PrefetchPlan:
        """Admit each table's top-``S_t`` rows by (seeded) frequency.

        Returns the fetch plan for the rows newly admitted — executed by
        the bag like a batch prefetch, but with NO lookups: the first
        real flush then hits instead of paying the cold-start miss burst.
        Only rows with a positive counter are admitted (an all-zero seed
        admits nothing)."""
        plan_t, plan_r, plan_s = [], [], []
        for t in range(self.T):
            ios = self.id_of_slot_t(t)
            order = np.argsort(-self.freq[t], kind="stable")
            top = order[: self.slots_per_table[t]]
            top = top[self.freq[t, top] > 0]
            fresh = top[self.slot_of_id[t, top] < 0]
            if not fresh.size:
                continue
            free = np.flatnonzero(ios == -1)[: fresh.size]
            fresh = fresh[: free.size]          # never evict during warmup
            self.slot_of_id[t, fresh] = free
            ios[free] = fresh
            self.last_used_t(t)[free] = self.tick
            plan_t.append(np.full(fresh.size, t, np.int32))
            plan_r.append(fresh.astype(np.int64))
            plan_s.append(free.astype(np.int64))
        # Pre-advance the tick: warmup residents must be stamped STRICTLY
        # earlier than the first real batch's LRU touches.  Stamping both
        # at the same tick made them tie, so eviction could not prefer a
        # warmup-admitted-but-never-used row over one the serving traffic
        # actually touched (argpartition then picked by slot order).
        self.tick += 1
        cat = lambda xs, dt: (np.concatenate(xs) if xs
                              else np.zeros((0,), dt))
        fetch_rows = cat(plan_r, np.int64)
        return PrefetchPlan(
            remapped=np.zeros((self.T, 0, 0), np.int32),
            fetch_tables=cat(plan_t, np.int32),
            fetch_rows=fetch_rows,
            fetch_slots=cat(plan_s, np.int64),
            fetch_owner=self._owner(fetch_rows),
            home=self.home,
        )

    def _pick_victims(self, t: int, need: int,
                      pinned_slots: np.ndarray) -> np.ndarray:
        """``need`` occupied slots to reclaim (TABLE-LOCAL slot ids),
        never one pinned by the current batch."""
        occ = self.id_of_slot_t(t)
        if self.policy == "lfu":
            # score each slot by its row's persistent frequency counter
            scores = self.freq[t, np.clip(occ, 0, self.R - 1)].astype(
                np.float64)
        else:
            scores = self.last_used_t(t).astype(np.float64)
        scores[occ < 0] = np.inf                  # free slots aren't victims
        scores[pinned_slots] = np.inf             # the evict backlist
        victims = np.argpartition(scores, need - 1)[:need]
        if not np.isfinite(scores[victims]).all():
            raise RuntimeError(
                f"table {t}: cannot evict {need} rows — the current batch"
                f" pins the whole pool")
        return victims

    def invalidate_fetch(self, plan: PrefetchPlan) -> None:
        """Undo the residency of ``plan``'s fetched rows — called by the
        bag when the host->device payload copy fails after prepare()
        committed the metadata, so no slot ever claims an uncopied row.
        (Evictions stand — the victims really are gone from the pool.)"""
        self.slot_of_id[plan.fetch_tables, plan.fetch_rows] = -1
        self.id_of_slot[plan.flat_addr(self.slot_offsets)] = -1

    def resident_ids(self, t: int) -> np.ndarray:
        """Sorted row ids currently resident for table ``t`` (test hook)."""
        occ = self.id_of_slot_t(t)
        return np.sort(occ[occ >= 0])
