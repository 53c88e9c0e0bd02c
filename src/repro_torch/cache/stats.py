"""Cache observability: the ``CacheStats`` record.

A numpy-only copy of ``repro.cache.stats``, so that the port imports
nothing of the reference package and its counters match the reference's
exactly on the same traffic.

Counting semantics (matched by the numpy simulation in tests/test_cache.py):

  * one *lookup* = one valid (within-``lengths``) slot of the padded
    ``(T, B, L)`` index tensor — zero-weight lookups still gather a row,
    so they count;
  * a lookup HITS when its row is resident in the HBM slot pool at
    ``prefetch`` time, before this batch's admissions, and MISSES
    otherwise — every occurrence of a non-resident id in the batch counts
    as a miss (the row is then admitted, so the *next* batch hits);
  * misses split by the COLD TIER that serves the row: ``misses_host``
    when the serving host owns it (fetched over the host<->device link),
    ``misses_remote`` when a peer host does (fetched over the network via
    ``comm.fetch_rows``) — with a local-host cold tier everything is
    ``misses_host``;
  * ``evictions`` counts slot reassignments (one per victim row);
  * ``bytes_h2d`` counts host->device row payload moved for LOCALLY-owned
    fetched rows (``host-tier rows * dim * itemsize``) — the PCIe/host-link
    traffic the perf model charges to ``host_Bps``;
  * ``bytes_remote`` counts the network payload of REMOTELY-owned fetched
    rows (disjoint from ``bytes_h2d``; in a real deployment those rows
    additionally cross the requester's host link on arrival — the perf
    model's ``tiered_phase_times`` charges both, the stats keep the tiers
    disjoint so traffic attributes to one source);
  * ``fetch_host`` / ``fetch_remote`` count the unique rows each cold
    tier actually moved (warmup admission counts here too, with zero
    hits/misses — it happens before any lookup);
  * ``hits_t`` / ``misses_t`` / ``evictions_t`` split the totals PER
    TABLE — ``(T,)`` int64, lazily allocated on the first per-table
    update.  Embedding tables are wildly heterogeneous (the paper's §5
    sweeps), and the planner prices a distinct ``cache_rows``/
    ``est_hit_rate`` per table, so the measured hit rate must be
    checkable at the same granularity (``hit_rate_t``) — that is the
    planner -> engine round trip's feedback signal.

Stage timers (shared with the pipelined serving engine): the SAME spans are
recorded whichever engine serves, so the serialized and pipelined paths
are directly comparable from ``DLRMEngine.cache_stats()``:

  * ``prefetch_s`` — wall-clock of the host-side admission metadata
    (``SlotPoolManager.prepare``) plus the cold-tier row fetch;
  * ``scatter_s``  — wall-clock of dispatching the flat pool scatter
    (async dispatch: the device may still be writing when it returns);
  * ``forward_s``  — forward dispatch until the scores are materialized
    on the host;
  * ``overlap_s``  — prefetch-side wall-clock that ran CONCURRENTLY with
    an in-flight forward (always 0 for the serialized engine; the
    pipeline scheduler measures it from its stage spans).  The
    ``overlap_fraction`` property is the share of prefetch time the
    pipeline actually hid under compute — observable, not assumed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class CounterDelta:
    """Hit/miss counter movement between two :meth:`CacheStats.counter_state`
    snapshots — one serving window's cache traffic (the windowed
    hit-rate instruments' feed)."""

    hits: int
    misses: int
    hits_t: Optional[np.ndarray]
    misses_t: Optional[np.ndarray]

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def lookups_t(self) -> Optional[np.ndarray]:
        if self.hits_t is None:
            return None
        return self.hits_t + self.misses_t


@dataclasses.dataclass
class CacheStats:
    """Running counters for one :class:`CachedEmbeddingBag`."""

    hits: int = 0
    misses: int = 0
    misses_host: int = 0
    misses_remote: int = 0
    evictions: int = 0
    bytes_h2d: int = 0
    bytes_remote: int = 0
    fetch_host: int = 0
    fetch_remote: int = 0
    batches: int = 0
    # per-table splits — (T,) int64, None until the first per-table update
    hits_t: Optional[np.ndarray] = None
    misses_t: Optional[np.ndarray] = None
    evictions_t: Optional[np.ndarray] = None
    # per-stage wall-clock spans (seconds) — see module docstring
    prefetch_s: float = 0.0
    scatter_s: float = 0.0
    forward_s: float = 0.0
    overlap_s: float = 0.0

    STAGES = ("prefetch", "scatter", "forward", "overlap")
    # bump when as_dict() keys change meaning or spelling — benchmark
    # CSVs and the plan-roundtrip assertions key off this contract.
    # v3: always-present "lookups" / "lookups_t" keys
    SCHEMA_VERSION = 3

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return self.hits / n if n else 0.0

    @property
    def overlap_fraction(self) -> float:
        """Share of prefetch wall-clock that ran under an in-flight
        forward (0 for the serialized engine — nothing overlaps)."""
        return min(1.0, self.overlap_s / self.prefetch_s) \
            if self.prefetch_s > 0 else 0.0

    def add_time(self, stage: str, seconds: float) -> None:
        """Accumulate ``seconds`` of wall-clock into a stage timer."""
        if stage not in self.STAGES:
            raise ValueError(
                f"unknown stage {stage!r}; pick one of {self.STAGES}")
        setattr(self, stage + "_s", getattr(self, stage + "_s") + seconds)

    @property
    def remote_miss_fraction(self) -> float:
        """Share of misses the REMOTE tier served (0 with a local cold tier)."""
        return self.misses_remote / self.misses if self.misses else 0.0

    @property
    def lookups_t(self) -> Optional[np.ndarray]:
        """(T,) per-table lookup counts (None before any per-table update)."""
        if self.hits_t is None:
            return None
        return self.hits_t + self.misses_t

    @property
    def hit_rate_t(self) -> Optional[np.ndarray]:
        """(T,) per-table hit rates — the measured side of the planner
        round trip, compared against each ``Placement.est_hit_rate``
        (0.0 for a table that saw no lookups)."""
        n = self.lookups_t
        if n is None:
            return None
        return np.where(n > 0, self.hits_t / np.maximum(n, 1), 0.0)

    def _acc_t(self, field: str, values) -> None:
        values = np.asarray(values, np.int64)
        cur = getattr(self, field)
        if cur is None:
            setattr(self, field, values.copy())
        elif cur.shape != values.shape:
            raise ValueError(
                f"per-table {field} shape {values.shape} does not match "
                f"the accumulated shape {cur.shape}")
        else:
            cur += values

    def update(self, *, hits: int, misses: int, evictions: int,
               bytes_h2d: int, misses_host: Optional[int] = None,
               misses_remote: int = 0, bytes_remote: int = 0,
               fetch_host: int = 0, fetch_remote: int = 0,
               hits_t=None, misses_t=None, evictions_t=None,
               count_batch: bool = True) -> None:
        self.hits += int(hits)
        self.misses += int(misses)
        # default: an un-split update attributes every miss to the host tier
        self.misses_host += int(misses - misses_remote
                                if misses_host is None else misses_host)
        self.misses_remote += int(misses_remote)
        self.evictions += int(evictions)
        self.bytes_h2d += int(bytes_h2d)
        self.bytes_remote += int(bytes_remote)
        self.fetch_host += int(fetch_host)
        self.fetch_remote += int(fetch_remote)
        for field, values in (("hits_t", hits_t), ("misses_t", misses_t),
                              ("evictions_t", evictions_t)):
            if values is not None:
                self._acc_t(field, values)
        if count_batch:
            self.batches += 1

    def counter_state(self):
        """Opaque snapshot of the hit/miss counters (totals + per-table)
        for :meth:`delta_since` — the windowed-metrics pattern is
        ``state = stats.counter_state()`` at a window boundary, then
        ``stats.delta_since(state)`` at the next."""
        return (self.hits, self.misses,
                None if self.hits_t is None else self.hits_t.copy(),
                None if self.misses_t is None else self.misses_t.copy())

    def delta_since(self, state) -> CounterDelta:
        """Counter movement since a :meth:`counter_state` snapshot.

        Per-table deltas are None until the first per-table update; a
        snapshot taken before that first update deltas against zeros."""
        h0, m0, ht0, mt0 = state
        hits_t = misses_t = None
        if self.hits_t is not None:
            hits_t = self.hits_t - (0 if ht0 is None else ht0)
            misses_t = self.misses_t - (0 if mt0 is None else mt0)
        return CounterDelta(self.hits - h0, self.misses - m0,
                            hits_t, misses_t)

    def reset(self) -> None:
        self.hits = self.misses = self.misses_host = self.misses_remote = 0
        self.evictions = self.bytes_h2d = self.bytes_remote = 0
        self.fetch_host = self.fetch_remote = self.batches = 0
        self.hits_t = self.misses_t = self.evictions_t = None
        self.prefetch_s = self.scatter_s = 0.0
        self.forward_s = self.overlap_s = 0.0

    def as_dict(self) -> Dict[str, float]:
        """Stable serialization schema (``SCHEMA_VERSION``).

        Every key below is ALWAYS present: scalar counters as ints
        (including the derived ``lookups = hits + misses``), rates as
        floats, per-table ``*_t`` splits (``lookups_t`` included) as
        plain Python lists (length T) or None before any per-table
        update, stage timers as float seconds.  Benchmark CSV writers,
        the plan-roundtrip sweep, and obs metrics producers consume this
        dict verbatim — never rename a key without bumping
        ``schema_version``."""
        return {
            "schema_version": self.SCHEMA_VERSION,
            "hits": self.hits,
            "misses": self.misses,
            "misses_host": self.misses_host,
            "misses_remote": self.misses_remote,
            "evictions": self.evictions,
            "bytes_h2d": self.bytes_h2d,
            "bytes_remote": self.bytes_remote,
            "fetch_host": self.fetch_host,
            "fetch_remote": self.fetch_remote,
            "batches": self.batches,
            "lookups": self.lookups,
            "hit_rate": self.hit_rate,
            "remote_miss_fraction": self.remote_miss_fraction,
            "hits_t": (None if self.hits_t is None
                       else self.hits_t.tolist()),
            "misses_t": (None if self.misses_t is None
                         else self.misses_t.tolist()),
            "evictions_t": (None if self.evictions_t is None
                            else self.evictions_t.tolist()),
            "lookups_t": (None if self.hits_t is None
                          else self.lookups_t.tolist()),
            "hit_rate_t": (None if self.hits_t is None
                           else [round(float(r), 4)
                                 for r in self.hit_rate_t]),
            "prefetch_s": self.prefetch_s,
            "scatter_s": self.scatter_s,
            "forward_s": self.forward_s,
            "overlap_s": self.overlap_s,
            "overlap_fraction": self.overlap_fraction,
        }

    def __str__(self) -> str:
        return (f"CacheStats(hits={self.hits}, misses={self.misses} "
                f"[host={self.misses_host} remote={self.misses_remote}], "
                f"hit_rate={self.hit_rate:.4f}, evictions={self.evictions}, "
                f"bytes_h2d={self.bytes_h2d}, "
                f"bytes_remote={self.bytes_remote}, batches={self.batches}, "
                f"prefetch_s={self.prefetch_s:.4f}, "
                f"scatter_s={self.scatter_s:.4f}, "
                f"forward_s={self.forward_s:.4f}, "
                f"overlap={self.overlap_fraction:.2f})")
