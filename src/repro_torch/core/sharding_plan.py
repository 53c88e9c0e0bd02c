"""Cost-model-driven sharding planner for embedding tables.

The counterpart of ``repro.core.sharding_plan`` (numpy only, through
``core/perf_model.py``): the same strategies, the same greedy pass and
the same prices, so the same inputs give field-for-field the same plan.
One stated difference: ``plan(..., hw=)`` defaults to ``H100_DGX``,
where the reference defaults to its TPU platform, which the port does
not carry.

The paper fixes row-wise parallelism (§4.2) and notes TW/CW as the
alternatives (§4.1). This planner generalizes: given a set of tables and a
mesh, pick per-table strategies minimizing the modeled step time under the
per-device HBM capacity constraint — a small, deterministic analogue of
AutoShard/DreamShard (paper refs [4, 5]).

Strategies considered per table:
  * TW — place the whole table on one shard (zero lookup comm in our 2-D
    mesh since indices are model-axis replicated; output all-gather only).
    Requires table_bytes <= capacity budget of a shard.
  * RW — split rows across all shards (paper's scheme): pays index permute
    + reduce-scatter, balances memory perfectly.
  * CW — split columns: local gather of D/E slice, output all-gather;
    balances memory, multiplies per-row DMA descriptors by E (bad for
    small dims — the planner penalizes dim/E < 32 lanes).
  * CACHED — RecShard-style joint placement/statistics decision: spend
    leftover HBM budget on a slot pool (repro_torch/cache/) serving the
    table's zipf-hot rows, with the cold rows host- or cluster-resident
    behind the tiered fetch.  Priced by ``perf_model.zipf_hit_rate``
    (access statistics) x ``perf_model.tiered_phase_times`` (remote-miss
    aware serving cost); only considered when the caller supplies the
    traffic skew (``zipf_a``), since a cache without skew is just a
    smaller table.

Greedy assignment: sort tables by bytes descending; per table pick the
cheapest strategy that fits — TW-pack into the least-loaded shard while
it fits the per-shard budget, CACHED charges only its pool bytes to the
serving shard, RW the rest (CW only when the caller forces it — it
exists for completeness and for the benchmark sweeps, matching the
paper's taxonomy).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.perf_model import (
    H100_DGX,
    EmbeddingWorkload,
    Hardware,
    collective_time,
    tiered_embedding_bag_time,
    zipf_hit_rate,
)

# pool-size candidates as a fraction of the table's rows — the planner
# prices each and keeps the cheapest that fits the leftover HBM budget
CACHE_RATIOS = (0.005, 0.01, 0.02, 0.05, 0.10, 0.20)


@dataclasses.dataclass(frozen=True)
class TableSpec:
    name: str
    rows: int
    dim: int
    pooling: int
    dtype_bytes: int = 4

    @property
    def bytes(self) -> int:
        return self.rows * self.dim * self.dtype_bytes


@dataclasses.dataclass
class Placement:
    table: TableSpec
    strategy: str          # "table" | "row" | "column" | "cached"
    shard: int             # owning shard for TW/CACHED, -1 otherwise
    est_time_s: float
    cache_rows: int = 0    # slot-pool rows per table ("cached" only)
    est_hit_rate: float = 0.0
    # position of ``table`` in the sequence given to plan() — the stable
    # identity used by the engine round trip (names may be duplicated:
    # every benchmark sweep builds T same-named specs)
    index: int = -1


@dataclasses.dataclass
class ShardingPlan:
    placements: List[Placement]
    per_shard_bytes: List[int]

    def _by_name(self, name: str) -> Placement:
        matches = [p for p in self.placements if p.table.name == name]
        if not matches:
            raise KeyError(name)
        if len(matches) > 1:
            # never guess between duplicate-named specs: the old
            # first-match lookup silently aliased every duplicate to one
            # placement — address by position instead
            raise KeyError(
                f"ambiguous table name {name!r}: {len(matches)} placements"
                f" share it — look up by position (placement_at /"
                f" cache_rows_vector)")
        return matches[0]

    def strategy_of(self, name: str) -> str:
        return self._by_name(name).strategy

    def cache_rows_of(self, name: str) -> int:
        return self._by_name(name).cache_rows

    def placement_at(self, index: int) -> Placement:
        """The placement of the ``index``-th table passed to plan()."""
        for p in self.placements:
            if p.index == index:
                return p
        raise KeyError(f"no placement for table index {index}")

    def cache_rows_vector(self, num_tables: int, *,
                          default: int = 0) -> List[int]:
        """Per-table slot counts in INPUT order — the engine's ``S_t``.

        Tables the planner placed "cached" contribute their priced
        ``cache_rows``; every other strategy gets ``default`` (the
        engine's uniform fallback).  Raises if the plan does not cover
        exactly tables ``0..num_tables-1``.
        """
        out = [None] * num_tables
        for p in self.placements:
            if not 0 <= p.index < num_tables:
                raise ValueError(
                    f"placement index {p.index} outside the engine's"
                    f" {num_tables} tables — the plan was built for a"
                    f" different table set")
            if out[p.index] is not None:
                raise ValueError(
                    f"duplicate placement for table index {p.index}")
            out[p.index] = p.cache_rows if p.strategy == "cached" \
                and p.cache_rows > 0 else default
        missing = [i for i, v in enumerate(out) if v is None]
        if missing:
            raise ValueError(
                f"plan has no placement for table indices {missing}")
        return out


def _tw_time(t: TableSpec, batch: int, n: int, hw: Hardware) -> float:
    gather = batch * t.pooling * t.dim * t.dtype_bytes / hw.hbm_Bps
    out = batch * t.dim * t.dtype_bytes
    return gather + collective_time("all_gather", out, n, hw.bulk)


def _rw_time(t: TableSpec, batch: int, n: int, hw: Hardware) -> float:
    idx = batch * t.pooling * 4
    gather = batch * t.pooling * t.dim * t.dtype_bytes / (n * hw.hbm_Bps)
    out = batch * t.dim * t.dtype_bytes
    return (
        collective_time("all_to_all", idx / n, n, hw.bulk)
        + gather
        + collective_time("reduce_scatter", out, n, hw.bulk)
    )


def _cached_candidate(
    t: TableSpec, batch: int, hw: Hardware, *, zipf_a: float,
    budget_left: float, hosts: int, onesided: bool,
) -> Optional[Tuple[float, int, float]]:
    """Cheapest (time, cache_rows, hit_rate) pool that fits ``budget_left``.

    The cold rows live OFF the HBM budget (host RAM of ``hosts`` hosts);
    only the slot pool is charged to the serving shard.  Returns None
    when no candidate pool fits.
    """
    w = EmbeddingWorkload(num_tables=1, batch_per_device=batch,
                          pooling=t.pooling, dim=t.dim,
                          dtype_bytes=t.dtype_bytes)
    best = None
    for ratio in CACHE_RATIOS:
        cache_rows = max(1, int(t.rows * ratio))
        pool_bytes = cache_rows * t.dim * t.dtype_bytes
        if pool_bytes > budget_left:
            continue
        hr = zipf_hit_rate(zipf_a, t.rows, cache_rows)
        # zipf_a/rows/cache_rows switch the miss pricing to expected
        # UNIQUE missed rows per batch — what the bag actually fetches
        # (CacheStats.fetch_host/fetch_remote), so the planner's prices
        # are checkable against measured serving stats
        time = tiered_embedding_bag_time(
            w, hw, hit_rate=hr, hosts=hosts, onesided=onesided,
            zipf_a=zipf_a, rows=t.rows, cache_rows=cache_rows)
        if best is None or time < best[0]:
            best = (time, cache_rows, hr)
    return best


def plan(
    tables: Sequence[TableSpec],
    *,
    num_shards: int,
    batch_per_shard: int,
    hbm_budget_bytes: float,
    hw: Hardware = H100_DGX,
    zipf_a: Optional[float] = None,
    cache_hosts: int = 1,
    cache_backend: str = "bulk",
) -> ShardingPlan:
    """Greedy cheapest-fit planner (see module docstring).

    ``zipf_a`` enables the fourth "cached" strategy: the caller's
    measured (or assumed) traffic skew, which prices a slot pool of
    ``cache_rows`` via the closed-form steady-state hit rate.
    ``cache_hosts``/``cache_backend`` describe where a cached table's
    cold rows live — 1: the serving host's RAM; >1: row-split over that
    many hosts with misses fetched by ``comm.fetch_rows`` over the named
    transport ("bulk" | "onesided").
    """
    loads = [0] * num_shards
    placements: List[Placement] = []
    for idx, t in sorted(enumerate(tables), key=lambda it: -it[1].bytes):
        tw = _tw_time(t, batch_per_shard, num_shards, hw)
        rw = _rw_time(t, batch_per_shard, num_shards, hw)
        target = min(range(num_shards), key=lambda s: loads[s])
        fits_tw = loads[target] + t.bytes <= hbm_budget_bytes
        cached = None
        if zipf_a is not None:
            cached = _cached_candidate(
                t, batch_per_shard, hw, zipf_a=zipf_a,
                budget_left=hbm_budget_bytes - loads[target],
                hosts=cache_hosts, onesided=cache_backend == "onesided")
        if cached is not None and cached[0] < rw \
                and (not fits_tw or cached[0] < tw):
            time, cache_rows, hr = cached
            loads[target] += cache_rows * t.dim * t.dtype_bytes
            placements.append(Placement(t, "cached", target, time,
                                        cache_rows=cache_rows,
                                        est_hit_rate=hr, index=idx))
        elif fits_tw and tw <= rw:
            loads[target] += t.bytes
            placements.append(Placement(t, "table", target, tw, index=idx))
        else:
            # ceil over ROWS (the split unit), not a floor over bytes: a
            # floor-divided remainder would vanish from the accounting and
            # let the HBM-budget check overcommit — the real RW split
            # gives the heaviest shards ceil(rows/E) whole rows
            per = -(-t.rows // num_shards) * t.dim * t.dtype_bytes
            for s in range(num_shards):
                loads[s] += per
            placements.append(Placement(t, "row", -1, rw, index=idx))
    return ShardingPlan(placements, loads)
