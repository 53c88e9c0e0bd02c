"""Cost-model-driven sharding plan for a heterogeneous DLRM table set, on
the port's H100 model.

    PYTHONPATH=src python examples/dlrm_sharding_plan_torch.py

The counterpart of ``examples/dlrm_sharding_plan.py``.  The paper fixes
row-wise parallelism and equal table sizes (§4.3); real Criteo-scale
models mix 10-row enum tables with 100M-row id tables.  The planner
(``core/sharding_plan.py``, a small deterministic AutoShard) packs small
tables table-wise onto the least-loaded shard and row-splits the giants,
minimizing modeled step time under the per-card memory budget.  Here it
prices an H100 system (``perf_model.H100_DGX``) where the reference
prices a TPU v5e: half the card's 80 GB for embeddings, and the shard
count by the paper's sizing rule.  The times printed are the model's,
not measurements.  The script runs no kernel and needs no card.
"""
import argparse
import math

import numpy as np

from repro_torch.core.perf_model import H100_DGX
from repro_torch.core.sharding_plan import TableSpec, plan

BATCHES = (1024, 32)


def criteo_like_tables(seed=0):
    """26 sparse features with a realistic (log-uniform) size spread."""
    rng = np.random.default_rng(seed)
    rows = np.unique(np.concatenate([
        10 ** rng.uniform(1, 8, size=22),       # enums .. big id spaces
        [4e7, 1e8, 2e8, 3e8],                   # the Criteo giants
    ]).astype(np.int64))[:26]
    return [TableSpec(f"sparse_{i:02d}", rows=int(r), dim=128, pooling=32)
            for i, r in enumerate(sorted(rows, key=int))]


def shard_count(total_bytes: float, budget: float) -> int:
    """The paper's sizing rule (§5.2): table bytes over the per-device
    budget, rounded up to a power of two."""
    return 1 << math.ceil(math.log2(total_bytes / budget))


def plans(tables=None, hw=H100_DGX, budget=None) -> dict:
    """``{"tables", "total", "shards", "budget", "plans": {batch per
    shard: ShardingPlan}}`` for ``tables`` (default the Criteo-like set)
    on ``hw``, with ``budget`` bytes a shard (default half the device's
    memory) and the shard count of :func:`shard_count`."""
    tables = criteo_like_tables() if tables is None else tables
    total = sum(t.bytes for t in tables)
    budget = hw.hbm_capacity_B / 2 if budget is None else budget
    shards = shard_count(total, budget)
    return {"tables": tables, "total": total, "shards": shards,
            "budget": budget,
            "plans": {b: plan(tables, num_shards=shards, batch_per_shard=b,
                              hbm_budget_bytes=budget, hw=hw)
                      for b in BATCHES}}


def main(argv=None) -> dict:
    """Plans the Criteo-like set on the H100 model; returns :func:`plans`'."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    out = plans()
    tables, total, shards, budget = (out["tables"], out["total"],
                                     out["shards"], out["budget"])
    print(f"{len(tables)} tables, {total/1e9:.1f} GB total, "
          f"{shards} shards, {budget/1e9:.0f} GB/shard embedding budget "
          f"({H100_DGX.name}, {H100_DGX.hbm_capacity_B/1e9:.0f} GB a "
          f"device)\n")
    n_tw = {}
    for batch, p in out["plans"].items():
        n_tw[batch] = sum(1 for x in p.placements if x.strategy == "table")
        n_rw = sum(1 for x in p.placements if x.strategy == "row")
        print(f"batch/shard={batch}: {n_tw[batch]} table-wise, {n_rw} "
              f"row-wise; max shard {max(p.per_shard_bytes)/1e9:.2f} GB")
        for x in sorted(p.placements, key=lambda x: -x.table.bytes)[:4]:
            print(f"    {x.table.name}: {x.table.rows:>12,} rows "
                  f"({x.table.bytes/1e9:6.2f} GB) -> {x.strategy:5s} "
                  f"({H100_DGX.name} model {x.est_time_s*1e6:7.1f} us)")
        assert max(p.per_shard_bytes) <= budget * 1.25
        print()
    over = [t.name for t in tables if t.bytes > budget]
    split = all(x.strategy == "row" for p in out["plans"].values()
                for x in p.placements if x.table.name in over)
    big, small = BATCHES
    if n_tw[small] > n_tw[big]:
        trend = (f"at batch/shard {small} the collective latency floor "
                 f"makes table-wise placement win for more small tables "
                 f"({n_tw[small]} against {n_tw[big]} at {big})")
    else:
        trend = (f"the {H100_DGX.name} model places {n_tw[small]} tables "
                 f"table-wise at batch/shard {small} and {n_tw[big]} at "
                 f"{big}: no more at small batch")
    print(f"OK: the {len(over)} tables over a shard's budget are "
          f"{'always' if split else 'not always'} row-split; {trend}.")
    return out


if __name__ == "__main__":
    main()
