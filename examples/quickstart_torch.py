"""Quickstart: the paper's distributed Embedding Bag on the port, with each
rank a process.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --ranks 4

The counterpart of ``examples/quickstart.py``.  Builds a row-wise-sharded
embedding bag on a (1, N) mesh -- N ranks, one process each
(``launch/mesh.run_model_mesh``; by default one rank per card, over NCCL;
gloo on the CPU or on one card the ranks share) -- runs the paper's
three-phase pipeline (index permute -> gather/pool -> reduce-scatter) and
verifies it against the local oracle on rank 0.  Each rank draws the
tables from the same seed and keeps only its rows; rank 0 also keeps the
whole tables for the oracle.  With one rank no process is spawned: the
pipeline runs over one shard in this process.
"""
import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.embedding_bag import (
    EmbeddingBagConfig,
    init_tables,
    pooled_lookup_local,
    pooled_lookup_sharded,
    shard_for_rank,
    shard_tables,
)
from repro_torch.core.jagged import random_jagged_batch
from repro_torch.launch.mesh import rank_count, run_model_mesh
from repro_torch.utils.device import resolve_device

CFG = EmbeddingBagConfig(
    num_tables=8,             # 8 sparse features
    rows_per_table=1 << 16,   # 65k rows each
    dim=128,                  # paper fixes dim=128
    sharding="row",           # the paper's RW parallelism
    rw_impl="a2a",            # paper-faithful 3-phase pipeline
    capacity_factor=4.0,
)


def quickstart(ctx=None, tables=None, device=None) -> dict:
    """One rank of the (1, N) mesh (``ctx`` a ``ProcessContext``), or the
    whole pipeline over one shard (``ctx`` None, on ``device``).
    ``tables``: the (T, R, D) tables to use in place of the seeded draw
    (on any device).  Returns, on rank 0, ``{"pooled": (B, T, D) on the
    CPU, "err": max |distributed - local oracle|}``; None on the others."""
    dev = resolve_device(device) if ctx is None else ctx.device
    n = 1 if ctx is None else ctx.world
    lead = ctx is None or ctx.rank == 0
    cfg = CFG
    if lead:
        where = "1 device" if ctx is None else \
            f"{n} ranks, one process each ({dist.get_backend()}, {dev.type})"
        print(f"mesh: {where} on axis 'model'")
    if tables is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        tables = init_tables(gen, cfg, device=dev)
    else:
        tables = tables.to(dev)
    shards = shard_tables(tables, cfg, 1) if ctx is None else \
        shard_for_rank(tables, cfg, ctx)
    if lead:
        print(f"tables: {tuple(tables.shape)} = "
              f"{tables.numel() * 4 / 2**20:.0f} MiB, row-sharded {n}-way")
    else:
        del tables                 # this rank keeps only its rows

    rng = np.random.default_rng(0)
    batch = random_jagged_batch(
        rng, cfg.num_tables, batch_size=64, pooling=16,
        num_rows=cfg.rows_per_table, device=dev)

    pooled = pooled_lookup_sharded(shards, batch, cfg)
    if not lead:
        return None
    print(f"pooled output: {tuple(pooled.shape)}  (batch, tables, dim)")
    ref = pooled_lookup_local(tables, batch, cfg)
    err = float((pooled - ref).abs().max())
    print(f"max |distributed - local oracle| = {err:.2e}")
    assert err < 1e-4
    print("OK: the distributed pipeline reproduces the local pooling.")
    return {"pooled": pooled.cpu(), "err": err}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card; with "
                         "--ranks, the device every rank shares)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes of the (1, ranks) mesh (default: the "
                         "cards without --device, else 1)")
    return ap


def main(argv=None, tables=None) -> dict:
    args = parser().parse_args(argv)
    n = rank_count(args.ranks, args.device)
    if n == 1:
        return quickstart(None, tables, args.device)
    return run_model_mesh(quickstart, n, args.device, args=(tables,))


if __name__ == "__main__":
    main()
