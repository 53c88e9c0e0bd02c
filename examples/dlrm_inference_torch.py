"""End-to-end DLRM inference on the port -- the paper's model (Fig. 2)
with the distributed Embedding Bag under every sharding strategy, each
rank a process, AND the tiered embedding store serving path.

    PYTHONPATH=src python examples/dlrm_inference_torch.py --ranks 4
    PYTHONPATH=src python examples/dlrm_inference_torch.py --device cpu \\
        --ranks 4

The counterpart of ``examples/dlrm_inference.py``.  On one device: serves
batched CTR requests through ``DLRMEngine`` with the tiered cache
configured ENTIRELY through ``DLRMConfig.cache`` (one ``CacheConfig``
carrying rows / policy / cold_tier / warmup_freqs) -- the engine's device
memory holds only the flat slot pool, the cold tables stay on the host --
and cross-checks the scores against the uncached direct forward.

With more than one rank (``--ranks N``; by default one per card) it also
runs every distributed sharding strategy (RW both impls / CW / TW) on a
(1, N) mesh of processes (``launch/mesh.run_model_mesh``: NCCL with a
card a rank, gloo on the CPU or on one card the ranks share), checks
each against the local oracle, and reports the collective traffic each
one issues (the paper's phase structure), as one rank's payload bytes
summed by collective, and the first and a second forward's time on rank
0.  Each rank is sent the parameters once and copies its own shard.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cache_config import CacheConfig
from repro_torch.configs import dlrm as dlrm_cfg
from repro_torch.core import comm
from repro_torch.core import embedding_bag as eb
from repro_torch.core.jagged import JaggedBatch, random_jagged_batch
from repro_torch.launch.mesh import rank_count, run_model_mesh
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.serving.engine import CTRRequest, DLRMEngine
from repro_torch.utils.device import resolve_device

B = 32
STRATEGIES = (("row", "allgather"), ("row", "a2a"), ("column", None),
              ("table", None))


def base_config() -> dlrm_cfg.DLRMConfig:
    return dataclasses.replace(
        dlrm_cfg.smoke(), num_sparse_features=8, rows_per_table=4096,
        embedding_dim=64, pooling=16, bottom_mlp=(128, 64))


def serve_tiered(base, params, rng, device) -> dict:
    """DLRMEngine over the tiered store, configured via DLRMConfig only.
    Returns ``{"scores": {rid: score}, "err": max |err| vs the uncached
    forward, "stats": CacheStats}``."""
    T, L, F = (base.num_sparse_features, base.pooling,
               base.num_dense_features)
    # logged frequencies (the offline ids_freq_mapping): zipf-ish skew
    freqs = (1.0 / np.arange(1, base.rows_per_table + 1)) * 1e4
    cfg = dataclasses.replace(
        base,
        cache=CacheConfig(
            rows=max(base.pooling, base.rows_per_table // 8),
            policy="lfu",
            cold_tier="host",        # "remote" once >1 hosts back the store
            warmup_freqs=freqs,      # skip the cold-start miss burst
        ),
    )
    engine = DLRMEngine(params, cfg, batch_size=8, device=device)
    assert engine.params["tables"] is None, \
        "device memory must hold only the pool"

    reqs = []
    for rid in range(24):
        ranks = rng.zipf(1.2, size=(T, L))
        reqs.append(CTRRequest(
            rid=rid,
            dense=rng.standard_normal(F).astype(np.float32),
            indices=np.minimum(ranks - 1,
                               base.rows_per_table - 1).astype(np.int32),
            lengths=rng.integers(1, L + 1, T).astype(np.int32)))
        engine.submit(reqs[-1])
    scores = engine.run_to_completion()

    worst = 0.0
    for r in reqs:
        batch = JaggedBatch(
            torch.as_tensor(r.indices[:, None, :], device=device),
            torch.as_tensor(r.lengths[:, None], device=device))
        want = float(torch.sigmoid(dlrm_mod.forward(
            params, torch.as_tensor(r.dense[None], device=device), batch,
            base))[0])
        worst = max(worst, abs(scores[r.rid] - want))
    stats = engine.cache_stats()
    print(f"tiered engine: {len(reqs)} reqs scored, max |err| vs uncached "
          f"forward = {worst:.2e}")
    print(f"tiered engine: {stats}")
    assert worst < 1e-5
    # warmup pre-admitted the logged-hot head: the FIRST flush already hits
    assert stats.hits > 0 and stats.hit_rate > 0.5, str(stats)
    return {"scores": scores, "err": worst, "stats": stats}


def params_to(params, device) -> dict:
    """The DLRM parameters ``{"tables", "bottom", "top"}`` on ``device``."""
    def mlp(layers):
        return [{k: v.to(device) for k, v in layer.items()}
                for layer in layers]
    return {"tables": params["tables"].to(device),
            "bottom": mlp(params["bottom"]), "top": mlp(params["top"])}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def strategies(ctx, base, params, dense, batch, ref) -> list:
    """One rank of the (1, N) mesh: every sharding strategy's forward
    over this rank's shard, under ``comm.instrument()`` (its events are
    this thread's, so they are collected here, in the rank).  Rank 0
    prints and returns ``[{"label", "logits" (B,) on the CPU, "err",
    "traffic": {op: bytes_in summed}, "first_ms", "second_ms"}, ...]``;
    the others return None."""
    dev = ctx.device
    params = params_to(params, dev)
    dense, ref = dense.to(dev), ref.to(dev)
    batch = JaggedBatch(batch.indices.to(dev), batch.lengths.to(dev))
    if ctx.rank == 0:
        print(f"strategies on a (1, {ctx.world}) mesh of processes "
              f"({dist.get_backend()}, {dev.type})")
    rows = []
    for sharding, impl in STRATEGIES:
        cfg = dataclasses.replace(base, sharding=sharding,
                                  rw_impl=impl or "allgather")
        mine = dict(params, tables=eb.shard_for_rank(
            params["tables"], cfg.embedding_config(), ctx))
        with comm.instrument() as events:
            _sync(dev)
            t0 = time.perf_counter()
            out = dlrm_mod.forward(mine, dense, batch, cfg, ctx)
            _sync(dev)
            t1 = time.perf_counter()
        dlrm_mod.forward(mine, dense, batch, cfg, ctx)
        _sync(dev)
        t2 = time.perf_counter()
        err = float((out - ref).abs().max())
        traffic = {}
        for e in events:
            traffic[e.op] = traffic.get(e.op, 0) + e.bytes_in
        label = sharding + (f"/{impl}" if impl else "")
        rows.append(dict(label=label, logits=out.cpu(), err=err,
                         traffic=traffic, first_ms=1e3 * (t1 - t0),
                         second_ms=1e3 * (t2 - t1)))
        if ctx.rank == 0:
            print(f"{sharding:7s}{('/' + impl) if impl else '':11s} "
                  f"err={err:.1e}  traffic={traffic}  (first forward "
                  f"{1e3 * (t1 - t0):.1f} ms, second "
                  f"{1e3 * (t2 - t1):.1f} ms on {dev.type})")
    return rows if ctx.rank == 0 else None


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card; with "
                         "--ranks, the device every rank shares)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes of the (1, ranks) mesh (default: the "
                         "cards without --device, else 1)")
    return ap


def local(device, params=None) -> dict:
    """The one-device part on ``device``: the seeded inputs, the oracle,
    the tiered engine.  ``params``: DLRM parameters (any device) in place
    of the seeded draw.  Returns ``{"base", "params", "dense", "batch",
    "ref" (the oracle's (B,) logits), "tiered" (serve_tiered's)}``."""
    dev = resolve_device(device)
    base = base_config()
    rng = np.random.default_rng(0)
    dense = torch.as_tensor(
        rng.standard_normal((B, base.num_dense_features)),
        dtype=torch.float32, device=dev)
    batch = random_jagged_batch(rng, base.num_sparse_features, B,
                                base.pooling, base.rows_per_table,
                                device=dev)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = dlrm_mod.init_params(gen, base, device=dev)
    else:
        params = params_to(params, dev)

    ref = dlrm_mod.forward(params, dense, batch, base)
    print(f"local oracle CTR logits[:4] = "
          f"{ref[:4].cpu().numpy().round(4)}")
    tiered = serve_tiered(base, params, rng, dev)
    return {"base": base, "params": params, "dense": dense, "batch": batch,
            "ref": ref, "tiered": tiered}


def strategy_args(loc: dict) -> tuple:
    """:func:`strategies`' arguments after the context, from
    :func:`local`'s result: the tensors on the CPU, which every rank
    moves to its own device."""
    batch = loc["batch"]
    return (loc["base"], params_to(loc["params"], "cpu"), loc["dense"].cpu(),
            JaggedBatch(batch.indices.cpu(), batch.lengths.cpu()),
            loc["ref"].cpu())


def main(argv=None, params=None) -> dict:
    """``params``: DLRM parameters (any device) to use in place of the
    seeded draw.  Returns ``{"ref": the oracle's (B,) logits, "tiered":
    serve_tiered's result, "strategies": the rank rows or None}``."""
    args = parser().parse_args(argv)
    n = rank_count(args.ranks, args.device)
    loc = local(args.device, params)
    out = {"ref": loc["ref"].cpu(), "tiered": loc["tiered"],
           "strategies": None}
    if n == 1:
        print("one rank: the distributed comparison needs more than one "
              "(run with --ranks N, or on N cards)")
        return out

    out["strategies"] = run_model_mesh(
        strategies, n, args.device,
        args=strategy_args(loc))
    for row in out["strategies"]:
        assert row["err"] < 1e-4, row["label"]
    print("OK: every sharding strategy reproduces the oracle.")
    return out


if __name__ == "__main__":
    main()
