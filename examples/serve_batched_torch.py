"""Batched serving on the port: LM continuous batching AND pipelined DLRM
scoring.

    PYTHONPATH=src python examples/serve_batched_torch.py
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

The counterpart of ``examples/serve_batched.py``.

LM cell: requests arrive, slots are admitted/evicted, one decode_step
advances every active sequence (``ContinuousBatcher``).

DLRM cell: the same CTR request stream served by the serialized
``DLRMEngine`` (depth 1) and the ``PipelinedDLRMEngine`` (depth 2 --
double-buffered slot pools, the next batch's prefetch under the live
forward), configured PURELY through ``DLRMConfig`` fields; scores are
asserted equal and the measured stage spans / overlap fraction are
printed.  The reference pins ``kernel_mode="reference"`` here; the port
has no such field: it dispatches on the tensors' device (the kernels on
the card, their plain versions on the CPU).
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serving.engine import ContinuousBatcher, Request
from repro_torch.utils.device import resolve_device


def serve_dlrm_pipelined(device, params=None) -> dict:
    """Depth-2 pipelined CTR scoring vs the serialized engine on
    ``device``; ``params`` in place of the seeded draw.  Returns
    ``{"scores": {rid: score}, "slo": the monitor's summary}``."""
    from repro_torch.configs import dlrm as dlrm_cfg
    from repro_torch.core.cache_config import CacheConfig
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.obs import Telemetry
    from repro_torch.obs.slo import SLOMonitor, SLOPolicy
    from repro_torch.serving.engine import CTRRequest, make_dlrm_engine

    base = dataclasses.replace(
        dlrm_cfg.smoke(), cache=CacheConfig(rows=32, policy="lru"))
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = dlrm_mod.init_params(gen, base, device=device)
    T, L, F = (base.num_sparse_features, base.pooling,
               base.num_dense_features)
    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(24):
        ranks = rng.zipf(1.2, size=(T, L))
        reqs.append(CTRRequest(
            rid=rid, dense=rng.standard_normal(F).astype(np.float32),
            indices=np.minimum(ranks - 1,
                               base.rows_per_table - 1).astype(np.int32),
            lengths=rng.integers(1, L + 1, T).astype(np.int32)))

    # engine selection is pure config: cache.pipeline_depth 1 vs 2;
    # one Telemetry watches both, and an SLOMonitor evaluates the
    # pipelined engine's windows as they complete (a tick listener)
    tel = Telemetry(window=4)
    serial = make_dlrm_engine(params, base, batch_size=8, telemetry=tel,
                              device=device)
    piped = make_dlrm_engine(
        params,
        dataclasses.replace(
            base, cache=dataclasses.replace(base.cache, pipeline_depth=2)),
        batch_size=8, telemetry=tel, device=device)
    # a generous latency budget (smoke run, first calls included) plus
    # a hit-rate floor the COLD-START windows are expected to breach --
    # demonstrating the monitor actually fires
    mon = SLOMonitor(tel, SLOPolicy(
        name="example", p99_budget_s=30.0, hit_rate_floor=0.05,
        queue_depth_cap=256), engine=piped.obs_name)
    for r in reqs:
        serial.submit(r)
        piped.submit(r)
    want = serial.run_to_completion()
    got = piped.run_to_completion()
    assert sorted(got) == sorted(want)
    assert all(got[rid] == want[rid] for rid in want), \
        "pipelined scores must equal the serialized engine's"
    s, ss = piped.cache_stats(), serial.cache_stats()
    print(f"DLRM: {len(reqs)} reqs x 2 engines, scores equal "
          f"(depth 2 vs depth 1)")
    print(f"  serialized spans: prefetch={ss.prefetch_s*1e3:.1f}ms "
          f"scatter={ss.scatter_s*1e3:.1f}ms forward={ss.forward_s*1e3:.1f}ms"
          f" (overlap {ss.overlap_fraction:.2f})")
    print(f"  pipelined  spans: prefetch={s.prefetch_s*1e3:.1f}ms "
          f"scatter={s.scatter_s*1e3:.1f}ms forward={s.forward_s*1e3:.1f}ms "
          f"(overlap {s.overlap_fraction:.2f})")
    for stage in ("admit", "fetch", "scatter", "forward", "swap"):
        print(f"    stage {stage:8s} {piped.trace.total(stage)*1e3:8.2f}ms")
    # end-of-run SLO summary: every completed window was judged live
    summ = mon.summary()
    print(f"  SLO [{summ['policy']}] windows={summ['windows_evaluated']} "
          f"breaches={summ['breaches']} "
          f"worst_p99={summ['worst_p99_s']*1e3:.2f}ms "
          f"by_rule={summ['breaches_by_rule']}")
    assert summ["windows_evaluated"] > 0, "the monitor must see windows"
    # cold-start hit_rate breaches are expected; latency/depth are not
    assert set(summ["breaches_by_rule"]) <= {"hit_rate"}, \
        "a 30s p99 budget / 256-deep queue cap must not breach here"
    return {"scores": got, "slo": summ}


def serve_lm(device, params=None) -> dict:
    """The LM cell on ``device``: granite-8b's smoke config, 4 slots;
    ``params`` in place of the seeded draw.  Returns ``{rid: Request}``."""
    cfg = configs.get_smoke_config("granite-8b")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = lm.init_params(gen, cfg, device=device)
    eng = ContinuousBatcher(params, cfg, num_slots=4, max_len=64, eos_id=-1,
                            device=device)

    rng = np.random.default_rng(0)
    n_req = 10
    for rid in range(n_req):
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size,
                                rng.integers(4, 12)).astype(np.int32),
            max_new=int(rng.integers(4, 10))))

    t0 = time.perf_counter()
    done = eng.run_to_completion()
    dt = time.perf_counter() - t0
    total = sum(len(r.generated) for r in done.values())
    print(f"served {len(done)}/{n_req} requests, {total} tokens in "
          f"{dt:.2f}s ({total/dt:.1f} tok/s, 4 slots, continuous batching)")
    for rid in sorted(done):
        r = done[rid]
        print(f"  req {rid}: prompt_len={len(r.prompt)} -> "
              f"{len(r.generated)} tokens: {r.generated}")
    assert len(done) == n_req
    return done


def main(argv=None, lm_params=None, dlrm_params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return {"lm": serve_lm(dev, lm_params),
            "dlrm": serve_dlrm_pipelined(dev, dlrm_params)}


if __name__ == "__main__":
    main()
