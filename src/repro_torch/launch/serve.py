"""Serving launcher: continuous-batching decode over a dense, MoE, hybrid
or ssm LM config (``--arch``: ``configs.PORTED_ARCH_IDS``; the MoE with
GQA or MLA attention, hymba-1.5b, rwkv6-1.6b).  The vlm family exits as
in the reference (its prompts need patch inputs), and so does the audio
family (its prompts need frames: ``serving.engine.generate(frames=)``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --smoke --device cpu --requests 8 --prompt-len 12 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v3-671b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --smoke --device cpu --ranks 4

Builds random parameters from ``--seed`` (a full-width config needs the
card: granite-8b is 16.5 GB in bfloat16, moonshot-v1-16b-a3b 56.7 GB;
deepseek-v3-671b's full ``CONFIG``, 1.34 TB, fits on no single card;
hymba-1.5b and rwkv6-1.6b take 3-4 GB),
submits prompts of uniform ids, runs the slot loop to completion and
reports the prefill time per prompt, the per-token decode latency and the
tokens per second, all on the host clock (``time.perf_counter``) up to
the tokens on the host.

With more than one rank -- ``--ranks N``, by default the cards when no
``--device`` is named, as the reference counts ``jax.devices()`` -- it
runs the reference's multi-device path: the debug mesh ``(data = N / 2,
model = 2)`` (``launch/mesh.py``), each rank a process
(``core/parallel.run_ranks``; NCCL with a card a rank, gloo on the CPU
or on one card the ranks share, ``--device cuda:K``).  Each rank draws
only its own parameters from the seed (``lm.init_params(ctx=)``: its rows
of the vocabulary, its experts; no process holds the whole model), builds
``ContinuousBatcher(ctx=)`` (its data group's slots, its slice of their
cache: ``max_len`` must divide over the model axis), submits the same
requests and runs them to completion; global rank 0 prints the report,
with the slowest rank's medians and each rank's peak memory.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import (MODEL_AXIS, gather_world, peak_bytes,
                                     rank_count, run_debug_mesh)
from repro_torch.models import lm
from repro_torch.serving.engine import ContinuousBatcher, Request
from repro_torch.utils.device import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.PORTED_ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card; with "
                         "--ranks, the device every rank shares)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes of the (ranks / 2, 2) mesh (default: "
                         "the cards without --device, else 1)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=None,
                    help="positions per slot (default prompt-len + max-new)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def requests(cfg, args) -> list:
    """The seeded requests of uniform ids, the same on every rank."""
    rng = np.random.default_rng(args.seed)
    return [Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size,
                                                 args.prompt_len
                                                 ).astype(np.int32),
                    max_new=args.max_new)
            for rid in range(args.requests)]


def max_len(args, reqs=None) -> int:
    """``--max-len``, by default the longest prompt (``--prompt-len``, or
    of ``reqs``) and ``--max-new``."""
    longest = (args.prompt_len if reqs is None
               else max(len(r.prompt) for r in reqs))
    return args.max_len or longest + args.max_new


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.family == "vlm":
        raise SystemExit("vlm serving needs patch inputs; run "
                         "lm.forward(..., patches=)")
    if cfg.family == "audio":
        raise SystemExit("audio serving needs frame inputs; run "
                         "serving.engine.generate(..., frames=)")
    n = rank_count(args.ranks, args.device)
    if n > 1:
        run_debug_mesh(serve, n, args.device, args=(cfg, args))
        return 0
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(gen, cfg, device=device)
    eng = ContinuousBatcher(params, cfg, num_slots=args.slots,
                            max_len=max_len(args), eos_id=-1, device=device)
    for req in requests(cfg, args):
        eng.submit(req)
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.generated) for r in done.values())
    prefill = [s for _, s in eng.timings["prefill"]]
    decode = eng.timings["decode"]
    print(f"{cfg.name} on {device}: served {len(done)} requests, {tokens} "
          f"tokens in {dt:.3f} s ({tokens / dt:.1f} tokens/s)")
    print(f"  prefill of {args.prompt_len} tokens: median "
          f"{1e3 * statistics.median(prefill):.3f} ms over {len(prefill)}")
    print(f"  decode step ({args.slots} slots): median "
          f"{1e3 * statistics.median(decode):.3f} ms per token over "
          f"{len(decode)} steps")
    for rid in sorted(done)[:4]:
        print(f"  req {rid}: {done[rid].generated[:10]}")
    return 0


def serve(ctx, cfg, args, params=None, reqs=None) -> dict:
    """One rank of the debug mesh (``ctx`` a ``ProcessContext``): its
    share of the parameters drawn from ``args.seed`` (or ``params``, this
    rank's share, when given), the seeded requests (or ``reqs``, the same
    on every rank) through ``ContinuousBatcher(ctx=)`` to completion.
    Returns ``{"tokens":
    {rid: generated}, "ranks": [each rank's "prefill" and "decode"
    seconds, "seconds", "peak_bytes"]}``; global rank 0 prints the
    report."""
    dev = ctx.device
    with torch.no_grad():
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            params = lm.init_params(gen, cfg, ctx=ctx)
        if reqs is None:
            reqs = requests(cfg, args)
        eng = ContinuousBatcher(params, cfg, num_slots=args.slots,
                                max_len=max_len(args, reqs), ctx=ctx,
                                eos_id=-1)
        for req in reqs:
            eng.submit(req)
        t0 = time.perf_counter()
        done = eng.run_to_completion()
        dt = time.perf_counter() - t0
    ranks = gather_world(dict(
        prefill=[s for _, s in eng.timings["prefill"]],
        decode=list(eng.timings["decode"]), seconds=dt,
        peak_bytes=peak_bytes(dev)))
    tokens = {rid: r.generated for rid, r in done.items()}
    if ctx.global_rank == 0:
        _report(cfg, args, ctx, reqs, tokens, ranks)
    return {"tokens": tokens, "ranks": ranks}


def _report(cfg, args, ctx, reqs, tokens, ranks) -> None:
    n = len(ranks)
    total = sum(len(t) for t in tokens.values())
    dt = max(r["seconds"] for r in ranks)
    prefill = max(statistics.median(r["prefill"]) for r in ranks)
    decode = max(statistics.median(r["decode"]) for r in ranks)
    where = "device" if ctx.device.type == "cuda" else "host RSS"
    print(f"{cfg.name} on {n} ranks ({ctx.device.type}, "
          f"{dist.get_backend()}) as (data, model) = ({n // MODEL_AXIS}, "
          f"{MODEL_AXIS}): served {len(tokens)} requests, {total} tokens in "
          f"{dt:.3f} s ({total / dt:.1f} tokens/s)")
    lens = sorted({len(r.prompt) for r in reqs})
    print(f"  prefill of {','.join(map(str, lens))} tokens: median "
          f"{1e3 * prefill:.3f} ms over {len(ranks[0]['prefill'])} (the "
          f"slowest rank's)")
    print(f"  decode step ({args.slots} slots): median {1e3 * decode:.3f} "
          f"ms per token over {len(ranks[0]['decode'])} steps (the "
          f"slowest rank's)")
    print(f"  peak {where} memory per rank: "
          f"{[round(r['peak_bytes'] / 1e9, 3) for r in ranks]} GB")
    for rid in sorted(tokens)[:4]:
        print(f"  req {rid}: {tokens[rid][:10]}")
    sys.stdout.flush()


if __name__ == "__main__":
    raise SystemExit(main())
