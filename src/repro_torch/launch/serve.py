"""Serving launcher: continuous-batching decode over a dense LM config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --smoke --device cpu --requests 8 --prompt-len 12 --max-new 8

Builds random parameters from ``--seed`` (a full-width config needs the
card: granite-8b is 16.5 GB in bfloat16), submits prompts of uniform ids,
runs the slot loop to completion and reports the prefill time per prompt,
the per-token decode latency and the tokens per second, all on the host
clock (``time.perf_counter``) up to the tokens on the host.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serving.engine import ContinuousBatcher, Request
from repro_torch.utils.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.DENSE_ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=None,
                    help="positions per slot (default prompt-len + max-new)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(gen, cfg, device=device)
    eng = ContinuousBatcher(
        params, cfg, num_slots=args.slots,
        max_len=args.max_len or args.prompt_len + args.max_new,
        eos_id=-1, device=device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        eng.submit(Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab_size, args.prompt_len
                                         ).astype(np.int32),
            max_new=args.max_new))
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


if __name__ == "__main__":
    raise SystemExit(main())
