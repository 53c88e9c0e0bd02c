"""Training launcher: the counterpart of ``repro.launch.train`` on one
device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --smoke --device cpu --steps 3 --batch 2 --seq 16

``--smoke`` selects the reduced config; without it the published config
is built on the card (granite-8b: 16.5 GB of bf16 parameters, as much
again of gradients, and with ``--opt-state-dtype int8`` 17 GB of moments).
``--device`` defaults to the card.  The reference's ``--production-mesh``,
``--multi-pod`` and ``--coordinator`` (TPU meshes, multi-host) are not
here: one device only (ROADMAP Queue 1 items 13.6 and 13.8).
"""
from __future__ import annotations

import argparse
import json

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.data import Prefetcher, lm_batches
from repro_torch.train.loop import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.PORTED_ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--opt-state-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(1, args.steps // 10),
                     grad_accum=args.grad_accum,
                     optimizer_state_dtype=args.opt_state_dtype,
                     checkpoint_every=args.ckpt_every)

    data = Prefetcher(lm_batches(cfg, args.batch, args.seq, seed=tc.seed))
    trainer = Trainer(cfg, tc, data, ckpt_dir=args.ckpt_dir,
                      device=args.device)

    def log(step, m):
        print(f"step {step:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  {m['step_time_s']*1e3:.0f} ms")

    trainer.run(args.steps, on_metrics=log)
    data.close()
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(trainer.metrics_log, f)
    print(f"done: {trainer.start_step} steps, "
          f"stragglers observed: {trainer.straggler_events}")


if __name__ == "__main__":
    main()
