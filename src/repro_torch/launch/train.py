"""Training launcher: the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --smoke --device cpu --steps 3 --batch 2 --seq 16
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --smoke --device cpu --ranks 4 --steps 3 --batch 4 --seq 16

``--smoke`` selects the reduced config; without it the published config
is built on the card (granite-8b: 16.5 GB of bf16 parameters, as much
again of gradients, and with ``--opt-state-dtype int8`` 17 GB of moments).
``--device`` defaults to the card.  The reference's ``--production-mesh``,
``--multi-pod`` and ``--coordinator`` (TPU meshes, multi-host) are not
here (ROADMAP Queue 1 item 13.8).

With one rank the ``Trainer`` runs on one device and no context, as the
reference's launcher does on one device.  With more -- ``--ranks N``, by
default the cards when no ``--device`` is named, as the reference counts
``jax.devices()`` -- it runs the reference's multi-device path: the debug
mesh ``(data = N / 2, model = 2)`` (``launch/mesh.py``), each rank a
process (NCCL with a card a rank, gloo on the CPU or on one card the
ranks share, ``--device cuda:K``).  As the reference's launcher, it
places the train state by ``launch/specs.state_spec_tree`` under the
rank's context: each rank builds ``Trainer(ctx=, state_shardings=)``,
whose state is drawn piece by piece (``init_train_state(ctx=,
specs=)``: its rows of the vocabulary, its experts, its cut of each
dense weight -- the model axis's and, FSDP, the data axis's -- and the
moments at their specs), takes the same seeded batches and trains its
data group's half of each, each layer's weights gathered whole only
while it runs; global rank 0 alone logs (the placement in one line, then
each step), writes ``--metrics-out`` and
writes the checkpoint (the whole state), and a restore puts each
rank's pieces back.

As in the reference, a run whose ``--ckpt-dir`` holds a checkpoint
resumes from the newest one and runs ``--steps`` more, on the seeded
batches from batch 0.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.data import Prefetcher, lm_batches
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import rank_count, run_debug_mesh
from repro_torch.train.loop import Trainer
from repro_torch.train.step import init_train_state, rank_tensors
from repro_torch.utils.tree import flatten_with_paths


def parser() -> argparse.ArgumentParser:
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
                    help="torch device (default: the CUDA card; with "
                         "--ranks, the device every rank shares)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes of the (ranks / 2, 2) mesh (default: "
                         "the cards without --device, else 1)")
    return ap


def train_config(args) -> TrainConfig:
    return TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       grad_accum=args.grad_accum,
                       optimizer_state_dtype=args.opt_state_dtype,
                       checkpoint_every=args.ckpt_every)


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    n = rank_count(args.ranks, args.device)
    if n > 1:
        run_debug_mesh(_train_rank, n, args.device, args=(cfg, args))
        return
    train(None, cfg, args)


def _train_rank(ctx, cfg, args) -> list:
    return train(ctx, cfg, args).metrics_log


def placement_report(trainer: Trainer, specs) -> str:
    """One line on a placed ``trainer``'s state: its leaves cut over
    each axis by ``specs`` (a state spec tree), and this rank's bytes
    against the whole state's."""
    def axes(spec):
        return {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
    flat = [axes(s) for s in S.flatten_specs(specs).values()]
    whole = init_train_state(None, trainer.cfg, trainer.tc,
                             tp_size=trainer.ranks.world, device="meta")

    def nbytes(state):
        return sum(t.numel() * t.element_size() for _, t in
                   flatten_with_paths({"params": rank_tensors(
                       state["params"], trainer.cfg), "opt": state["opt"]}))
    return (f"placed: {sum(bool(a) for a in flat)} of {len(flat)} state "
            f"leaves cut ({sum('model' in a for a in flat)} over the model "
            f"axis, {sum('data' in a for a in flat)} over the data axis); "
            f"global rank 0 holds {nbytes(trainer.state)} of "
            f"{nbytes(whole)} B")


def train(ctx, cfg, args) -> Trainer:
    """``cfg`` trained ``args.steps`` steps on the seeded batches (from
    its newest checkpoint in ``args.ckpt_dir`` when there is one), on one
    device (``ctx`` None, on ``args.device``) or as one rank of the debug
    mesh (``ctx`` a ``ProcessContext``, on its device).  Returns the
    ``Trainer``; only global rank 0 logs, writes ``args.metrics_out`` and
    the checkpoint."""
    tc = train_config(args)
    lead = ctx is None or ctx.global_rank == 0
    # the reference's src/repro/launch/train.py:69-70
    specs = None if ctx is None else S.state_spec_tree(cfg, tc, ctx)[1]
    data = Prefetcher(lm_batches(cfg, args.batch, args.seq, seed=tc.seed))
    trainer = Trainer(cfg, tc, data, ckpt_dir=args.ckpt_dir, ctx=ctx,
                      device=args.device if ctx is None else None,
                      state_shardings=specs)
    if ctx is not None and lead:
        print(placement_report(trainer, specs))

    def log(step, m):
        print(f"step {step:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  {m['step_time_s']*1e3:.0f} ms")

    trainer.run(args.steps, on_metrics=log)
    data.close()
    if lead:
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(trainer.metrics_log, f)
        print(f"done: {trainer.start_step} steps, "
              f"stragglers observed: {trainer.straggler_events}")
        sys.stdout.flush()
    return trainer


if __name__ == "__main__":
    main()
