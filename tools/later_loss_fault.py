"""The train launcher's step losses over the debug mesh (2, 2) against
the simulated ``Trainer(ctx=make_context(2, dp_size=2))``, sound or with a
fault: with ``--drop PATH`` every leaf whose path starts with PATH skips
the data axis's gradient sum, so each data group updates it from its own
half of the batch.  The fault's gap after step 1 is what a bound on the
later steps' losses has to catch; the sound gap is what it has to let
through.

    PYTHONPATH=src python tools/later_loss_fault.py
    PYTHONPATH=src python tools/later_loss_fault.py --drop blocks/ffn/down
    python tools/later_loss_fault.py --device cuda:0 --full --layers 2 \\
        --batch 2 --seq 2048 --opt-state-dtype int8 --drop blocks/ffn/down

Without ``--full`` it trains granite-8b's smoke config (the batches of
``tests/test_torch_launch_ranks.py``: 4 x 16 tokens, 2 steps); with it
granite-8b's published widths cut to ``--layers``.  Four gloo processes
on ``--device``.  Prints one JSON line: the ranks' losses, the simulated
Trainer's and their relative gaps.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core.parallel import make_context  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.mesh import run_debug_mesh  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402

ARCH = "granite-8b"
RANKS = 4


def _drop_from_data_sum(prefix: str) -> None:
    """This process's ``TrainStep.sum_over_data`` leaves the leaves under
    ``prefix`` as each data group computed them."""
    from repro_torch.train import step as tstep
    from repro_torch.utils.tree import flatten_with_paths

    real = tstep.TrainStep.sum_over_data

    def sum_over_data(self) -> None:
        own = [(g, g.clone()) for p, g in flatten_with_paths(self.grads)
               if p.startswith(prefix)]
        if not own:
            raise ValueError(f"no gradient leaf under {prefix!r}")
        real(self)
        with torch.no_grad():
            for g, mine in own:
                g.copy_(mine)
    tstep.TrainStep.sum_over_data = sum_over_data


def _rank(ctx, cfg, args, drop):
    if drop:
        _drop_from_data_sum(drop)
    return [m["loss"] for _, m in tlaunch.train(ctx, cfg, args).metrics_log]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--opt-state-dtype", default="float32")
    ap.add_argument("--drop", default=None)
    a = ap.parse_args(argv)
    cfg = (dataclasses.replace(configs.get_config(ARCH), num_layers=a.layers)
           if a.full else configs.get_smoke_config(ARCH))
    args = tlaunch.parser().parse_args([
        "--arch", ARCH, "--device", a.device, "--batch", str(a.batch),
        "--seq", str(a.seq), "--steps", str(a.steps), "--opt-state-dtype",
        a.opt_state_dtype])
    got = run_debug_mesh(_rank, RANKS, a.device, args=(cfg, args, a.drop))
    tc = tlaunch.train_config(args)
    sim = Trainer(cfg, tc, lm_batches(cfg, a.batch, a.seq, seed=tc.seed),
                  ctx=make_context(RANKS // 2, dp_size=2), device=a.device)
    sim.run(a.steps)
    want = [m["loss"] for _, m in sim.metrics_log]
    print(json.dumps({
        "config": f"{cfg.name}, {cfg.num_layers} layers", "drop": a.drop,
        "losses": got, "simulated": want,
        "rel": [abs(x - y) / abs(y) for x, y in zip(got, want)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
