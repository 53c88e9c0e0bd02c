"""End-to-end training driver on the port: train a ~100M-param
granite-family model for a few hundred steps with the full stack (AdamW
+ int8 moments, remat, checkpoints, deterministic data).

    PYTHONPATH=src python examples/lm_train_torch.py --steps 300
    PYTHONPATH=src python examples/lm_train_torch.py --device cpu \\
        --steps 3 --batch 2 --seq 32

The counterpart of ``examples/lm_train.py``, on one device (the card by
default).  12L x d=768 x ff=3072, vocab 32768; the parameters are drawn
from ``TrainConfig.seed`` (0) by ``Trainer``.  Asserts that the loss
falls from the first step to the last.
"""
import argparse
import tempfile

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import Prefetcher, lm_batches
from repro_torch.train.loop import Trainer
from repro_torch.utils.device import resolve_device


def make_100m() -> ModelConfig:
    return ModelConfig(
        name="granite-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=3072, vocab_size=32768,
        activation="silu", dtype="float32")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    return ap


def main(argv=None) -> Trainer:
    """Runs the training; returns the ``Trainer`` (its ``metrics_log``
    holds every step's metrics)."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = make_100m()
    n_params = cfg.param_count()
    print(f"model: {cfg.name}  ~{n_params/1e6:.0f}M params on {device}")
    tc = TrainConfig(learning_rate=6e-4, warmup_steps=20,
                     total_steps=args.steps, checkpoint_every=100,
                     optimizer_state_dtype="int8")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="lm100m_")
    data = Prefetcher(lm_batches(cfg, args.batch, args.seq, seed=0))
    trainer = Trainer(cfg, tc, data, ckpt_dir=ckpt_dir, device=device)

    def log(step, m):
        if step % 10 == 0 or step <= 3:
            print(f"step {step:4d}  loss {m['loss']:.4f}  "
                  f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.2f}  "
                  f"{m['step_time_s']*1e3:.0f} ms")

    trainer.run(args.steps, on_metrics=log)
    data.close()
    losses = [m["loss"] for _, m in trainer.metrics_log]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps; checkpoints in {ckpt_dir}")
    assert losses[-1] < losses[0]
    return trainer


if __name__ == "__main__":
    main()
