"""Trainer: the fault-tolerant step loop, the counterpart of
``repro.train.loop``.

  * init (from a ``torch.Generator`` seeded with ``tc.seed``, on
    ``device``) or resume from the newest intact checkpoint;
  * periodic asynchronous checkpoints, and a final synchronous one after
    ``wait_all``; SIGTERM/SIGINT set a flag, and the loop saves and
    returns after the step in flight;
  * deterministic data (the batch at step s is a function of (seed, s)),
    so a resumed run replays the same batches and reaches the same
    state bitwise;
  * per-step metrics and ``step_time_s`` (host clock, the device
    synchronised), and a straggler count: steps slower than
    ``straggler_factor`` x the median of the last 50.

Under a ``ParallelContext`` the step runs on the context's simulated
ranks (``train/step.py``) and the state's vocabulary is padded to a
multiple of its model axis, as the reference's.  The reference's
``state_shardings`` (leaves placed on a device mesh, also when a
checkpoint is restored) has no counterpart: one card holds the state
whole.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.parallel import ParallelContext
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.utils.device import resolve_device


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 data: Iterator[Dict[str, np.ndarray]],
                 ckpt_dir: Optional[str] = None,
                 ctx: Optional[ParallelContext] = None,
                 dtype: Optional[torch.dtype] = None, device=None):
        self.cfg, self.tc, self.ctx = cfg, tc, ctx
        self.device = resolve_device(device)
        self.data = data
        self.ckpt_dir = ckpt_dir
        self.metrics_log: list = []
        self._preempted = False
        self._step_times: list = []
        self.straggler_factor = 3.0
        self.straggler_events = 0

        self.step_fn = make_train_step(cfg, tc, ctx)
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        tp = ctx.tp_size if ctx is not None else 1
        self.state = init_train_state(gen, cfg, tc, tp_size=tp, dtype=dtype,
                                      device=self.device)
        start = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
        if start is not None:
            ckpt.restore(self.state, ckpt_dir, start)
            self.start_step = start
        else:
            self.start_step = 0

    # ------------------------------------------------------------------
    def _install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        self._old = {s: signal.signal(s, handler)
                     for s in (signal.SIGTERM, signal.SIGINT)}

    def _restore_handlers(self):
        for s, h in getattr(self, "_old", {}).items():
            signal.signal(s, h)

    def _checkpoint(self, step: int, asynchronous: bool = True):
        if self.ckpt_dir:
            ckpt.save(self.state, self.ckpt_dir, step,
                      asynchronous=asynchronous, keep=self.tc.keep_checkpoints)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def run(self, num_steps: int,
            on_metrics: Optional[Callable[[int, Dict], None]] = None):
        """Run ``num_steps`` (or until preemption).  Returns the state."""
        self._install_preemption_handler()
        try:
            step = self.start_step
            end = self.start_step + num_steps
            while step < end and not self._preempted:
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in next(self.data).items()}
                self._sync()
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                self._sync()
                dt = time.perf_counter() - t0
                self._step_times.append(dt)
                med = float(np.median(self._step_times[-50:]))
                if len(self._step_times) > 5 and dt > self.straggler_factor * med:
                    self.straggler_events += 1
                step += 1
                m = {k: float(v) for k, v in metrics.items()}
                m["step_time_s"] = dt
                self.metrics_log.append((step, m))
                if on_metrics:
                    on_metrics(step, m)
                if step % self.tc.checkpoint_every == 0:
                    self._checkpoint(step)
            # the final (or preemption) checkpoint is synchronous
            ckpt.wait_all()           # the asynchronous writers first
            self._checkpoint(step, asynchronous=False)
            self.start_step = step
            return self.state
        finally:
            self._restore_handlers()
