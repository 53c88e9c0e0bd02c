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
multiple of its model axis, as the reference's.  ``state_shardings``
changes nothing there: the simulated ranks share one card, which holds
the state whole.

Under a ``ProcessContext`` each rank is a process: every rank draws its
pieces of the initial state from the seed (``train/step.init_train_state``
with the context, on its own device: a card's generator draws what the
simulated ranks' draws on that card, and a rank keeps only its pieces),
and restores its pieces of a checkpoint when there is one; every rank
takes the same batches from its ``data`` (pass each the same seeded
iterator), the train step drawing its data group's rows of each when a
data axis splits it, and global rank 0 alone calls ``on_metrics``.  The
pieces are those of ``state_shardings``, the reference's name for the
state's placement: a state spec tree (``launch/specs.state_spec_tree``
under the context; the parameters, their gradients and both moments
each cut as its spec says, a layer's weights gathered whole only while
it runs), or, with None, the cuts every rank holds whatever the
placement (its rows of the table, its experts, and their moments).  A
checkpoint is the one the Trainer writes on one device, the whole
state: global rank 0 receives each cut leaf's pieces on the host and
writes (``checkpoint.store.save`` with the context); a restore cuts each
rank's pieces from it.  So a run resumes bitwise, and a checkpoint
written under one placement restores under another, under
``make_context(E)`` and on one device, and the other way round.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.parallel import ParallelContext, ProcessContext
from repro_torch.models.lm import check_context
from repro_torch.train.step import (init_train_state, make_train_step,
                                    rank_tensors, sync_tied_head)
from repro_torch.utils.device import resolve_device


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 data: Iterator[Dict[str, np.ndarray]],
                 ckpt_dir: Optional[str] = None,
                 ctx: Optional[ParallelContext | ProcessContext] = None,
                 dtype: Optional[torch.dtype] = None, device=None,
                 state_shardings=None):
        self.cfg, self.tc = cfg, tc
        self.ctx = check_context(ctx)
        self.ranks = ctx if isinstance(ctx, ProcessContext) else None
        if self.ranks is not None:
            self.device = ctx.device if device is None else \
                torch.device(device)
            if self.device != ctx.device:
                raise ValueError(f"device {self.device} is not the rank's "
                                 f"{ctx.device}")
        else:
            self.device = resolve_device(device)
        self.data = data
        self.ckpt_dir = ckpt_dir
        self.metrics_log: list = []
        self._preempted = False
        self._step_times: list = []
        self.straggler_factor = 3.0
        self.straggler_events = 0

        specs = state_shardings if self.ranks is not None else None
        self.step_fn = make_train_step(cfg, tc, ctx, specs)
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        tp = ctx.tp_size if ctx is not None else 1
        self.state = init_train_state(gen, cfg, tc, tp_size=tp, dtype=dtype,
                                      device=self.device, ctx=self.ranks,
                                      specs=specs)
        # each state leaf's spec, by path: what a checkpoint gathers from
        # (restores to) the ranks
        self.specs = {} if self.ranks is None else \
            self.step_fn.place.state
        start = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
        if start is not None:
            ckpt.restore(self._tensors(), ckpt_dir, start, ctx=self.ranks,
                         specs=self.specs)
            if self.ranks is not None:
                sync_tied_head(self.state["params"], cfg, self.ranks)
            self.start_step = start
        else:
            self.start_step = 0

    def _tensors(self):
        """The state as the tree of tensors a checkpoint holds (a rank's
        ``RankShard`` as its rows)."""
        return {"params": rank_tensors(self.state["params"], self.cfg),
                "opt": self.state["opt"]}

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
        if not self.ckpt_dir:
            return
        ckpt.save(self._tensors(), self.ckpt_dir, step,
                  asynchronous=asynchronous, keep=self.tc.keep_checkpoints,
                  ctx=self.ranks, specs=self.specs)
        if self.ranks is not None and not asynchronous:
            dist.barrier()          # the world: global rank 0 has written

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
                if on_metrics and (self.ranks is None
                                   or self.ranks.global_rank == 0):
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
