"""Stage scheduler: ``admit -> fetch -> scatter -> forward -> swap``.

The counterpart of ``repro.pipeline.scheduler``: a software pipeline over
a :class:`DoubleBufferedSlotPool`.  One micro-batch is in flight on the
device at a time; while its forward runs, the NEXT batch moves through the
prefetch stages against the shadow buffer:

  admit    shadow-manager metadata (``prepare_next``), numpy, on a
           background worker thread: the shadow buffer's state is
           untouched by the in-flight batch;
  fetch    the cold-tier row fetch on the same worker thread, started
           BEFORE the previous forward's scores are copied to the host,
           so the two overlap;
  scatter  the pool scatter into the shadow buffer, from the same worker,
           followed by the forward's operand staging (``prestage``);
  forward  dispatch the batch's forward on the (about-to-be-live) shadow
           pool; its scores reach the host one iteration later, under the
           NEXT batch's prefetch stages;
  swap     rotate the ring (``DoubleBufferedSlotPool.swap``): the prepared
           epoch is published.

Device ordering (where the port differs from the reference).  The
reference relies on JAX's dispatch order for "the scatter lands before its
forward reads the pool".  A new thread's PyTorch work goes to the device's
default stream, where the worker's blocking copies would wait for the
in-flight forward, and its order against the forward would rest on host
timing.  So on the card the scheduler owns one side stream and orders the
two streams with events:

  * the worker runs under ``torch.cuda.device`` and ``torch.cuda.stream``
    of the side stream, so the remote fetch, the scatter and the operand
    staging all run there (the kernel wrappers launch on the current
    stream);
  * write side: before batch k's scatter the side stream waits on the
    event recorded on the main stream after the last forward (or
    fallback flush) that read the same buffer, batch k - depth;
  * read side: after the scatter and the staging the side stream records
    an event, and the main stream waits on it just before the forward;
  * allocator: the staged tensors are made on the side stream and read on
    the main one, so they are ``record_stream``-ed to it;
  * the forward stays on the caller's current (main) stream, the same
    calls on the same stream as the serialized engine.

On the CPU (``device="cpu"``) there are no streams or events: that is the
device the caller chose, and nothing is skipped on the card.

Over a remote cold tier whose hosts are ranks (``remote_ctx``), the fetch
is a sequence of group operations (the requests' all-gathers, then the
reduce-scatter or the one-sided puts), and the worker issues them, the
growth of the symmetric buffers too (a fence, which synchronises the
current stream, the side stream).  The one-sided exchange finishes on the
card: its puts wait for the peers' acknowledgements and its receive
waits for their signals on the side stream, with no stream drain on the
host, and the forward's stream waits on the worker's event as for any
fetch, so the forward on the main stream goes on overlapping.  No put on
the side stream waits on work that only a later launch of that stream
would do: what it waits for are the peers' launches and this rank's
earlier ones.  A gloo group pairs collectives by their order, so one rank
must never issue group operations from two threads at once.  None does: the main thread's forward and drain issue
none, and the capacity fallback's serialized fetch runs on the main
thread only after the worker has been joined.  The capacity decisions
come from the same requests on every rank, so every rank falls back at
the same batch and the ranks' group operations stay paired.

Overlap is OBSERVED, not assumed: every stage records a wall-clock
:class:`StageSpan` into a :class:`PipelineTrace`; ``overlap_s`` is the
measured intersection of prefetch-side spans (admit/fetch) with open
forward spans, and is pushed into the shared ``CacheStats``.

Head-of-line behaviour: a micro-batch whose working set overflows the
shadow buffer (``CacheCapacityError`` from admit, atomic) drains the
in-flight forward and falls back to the caller's serialized split flush,
then the pipeline resumes.  A failed background fetch already invalidated
its slots (``fetch_next``); the error is re-raised after the in-flight
batch's scores reached the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cache.manager import CacheCapacityError
from repro_torch.pipeline.double_buffer import DoubleBufferedSlotPool

STAGES = ("admit", "fetch", "scatter", "forward", "swap")


@dataclasses.dataclass(frozen=True)
class StageSpan:
    """One stage's wall-clock span for one micro-batch."""

    stage: str
    batch: int
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


class PipelineTrace:
    """Recorded stage spans: the pipeline's observability surface.

    With a ``tracer`` (duck-typed: anything with ``add_span``) every
    recorded span is also mirrored onto a unified timeline's pipeline lane
    as ``pipeline.<stage>``, tagged with the owning engine's ``label``.
    With a ``metrics`` registry (anything with ``windowed_histogram``)
    every span also feeds a per-stage windowed histogram
    ``<label>.stage.<stage>_s``.  The port's engine passes neither until
    its telemetry is ported."""

    def __init__(self, tracer=None, label: str = "pipeline",
                 metrics=None, window: int = 32):
        self.spans: List[StageSpan] = []
        self.tracer = tracer
        self.label = label
        self.metrics = metrics
        self.window = window

    def record(self, stage: str, batch: int, start: float,
               end: float) -> None:
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}; one of {STAGES}")
        self.spans.append(StageSpan(stage, batch, start, end))
        if self.tracer is not None:
            self.tracer.add_span(
                f"pipeline.{stage}", start, end, lane="pipeline",
                cat="pipeline", args={"engine": self.label, "batch": batch})
        if self.metrics is not None:
            self.metrics.windowed_histogram(
                f"{self.label}.stage.{stage}_s", unit="s",
                window=self.window).observe(max(0.0, end - start))

    def by_stage(self, stage: str) -> List[StageSpan]:
        return [s for s in self.spans if s.stage == stage]

    def total(self, stage: str) -> float:
        return sum(s.seconds for s in self.by_stage(stage))

    def overlap_s(self) -> float:
        """Prefetch-side wall-clock (admit + fetch spans) that lies inside
        a forward span: the measured hidden latency."""
        fwd = [(s.start, s.end) for s in self.by_stage("forward")]
        out = 0.0
        for s in self.spans:
            if s.stage not in ("admit", "fetch"):
                continue
            for f0, f1 in fwd:
                out += max(0.0, min(s.end, f1) - max(s.start, f0))
        return out

    def overlap_fraction(self) -> float:
        pre = self.total("admit") + self.total("fetch")
        return min(1.0, self.overlap_s() / pre) if pre > 0 else 0.0

    def clear(self) -> None:
        self.spans = []


class PipelineScheduler:
    """Drives the stage pipeline over caller-supplied micro-batches.

    The caller provides the callables, so the scheduler stays
    model-agnostic:

      ``forward(payload, remapped, lengths, pool, staged=None)`` --
        DISPATCH the batch's forward over the given device pool on the
        current stream and return the device output (no host copy);
        ``staged`` is what ``prestage`` returned for this batch (None
        without a prestage hook);
      ``collect(payload, host_out)`` -- turn the scores, as a numpy array,
        into the caller's result dict;
      ``fallback(payload)`` -- serialized split flush, on the current
        stream, for a batch whose working set overflowed the shadow
        buffer;
      ``prestage(payload, remapped, lengths)`` (optional) -- build the
        forward's device operands as a tuple of tensors; runs on the
        worker thread (the side stream on the card) right after the
        scatter, so the host-to-device staging hides under the in-flight
        forward too.

    ``fallbacks`` counts the batches that took the fallback.
    """

    def __init__(self, pool: DoubleBufferedSlotPool, *,
                 forward: Callable[..., Any],
                 collect: Callable[[Any, np.ndarray], Dict],
                 fallback: Callable[[Any], Dict],
                 prestage: Optional[Callable[..., Tuple]] = None,
                 trace: Optional[PipelineTrace] = None):
        self.pool = pool
        self.forward, self.collect, self.fallback = forward, collect, fallback
        self.prestage = prestage
        self.trace = trace if trace is not None else PipelineTrace()
        self._seq = 0                 # global micro-batch counter (spans)
        self._overlap_reported = 0.0  # overlap already pushed into stats
        self.fallbacks = 0
        self.device = pool.device
        if self.device.type == "cuda":
            if self.device.index is None:   # fix the card now: the worker
                self.device = torch.device(  # thread's current one is 0
                    "cuda", torch.cuda.current_device())
            self.side = torch.cuda.Stream(self.device)
        elif self.device.type == "cpu":
            self.side = None
        else:
            raise ValueError(f"PipelineScheduler runs on a CUDA device or "
                             f"the CPU, not {self.device}")
        self._main: Optional[torch.cuda.Stream] = None
        # per buffer: the main-stream event after the last forward (or
        # fallback flush) that read it; its next scatter waits on it
        self._read_done: List[Optional[torch.cuda.Event]] = \
            [None] * pool.depth

    # -- device ordering (no-ops on the CPU) ---------------------------------

    @contextlib.contextmanager
    def _worker_stream(self):
        """The worker's device context: the side stream on the card."""
        if self.side is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.side):
            yield

    def _await_readers(self, buffer: int) -> None:
        """Side stream: wait for the last main-stream read of ``buffer``."""
        if self.side is not None and self._read_done[buffer] is not None:
            self.side.wait_event(self._read_done[buffer])

    def _mark_read(self, buffer: int) -> None:
        """Main stream: record that ``buffer``'s reads so far are queued."""
        if self.side is not None:
            self._read_done[buffer] = self._main.record_event()

    def _hand_over(self, staged: Optional[Tuple]) -> Optional[
            torch.cuda.Event]:
        """Side stream, after the scatter and the staging: keep the staged
        tensors' blocks from reuse until the main stream is done with
        them, and return the event the forward waits on."""
        if self.side is None:
            return None
        for t in staged or ():
            t.record_stream(self._main)
        return self.side.record_event()

    # -- the pipeline --------------------------------------------------------

    def run(self, batches: Sequence[Tuple[Any, np.ndarray, np.ndarray]],
            out: Optional[Dict] = None) -> Dict:
        """Pipeline ``batches`` (payload, (T,B,L) indices, (T,B) lengths)
        through the ring; returns the union of ``collect``ed results.

        Results accumulate into ``out`` IN PLACE as each batch drains, so
        a caller passing its own dict keeps every already-scored result
        even when a later stage raises."""
        stats = self.pool.stats
        if out is None:
            out = {}
        if self.side is not None:
            # the forward's stream; everything queued on it so far (pool
            # and shard copies, a warmup scatter) precedes the side work
            self._main = torch.cuda.current_stream(self.device)
            self.side.wait_stream(self._main)
        depth = self.pool.depth
        inflight = None     # (payload, device_out, dispatch_t0, batch_id)
        for payload, indices, lengths in batches:
            k = self._seq
            self._seq += 1
            # -- admit + fetch + scatter for batch k on a worker thread:
            #    every stage touches only the SHADOW buffer (the in-flight
            #    forward reads the live one)...
            box: Dict[str, Any] = {}

            def _worker(box=box, payload=payload, indices=indices,
                        lengths=lengths):
                stamps = [time.perf_counter()]
                try:
                    with self._worker_stream():
                        plan = box["plan"] = self.pool.prepare_next(indices,
                                                                    lengths)
                        stamps.append(time.perf_counter())
                        rows = self.pool.fetch_next(plan)
                        stamps.append(time.perf_counter())
                        self._await_readers(plan.epoch % depth)
                        self.pool.commit_next(plan, rows)
                        if self.prestage is not None:   # operand staging
                            box["staged"] = self.prestage(
                                payload, plan.remapped, lengths)
                        box["ready"] = self._hand_over(box.get("staged"))
                except BaseException as e:  # noqa: BLE001 -- rethrown below
                    box["err"] = e
                stamps.append(time.perf_counter())
                box["stamps"] = stamps

            # one short-lived thread per micro-batch: spawn cost is tens of
            # microseconds against millisecond-scale batches, and a dead
            # thread cannot leak a half-finished stage into the next batch
            th = threading.Thread(target=_worker, daemon=True)
            th.start()
            # -- ...while batch k-1's forward completes under it
            if inflight is not None:
                out.update(self._drain(inflight))
                inflight = None
            th.join()
            stamps = box["stamps"]
            for stage, (s0, s1) in zip(("admit", "fetch", "scatter"),
                                       zip(stamps, stamps[1:])):
                self.trace.record(stage, k, s0, s1)
                stats.add_time("scatter" if stage == "scatter"
                               else "prefetch", s1 - s0)
            err = box.get("err")
            # the worker is joined: the fallback's group operations (a
            # remote fetch over ranks) cannot interleave with its own
            if isinstance(err, CacheCapacityError):
                # head-of-line fallback: the working set overflowed the
                # shadow buffer (atomic: nothing admitted); score this
                # batch through the serialized split path and resume
                self.fallbacks += 1
                out.update(self.fallback(payload))
                self._mark_read(self.pool.epoch % depth)
                continue
            if err is not None:    # residency already invalidated in-thread
                raise err
            # -- dispatch forward k on the shadow pool, then publish it
            plan = box["plan"]
            t4 = time.perf_counter()
            if self.side is not None:
                self._main.wait_event(box["ready"])
            dev = self.forward(payload, plan.remapped, lengths,
                               self.pool.shadow.pool,
                               staged=box.get("staged"))
            self._mark_read(plan.epoch % depth)
            t5 = time.perf_counter()
            self.pool.swap()
            self.trace.record("swap", k, t5, time.perf_counter())
            inflight = (payload, dev, t4, k)
        if inflight is not None:
            out.update(self._drain(inflight))
        # push the measured overlap delta into the shared stats record
        total = self.trace.overlap_s()
        stats.add_time("overlap", total - self._overlap_reported)
        self._overlap_reported = total
        return out

    def _drain(self, inflight) -> Dict:
        """Copy the in-flight forward's scores to the host (the only
        blocking point of the pipeline) and record its span."""
        payload, dev, t_dispatch, k = inflight
        host = dev.cpu().numpy()
        t_end = time.perf_counter()
        self.trace.record("forward", k, t_dispatch, t_end)
        self.pool.stats.add_time("forward", t_end - t_dispatch)
        return self.collect(payload, host)
