"""Epoch-protocol checker: the pipeline sanitizer.

The counterpart of ``repro.analysis.protocol``, a copy of that numpy/ast
module (the port imports nothing of the reference) pointed at the port's
own scheduler.  The double-buffered pipeline's correctness argument is a
PROTOCOL, not a property of any one run: plans are epoch-stamped at
``prepare_next``, refused at ``commit_next`` unless they target the ring's
next epoch, and published by ``swap``; batch k's scatter writes
``buffers[(k+1) % depth]`` while batch k-1's forward reads
``buffers[k % depth]``.  Three checks:

  * :class:`EpochReplay` -- the ``prepare -> fetch -> commit -> serve ->
    swap`` state machine as explicit transitions with ring-epoch
    predicates.  Feeding it any event stream (a test's synthetic
    schedule, the scheduler's statically extracted call order) yields
    every protocol violation: stale commits, double commits, swaps
    publishing uncommitted epochs.
  * :func:`check_scheduler_source` -- static call-order validation: parse
    the port's ``PipelineScheduler.run`` (worker-thread body inlined at
    its lexical position), extract the per-batch sequence of protocol
    calls, and replay it through :class:`EpochReplay`.  A reordering that
    breaks the protocol (e.g. swapping before the commit) fails here,
    before any trace exists.  The stream and event calls of ``run`` carry
    none of the protocol names, so they do not show up in the sequence.
  * :func:`check_timeline` -- the happens-before validator: replay
    recorded :class:`~repro_torch.pipeline.scheduler.StageSpan` wall-clock
    timelines and prove no shadow-buffer write (scatter span of batch j,
    targeting ring slot ``(j+1) % depth``) overlaps a live-buffer read
    (forward span of batch k, reading the same slot), and that each
    batch's own scatter precedes its forward.  The spans are host-clock
    spans; on the card the device order comes from the scheduler's events.
"""
from __future__ import annotations

import ast
import dataclasses
import inspect
import json
import textwrap
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Plan lifecycle states inside one ring epoch.
_IDLE, _PREPARED, _FETCHED, _COMMITTED, _SERVING = (
    "idle", "prepared", "fetched", "committed", "serving")


@dataclasses.dataclass(frozen=True)
class ProtocolViolation:
    kind: str        # stale-commit | double-commit | swap-uncommitted | ...
    detail: str

    def __str__(self) -> str:
        return f"[{self.kind}] {self.detail}"


class EpochReplay:
    """The ``DoubleBufferedSlotPool`` epoch state machine, replayable.

    Events: ``prepare(epoch)``, ``fetch(epoch)``, ``commit(epoch)``,
    ``serve(epoch)``, ``swap()``.  ``epoch`` is the RING epoch the plan
    was stamped with (``prepare_next`` stamps ``ring + 1``).  Illegal
    transitions accumulate as :class:`ProtocolViolation`s rather than
    raising, so one replay reports every defect in a schedule.
    """

    def __init__(self, depth: int = 2):
        if depth < 2:
            raise ValueError(f"pipeline depth must be >= 2, got {depth}")
        self.depth = depth
        self.ring = 0                        # published (live) ring epoch
        self.states: Dict[int, str] = {}     # plan epoch -> lifecycle state
        self.violations: List[ProtocolViolation] = []

    def _flag(self, kind: str, detail: str) -> None:
        self.violations.append(ProtocolViolation(kind, detail))

    def prepare(self, epoch: int) -> None:
        if epoch != self.ring + 1:
            self._flag("early-prepare",
                       f"plan prepared for ring epoch {epoch} while the "
                       f"next publishable epoch is {self.ring + 1}")
        if self.states.get(epoch) in (_PREPARED, _FETCHED):
            self._flag("double-prepare",
                       f"epoch {epoch} prepared twice without a swap")
        self.states[epoch] = _PREPARED

    def fetch(self, epoch: int) -> None:
        if self.states.get(epoch) != _PREPARED:
            self._flag("fetch-unprepared",
                       f"fetch for epoch {epoch} in state "
                       f"{self.states.get(epoch, _IDLE)!r} (want prepared)")
        else:
            self.states[epoch] = _FETCHED

    def commit(self, epoch: int) -> None:
        # the commit_next predicate: only the ring's next epoch commits
        if epoch != self.ring + 1:
            self._flag("stale-commit",
                       f"plan targets ring epoch {epoch} but the next "
                       f"epoch is {self.ring + 1} — a swap was dropped or "
                       f"the plan was committed twice")
            return
        state = self.states.get(epoch, _IDLE)
        if state == _COMMITTED:
            self._flag("double-commit", f"epoch {epoch} committed twice")
            return
        if state not in (_PREPARED, _FETCHED):
            self._flag("commit-unprepared",
                       f"commit for epoch {epoch} in state {state!r}")
        self.states[epoch] = _COMMITTED

    def serve(self, epoch: int) -> None:
        """Forward dispatch reading the pool that serves ``epoch``.

        The scheduler dispatches on the SHADOW pool just before
        publishing it, so both ``ring`` and ``ring + 1`` are legal."""
        if epoch not in (self.ring, self.ring + 1):
            self._flag("serve-unpublished",
                       f"forward reads epoch {epoch} but the ring is at "
                       f"{self.ring}")
        if epoch == self.ring + 1 and \
                self.states.get(epoch) != _COMMITTED:
            self._flag("serve-uncommitted",
                       f"forward reads epoch {epoch} before its plan "
                       f"committed (state "
                       f"{self.states.get(epoch, _IDLE)!r})")
        if self.states.get(epoch) == _COMMITTED:
            self.states[epoch] = _SERVING

    def swap(self) -> None:
        new = self.ring + 1
        if self.states.get(new, _IDLE) not in (_COMMITTED, _SERVING):
            self._flag("swap-uncommitted",
                       f"swap publishes epoch {new} whose plan never "
                       f"committed (state {self.states.get(new, _IDLE)!r})")
        self.ring = new

    def replay(self, events: Iterable[Tuple]) -> List[ProtocolViolation]:
        """Replay ``("prepare", e) / ("fetch", e) / ("commit", e) /
        ("serve", e) / ("swap",)`` tuples; returns all violations."""
        for event in events:
            name, args = event[0], event[1:]
            getattr(self, name)(*args)
        return self.violations


# ---------------------------------------------------------------------------
# Static call-graph validation of the real scheduler
# ---------------------------------------------------------------------------

# protocol-relevant callees inside PipelineScheduler.run, in source form
_CALL_EVENTS = {
    "prepare_next": "prepare",
    "fetch_next": "fetch",
    "commit_next": "commit",
    "forward": "serve",
    "swap": "swap",
}


class _CallOrder(ast.NodeVisitor):
    """Collect protocol calls in lexical order, inlining nested function
    defs (the worker-thread body) at their definition site — the thread
    is joined before any later protocol call, so lexical order IS the
    per-batch happens-before order."""

    def __init__(self):
        self.calls: List[str] = []

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        name = None
        if isinstance(func, ast.Attribute):
            name = func.attr
        elif isinstance(func, ast.Name):
            name = func.id
        if name in _CALL_EVENTS:
            self.calls.append(_CALL_EVENTS[name])
        self.generic_visit(node)


def extract_scheduler_events(source: Optional[str] = None) -> List[str]:
    """The per-batch protocol-call sequence of ``PipelineScheduler.run``
    (worker body inlined lexically).  ``source`` overrides the real
    class source for tests."""
    if source is None:
        from repro_torch.pipeline.scheduler import PipelineScheduler
        source = inspect.getsource(PipelineScheduler.run)
    tree = ast.parse(textwrap.dedent(source))
    visitor = _CallOrder()
    visitor.visit(tree)
    return visitor.calls


def check_scheduler_source(
        source: Optional[str] = None,
        batches: int = 3) -> List[ProtocolViolation]:
    """Statically validate the scheduler's protocol-call order.

    Extracts the per-batch call sequence from the ``run`` source and
    replays it ``batches`` times through :class:`EpochReplay`, stamping
    each batch's plan with the epoch ``prepare_next`` would
    (``ring + 1`` at prepare time).  Any reordering that breaks the
    epoch protocol — commit after swap, missing swap, double commit —
    surfaces as violations.
    """
    calls = extract_scheduler_events(source)
    required = ("prepare", "fetch", "commit", "serve", "swap")
    missing = [c for c in required if c not in calls]
    if missing:
        return [ProtocolViolation(
            "missing-stage",
            f"scheduler source never calls {missing} "
            f"(found sequence: {calls})")]
    replay = EpochReplay()
    for _ in range(batches):
        epoch = replay.ring + 1       # what prepare_next would stamp
        for call in calls:
            if call == "swap":
                replay.swap()
            else:
                getattr(replay, call)(epoch)
    return replay.violations


# ---------------------------------------------------------------------------
# Happens-before validation of recorded timelines
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TimelineSpan:
    stage: str
    batch: int
    start: float
    end: float


def _overlaps(a: TimelineSpan, b: TimelineSpan) -> bool:
    return min(a.end, b.end) > max(a.start, b.start)


def check_timeline(spans: Sequence, depth: int = 2,
                   ) -> List[ProtocolViolation]:
    """Happens-before validation of a recorded stage timeline.

    Writes are ``scatter`` spans (batch j scatters into ring slot
    ``(j+1) % depth``); reads are ``forward`` spans (batch k's forward
    reads the slot it was committed into, also ``(k+1) % depth``).  Two
    rules:

      1. no cross-batch write/read overlap on the SAME ring slot —
         batch j's shadow scatter must not run while batch k's forward
         (j != k) reads that buffer;
      2. a batch's own scatter fully precedes its forward dispatch.

    ``spans`` accepts :class:`~repro_torch.pipeline.scheduler.StageSpan`,
    :class:`TimelineSpan`, or dicts with the same fields.  Serialized
    (depth-1) engines are degenerate: every span shares slot 0 but the
    schedule is strictly ordered, so a clean serialized trace passes.
    """
    norm: List[TimelineSpan] = []
    for s in spans:
        if isinstance(s, dict):
            norm.append(TimelineSpan(s["stage"], int(s["batch"]),
                                     float(s["start"]), float(s["end"])))
        else:
            norm.append(TimelineSpan(s.stage, s.batch, s.start, s.end))

    def slot(batch: int) -> int:
        return (batch + 1) % depth if depth > 1 else 0

    writes = [s for s in norm if s.stage == "scatter"]
    reads = [s for s in norm if s.stage == "forward"]
    violations: List[ProtocolViolation] = []
    for w in writes:
        for r in reads:
            if w.batch == r.batch:
                # Ordering, not overlap: a scatter that starts after its
                # own forward already ended is just as broken.
                if w.end > r.start:
                    violations.append(ProtocolViolation(
                        "scatter-after-dispatch",
                        f"batch {w.batch}'s scatter "
                        f"[{w.start:.6f}, {w.end:.6f}] does not complete "
                        f"before its own forward dispatched at "
                        f"{r.start:.6f}"))
                continue
            if slot(w.batch) == slot(r.batch) and _overlaps(w, r):
                violations.append(ProtocolViolation(
                    "buffer-race",
                    f"batch {w.batch}'s scatter into ring slot "
                    f"{slot(w.batch)} [{w.start:.6f}, {w.end:.6f}] "
                    f"overlaps batch {r.batch}'s forward reading the "
                    f"same slot [{r.start:.6f}, {r.end:.6f}]"))
    return violations


def load_timeline(path: str) -> Tuple[List[TimelineSpan], int]:
    """Load a stage-trace JSON artifact (the reference's
    ``pipeline_sweep.py --stage-trace`` format): ``{"schema_version": 1,
    "depth": D, "spans": [{stage, batch, start, end}, ...]}``.  Returns
    (spans, depth)."""
    with open(path) as fh:
        payload = json.load(fh)
    version = payload.get("schema_version")
    if version != 1:
        raise ValueError(f"unknown stage-trace schema_version {version!r}")
    spans = [TimelineSpan(s["stage"], int(s["batch"]),
                          float(s["start"]), float(s["end"]))
             for s in payload["spans"]]
    return spans, int(payload.get("depth", 2))
