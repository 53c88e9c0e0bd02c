"""``Tracer`` — one merged timeline, exportable as Chrome trace-event JSON.

The counterpart of ``repro.obs.trace``.  Three timing sources —
``CacheStats`` stage timers, the pipeline's ``StageSpan`` list, and
``comm`` collective events — would not share a clock alone.  The
tracer merges all of them onto ONE monotonic clock
(``time.perf_counter``, the clock every existing timer already uses) and
exports the result in the Chrome trace-event format, so a serving run
opens directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.

Lanes (Chrome ``tid``s inside one ``pid``):

  ======== ===========================================================
  lane     what lands there
  ======== ===========================================================
  engine   ``DLRMEngine.flush`` prefetch/forward spans
  pipeline mirrored ``PipelineTrace`` stage spans (admit/fetch/scatter/
           forward/swap) from the pipelined engine's scheduler
  request  per-request enqueue -> score latency spans
  cache    ``CachedEmbeddingBag`` admit/fetch/scatter spans (bytes in
           ``args``)
  comm     timestamped ``CollectiveEvent``s (``comm.fetch_rows`` etc.)
  slo      zero-duration SLO breach / drift events from
           ``obs.slo`` (the structured event dict in ``args``)
  ======== ===========================================================

Export schema: every event is a complete-event (``ph: "X"``) or
metadata (``ph: "M"``) record carrying ``ph/ts/dur/pid/tid/name`` —
``ts``/``dur`` in microseconds relative to the tracer's epoch, as the
format requires.  :func:`validate_chrome_trace` pins that contract (the
golden-schema test and ``chip_smoke.py`` both run it).

The tracer also closes the measurement loop back into the perf model:
:meth:`Tracer.stage_samples` projects cache spans and collective events
onto :class:`repro_torch.core.perf_model.StageSample`, the input of
``perf_model.calibrate`` — measured spans in, fitted ``Hardware`` out.

Threading: ``add_span`` locks, so the pipeline's background prefetch
threads and the main serving thread interleave safely on one timeline.

On the card every span stays on the host clock, as in the reference; a
span times what the host waits for, which is not always the device work
it names (see :meth:`Tracer.stage_samples`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Dict, Iterator, List, Optional

# lane name -> Chrome tid; the export emits one thread_name metadata
# record per lane so Perfetto labels the rows
LANES: Dict[str, int] = {
    "engine": 0,
    "pipeline": 1,
    "request": 2,
    "cache": 3,
    "comm": 4,
    "slo": 5,
}


@dataclasses.dataclass(frozen=True)
class Span:
    """One named interval on the merged timeline (perf_counter seconds)."""

    name: str
    t0: float
    t1: float
    lane: str = "engine"
    cat: str = ""
    args: Optional[Dict[str, object]] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def validate_chrome_trace(obj) -> int:
    """Assert ``obj`` is well-formed Chrome trace-event JSON; returns the
    event count.  Every event must carry valid ``ph``/``ts``/``dur``/
    ``pid``/``tid``/``name`` fields — the contract the golden-schema test
    and ``chip_smoke.py`` pin."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    for i, e in enumerate(events):
        for key in ("ph", "ts", "dur", "pid", "tid", "name"):
            if key not in e:
                raise ValueError(f"event {i} missing {key!r}: {e}")
        if e["ph"] not in ("X", "M"):
            raise ValueError(f"event {i} has unknown phase {e['ph']!r}")
        for key in ("ts", "dur"):
            v = e[key]
            if not isinstance(v, (int, float)) or v < 0:
                raise ValueError(f"event {i} has invalid {key}: {v!r}")
        for key in ("pid", "tid"):
            if not isinstance(e[key], int):
                raise ValueError(f"event {i} has non-int {key}: {e[key]!r}")
    return len(events)


class Tracer:
    """Process-wide span recorder on the ``perf_counter`` clock.

    ``enabled=False`` turns every record call into a no-op (the engines
    construct spans only when a tracer is attached, so disabled tracing
    costs one attribute check per call site).
    """

    def __init__(self, *, enabled: bool = True, pid: int = 0):
        self.enabled = enabled
        self.pid = pid
        self.epoch = time.perf_counter()   # ts origin of the export
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._prev_sink = None
        self._sink_installed = False

    # -- recording -----------------------------------------------------------

    @staticmethod
    def now() -> float:
        """The timeline's clock — use for spans recorded by hand."""
        return time.perf_counter()

    def add_span(self, name: str, t0: float, t1: float, *,
                 lane: str = "engine", cat: str = "",
                 args: Optional[Dict[str, object]] = None) -> None:
        if not self.enabled:
            return
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r}; one of {list(LANES)}")
        with self._lock:
            self._spans.append(Span(name, t0, t1, lane, cat, args))

    @contextlib.contextmanager
    def span(self, name: str, *, lane: str = "engine", cat: str = "",
             args: Optional[Dict[str, object]] = None) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_span(name, t0, time.perf_counter(), lane=lane,
                          cat=cat, args=args)

    def add_collective_event(self, ev, *, name: Optional[str] = None) -> bool:
        """Land one :class:`repro_torch.core.comm.CollectiveEvent` on the comm
        lane.  Events without wall-clock stamps (``t0 == t1 == 0.0``, the
        back-compat default) are skipped — returns whether it landed."""
        if not self.enabled or (ev.t0 == 0.0 and ev.t1 == 0.0):
            return False
        self.add_span(name or ev.op, ev.t0, ev.t1, lane="comm", cat="comm",
                      args={"bytes": ev.bytes_in, "axis_size": ev.axis_size,
                            "backend": ev.backend})
        return True

    # -- comm integration ----------------------------------------------------

    def install_comm_sink(self) -> None:
        """Route every ``comm`` collective event (including runtime
        ``fetch_rows`` records from background threads) onto this
        timeline until :meth:`remove_comm_sink`."""
        from repro_torch.core import comm

        if self._sink_installed:
            return
        self._prev_sink = comm.set_event_sink(self.add_collective_event)
        self._sink_installed = True

    def remove_comm_sink(self) -> None:
        from repro_torch.core import comm

        if self._sink_installed:
            comm.set_event_sink(self._prev_sink)
            self._prev_sink, self._sink_installed = None, False

    # -- readout -------------------------------------------------------------

    def spans(self, *, lane: Optional[str] = None,
              cat: Optional[str] = None,
              name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if lane is not None:
            out = [s for s in out if s.lane == lane]
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    @property
    def event_count(self) -> int:
        with self._lock:
            return len(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans = []

    def stage_samples(self, *, since: float = 0.0) -> List:
        """Project the timeline onto ``perf_model.StageSample`` records —
        the calibration input (``perf_model.calibrate(tracer)``).

          * cache spans (one prefetch = one ``seq``) -> stage "h2d": the
            wall-clock of moving that prefetch's missed-row payload onto
            the device.  With a host cold tier both the cold gather and
            the pool scatter cross host memory / the host link, so both
            spans count; with a remote cold tier the cold fetch is the
            collective (sampled separately below) and only the scatter
            is host-link work.
          * timestamped ``fetch_rows`` collective events -> stage
            "fetch_remote", with ``bytes`` the PER-HOST payload
            (``bytes_in`` of the stacked (E, M, D) contribution divided
            by the axis size — the miss payload the model charges).

        ``since`` filters to spans starting at or after that
        ``perf_counter`` stamp (sweeps use it to split train/held-out
        windows off one shared timeline).

        What the host-clock spans cover on a CUDA card (the port keeps
        the reference's definition and adds no device timing):

          * ``cache.fetch`` over the host tier is the gather from the
            host tables (CPU work);
          * ``cache.scatter`` is the pageable host-to-device copy of the
            fetched rows (synchronous for the host) and only the
            *dispatch* of the pool's ``index_copy_``, not its device
            time;
          * a remote ``fetch_rows`` event spans the put kernel, the sum
            over owners and the device-to-host copy of the payload
            (``RemoteStore.fetch`` brings the rows to the serving host),
            which the model's ``fetch_remote`` does not price.

        ``perf_model.calibrate`` fits whatever these cover.
        """
        from repro_torch.core.perf_model import StageSample

        groups: Dict[object, Dict[str, float]] = {}
        samples: List[StageSample] = []
        for s in self.spans():
            if s.t0 < since:
                continue
            if s.cat == "cache" and s.args and "seq" in s.args:
                tier = s.args.get("tier", "host")
                if s.name == "cache.fetch" and tier != "host":
                    continue      # the remote collective is sampled below
                g = groups.setdefault(s.args["seq"],
                                      {"t": 0.0, "bytes": 0.0})
                g["t"] += s.seconds
                g["bytes"] = max(g["bytes"],
                                 float(s.args.get("bytes", 0)))
            elif s.cat == "comm" and s.name == "fetch_rows" \
                    and s.t1 > s.t0 and s.args:
                n = int(s.args.get("axis_size", 1))
                if n > 1:
                    samples.append(StageSample(
                        "fetch_remote", s.seconds,
                        float(s.args.get("bytes", 0)) / n, n))
        samples.extend(
            StageSample("h2d", g["t"], g["bytes"])
            for g in groups.values() if g["bytes"] > 0 and g["t"] > 0)
        return samples

    # -- export --------------------------------------------------------------

    def to_chrome(self) -> Dict[str, object]:
        """The merged timeline as a Chrome trace-event object
        (``{"traceEvents": [...]}`` — load in Perfetto as-is)."""
        events: List[Dict[str, object]] = [
            {"ph": "M", "ts": 0, "dur": 0, "pid": self.pid, "tid": tid,
             "name": "thread_name", "args": {"name": lane}}
            for lane, tid in LANES.items()]
        for s in self.spans():
            ev = {
                "ph": "X",
                "ts": max(0.0, (s.t0 - self.epoch) * 1e6),
                "dur": max(0.0, (s.t1 - s.t0) * 1e6),
                "pid": self.pid,
                "tid": LANES[s.lane],
                "name": s.name,
            }
            if s.cat:
                ev["cat"] = s.cat
            if s.args:
                ev["args"] = dict(s.args)
            events.append(ev)
        return {"traceEvents": events,
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path``; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path

    def add_pipeline_trace(self, trace, *, label: str = "pipeline",
                           since: float = 0.0) -> int:
        """Mirror an un-attached :class:`repro_torch.pipeline.PipelineTrace`'s
        spans onto the pipeline lane (engines attach the tracer at
        construction instead — this is the offline path); returns the
        number of spans added."""
        n = 0
        for s in trace.spans:
            if s.start < since:
                continue
            self.add_span(f"pipeline.{s.stage}", s.start, s.end,
                          lane="pipeline", cat="pipeline",
                          args={"engine": label, "batch": s.batch})
            n += 1
        return n
