"""``repro_torch.obs`` — the unified telemetry subsystem.

The counterpart of ``repro.obs``; its BenchRecord gate is
:mod:`repro_torch.obs.bench` (``python -m repro_torch.obs.bench
compare|bless``), which, as in the reference, this package does not
re-export.  One bundle (:class:`Telemetry`) carries the two halves of
observability:

  * :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters, gauges,
    and log-bucketed latency histograms (p50/p95/p99) behind one
    versioned ``snapshot()`` schema; external records like the cache's
    ``CacheStats`` join as producers.
  * :class:`~repro_torch.obs.trace.Tracer` — every engine stage span,
    pipeline ``StageSpan``, per-request enqueue->score latency span, and
    timestamped ``CollectiveEvent`` merged onto ONE ``perf_counter``
    timeline, exportable as Chrome trace-event / Perfetto JSON and
    projectable onto ``perf_model.calibrate``'s ``StageSample`` inputs.

Wiring: pass ``telemetry=Telemetry()`` to
:func:`repro_torch.serving.engine.make_dlrm_engine` (either engine
class).  The engine stamps request enqueue times at ``submit``, records
prefetch/forward spans at ``flush``, attaches the tracer to its
``CachedEmbeddingBag`` (cache-lane spans) and its ``PipelineTrace``
(pipeline-lane spans), and registers its ``CacheStats`` as a metrics
producer.  ``telemetry.tracer.install_comm_sink()`` additionally lands
``comm.fetch_rows`` collective events on the comm lane.  Every span is
on the host clock (see ``Tracer.stage_samples`` for what that covers on
a card).
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.obs.export import SweepReport, provenance, write_snapshot
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, LogBuckets,
                               MetricsRegistry)
from repro_torch.obs.slo import (DriftDetector, SLOEvent, SLOMonitor, SLOPolicy,
                           expected_hit_rates)
from repro_torch.obs.timeseries import (EwmaSeries, RollingCounter,
                                  WindowedHistogram)
from repro_torch.obs.trace import LANES, Span, Tracer, validate_chrome_trace

__all__ = [
    "Counter", "Gauge", "Histogram", "LogBuckets", "MetricsRegistry",
    "WindowedHistogram", "RollingCounter", "EwmaSeries",
    "SLOPolicy", "SLOEvent", "SLOMonitor", "DriftDetector",
    "expected_hit_rates",
    "LANES", "Span", "Tracer", "validate_chrome_trace",
    "SweepReport", "provenance", "write_snapshot", "Telemetry",
]


class Telemetry:
    """One metrics registry + one tracer, wired together.

    The request-latency path: engines call :meth:`record_request` when a
    request's score materializes — one span on the request lane AND one
    observation in the ``<engine>.request_latency_s`` histogram, so both
    the timeline and the p50/p99 readout see the same interval.

    Windowed time: ``window`` sizes every windowed instrument the
    engines create (ticks, one per scored micro-batch).  Engines call
    :meth:`batch_tick` after scoring a micro-batch; the bundle notifies
    registered listeners (``obs.slo`` monitors — they read the
    just-completed window) and THEN rotates every windowed instrument
    under the engine's name prefix, so two engines sharing one bundle
    never cross-rotate.
    """

    def __init__(self, *, enabled: bool = True, window: int = 32):
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(enabled=enabled)
        self.window = window
        self._tick_listeners = []
        self._ticks: dict = {}

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled

    def record_request(self, engine: str, rid: int, t_enqueue: float,
                       t_scored: float) -> None:
        """One request's enqueue -> score interval (perf_counter stamps)."""
        self.tracer.add_span(
            "request", t_enqueue, t_scored, lane="request", cat="request",
            args={"rid": rid, "engine": engine})
        self.metrics.histogram(
            f"{engine}.request_latency_s", unit="s").observe(
                max(0.0, t_scored - t_enqueue))

    # -- windowed time -------------------------------------------------------

    def add_tick_listener(self, fn) -> None:
        """Register ``fn(engine, tick)``, called on every
        :meth:`batch_tick` BEFORE the window rotates (the listener sees
        the completed window's instruments)."""
        self._tick_listeners.append(fn)

    def ticks(self, engine: str) -> int:
        """Micro-batches ticked so far for ``engine``."""
        return self._ticks.get(engine, 0)

    def batch_tick(self, engine: str) -> int:
        """One scored micro-batch for ``engine``: notify listeners,
        then rotate every ``<engine>.``-prefixed windowed instrument;
        returns the tick count."""
        k = self._ticks.get(engine, 0) + 1
        self._ticks[engine] = k
        for fn in list(self._tick_listeners):
            fn(engine, k)
        self.metrics.rotate_windows(prefix=f"{engine}.")
        return k

    def request_latency(self, engine: str):
        """The engine's latency histogram (creates it if unseen)."""
        return self.metrics.histogram(f"{engine}.request_latency_s",
                                      unit="s")

    def export_trace(self, path: str) -> str:
        return self.tracer.export(path)

    @staticmethod
    def now() -> float:
        return time.perf_counter()
