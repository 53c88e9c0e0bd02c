"""SLO monitoring and plan-drift detection over the windowed metrics.

The counterpart of ``repro.obs.slo``: the same rules, events and firing
ticks on the same instrument readings.

Production DLRM serving is governed by tail-latency SLAs (Lui et al.,
capacity-driven scale-out inference), not run averages — so the policy
surface here is declarative per-window bounds over the LIVE instruments
of :mod:`repro_torch.obs.timeseries`:

  * :class:`SLOPolicy` — p99 latency budget, windowed hit-rate floor,
    queue-depth cap; any bound left ``None`` is unchecked.
  * :class:`SLOMonitor` — evaluates a policy against one engine's
    windowed instruments on every ``batch_tick`` (listener-registered;
    evaluation sees the just-completed window BEFORE rotation), appends
    a structured :class:`SLOEvent` per violated rule, and mirrors each
    event as a zero-duration span onto the tracer's "slo" lane — breach
    timing lands on the SAME merged timeline as the engine/pipeline
    spans that explain it.
  * :class:`DriftDetector` — the re-planning trigger signal: compares
    the measured per-table EWMA ``<engine>.hit_rate_t`` against the
    sharding plan's per-table ``Placement.est_hit_rate`` and fires (one
    event per table, on the transition into drift) when the two diverge
    beyond ``threshold``.  A detector firing means the traffic no
    longer matches the distribution the planner priced — exactly when
    the ROADMAP's online re-planner must wake up.

Event cadence: one tick = one scored micro-batch (the engines'
``batch_tick`` unit); ``stride`` evaluates every k-th tick when
per-batch evaluation is too chatty.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

SLO_EVENT_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Declarative per-window serving objectives (None = unchecked).

    ``min_window_count`` / ``min_window_lookups`` gate evaluation on
    evidence: a window with fewer latency observations (resp. cache
    lookups) than the floor is skipped for that rule — a near-empty
    window's p99 is noise, not a breach.
    """

    name: str = "default"
    p99_budget_s: Optional[float] = None
    hit_rate_floor: Optional[float] = None
    queue_depth_cap: Optional[float] = None
    min_window_count: int = 1
    min_window_lookups: int = 1


@dataclasses.dataclass(frozen=True)
class SLOEvent:
    """One structured breach/drift record (also the "slo" span args)."""

    kind: str                   # "breach" | "drift"
    rule: str                   # "p99" | "hit_rate" | "queue_depth" |
    #                             "hit_rate_drift"
    tick: int                   # batch_tick count at evaluation
    engine: str
    measured: float
    threshold: float            # the violated bound (drift: allowed |dev|)
    table: Optional[int] = None
    expected: Optional[float] = None   # drift: the plan's est_hit_rate

    def to_dict(self) -> Dict[str, object]:
        d = {
            "schema_version": SLO_EVENT_SCHEMA_VERSION,
            "kind": self.kind,
            "rule": self.rule,
            "tick": self.tick,
            "engine": self.engine,
            "measured": round(float(self.measured), 6),
            "threshold": float(self.threshold),
        }
        if self.table is not None:
            d["table"] = int(self.table)
        if self.expected is not None:
            d["expected"] = round(float(self.expected), 6)
        return d


class SLOMonitor:
    """Per-window policy evaluation over one engine's live instruments.

    Construction registers the monitor as a ``batch_tick`` listener on
    the telemetry bundle; every ``stride``-th tick it reads the
    engine's windowed instruments (created on first use, so attaching
    before the first flush is safe) and appends one :class:`SLOEvent`
    per violated rule.
    """

    def __init__(self, telemetry, policy: SLOPolicy, *,
                 engine: str = "dlrm", stride: int = 1):
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        self.telemetry = telemetry
        self.policy = policy
        self.engine = engine
        self.stride = stride
        self.events: List[SLOEvent] = []
        self.windows_evaluated = 0
        self.worst_p99_s = 0.0
        telemetry.add_tick_listener(self._on_tick)

    # -- instrument lookups (same get-or-create names the engine feeds) ------

    def _latency(self):
        return self.telemetry.metrics.windowed_histogram(
            f"{self.engine}.request_latency_s", unit="s",
            window=self.telemetry.window)

    def _depth(self):
        return self.telemetry.metrics.windowed_histogram(
            f"{self.engine}.queue_depth", unit="1",
            window=self.telemetry.window, lo=0.5, hi=1e7,
            buckets_per_decade=5)

    def _window_hit_rate(self) -> Optional[float]:
        m = self.telemetry.metrics
        w = self.telemetry.window
        hits = m.rolling_counter(f"{self.engine}.window.hits", window=w)
        lookups = m.rolling_counter(f"{self.engine}.window.lookups",
                                    window=w)
        if lookups.total < self.policy.min_window_lookups:
            return None
        return hits.total / lookups.total

    # -- evaluation ----------------------------------------------------------

    def _emit(self, rule: str, tick: int, measured: float,
              threshold: float) -> None:
        ev = SLOEvent("breach", rule, tick, self.engine,
                      measured, threshold)
        self.events.append(ev)
        t = self.telemetry.tracer.now()
        self.telemetry.tracer.add_span(f"slo.{rule}", t, t, lane="slo",
                                       cat="slo", args=ev.to_dict())

    def _on_tick(self, engine: str, tick: int) -> None:
        if engine != self.engine or tick % self.stride:
            return
        self.windows_evaluated += 1
        pol = self.policy
        lat = self._latency()
        if lat.count >= pol.min_window_count:
            p99 = lat.p99
            self.worst_p99_s = max(self.worst_p99_s, p99)
            if pol.p99_budget_s is not None and p99 > pol.p99_budget_s:
                self._emit("p99", tick, p99, pol.p99_budget_s)
        if pol.hit_rate_floor is not None:
            rate = self._window_hit_rate()
            if rate is not None and rate < pol.hit_rate_floor:
                self._emit("hit_rate", tick, rate, pol.hit_rate_floor)
        if pol.queue_depth_cap is not None:
            depth = self._depth()
            if depth.count and depth.max > pol.queue_depth_cap:
                self._emit("queue_depth", tick, depth.max,
                           pol.queue_depth_cap)

    @property
    def breaches(self) -> int:
        return len(self.events)

    def summary(self) -> Dict[str, object]:
        """End-of-run rollup."""
        by_rule: Dict[str, int] = {}
        for ev in self.events:
            by_rule[ev.rule] = by_rule.get(ev.rule, 0) + 1
        return {
            "engine": self.engine,
            "policy": self.policy.name,
            "windows_evaluated": self.windows_evaluated,
            "breaches": self.breaches,
            "breaches_by_rule": by_rule,
            "worst_p99_s": self.worst_p99_s,
        }


class DriftDetector:
    """Flags divergence between the measured per-table EWMA hit rate
    and the sharding plan's priced ``est_hit_rate`` — the trigger
    signal online re-planning consumes.

    ``expected`` is the (T,) per-table estimate vector (build it from a
    plan with :func:`expected_hit_rates`).  A table drifts when its
    EWMA has at least ``min_updates`` worth of evidence and
    ``|measured - expected| > threshold``; one event fires per table on
    the TRANSITION into drift (re-armed when the table returns within
    threshold), so a persistently-drifted table does not flood the
    event log.
    """

    def __init__(self, telemetry, expected, *, engine: str = "dlrm",
                 threshold: float = 0.15, min_updates: int = 3,
                 stride: int = 1):
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.telemetry = telemetry
        self.expected = np.asarray(expected, np.float64)
        if self.expected.ndim != 1:
            raise ValueError(
                f"expected hit rates must be (T,), got "
                f"{self.expected.shape}")
        self.engine = engine
        self.threshold = threshold
        self.min_updates = min_updates
        self.stride = stride
        self.events: List[SLOEvent] = []
        self.drifted: set = set()
        self.first_detection_tick: Optional[int] = None
        telemetry.add_tick_listener(self._on_tick)

    def _on_tick(self, engine: str, tick: int) -> None:
        if engine != self.engine or tick % self.stride:
            return
        ewma = self.telemetry.metrics.ewma(f"{self.engine}.hit_rate_t")
        values = ewma.get()
        if values is None:
            return
        if values.shape != self.expected.shape:
            raise ValueError(
                f"drift detector: measured hit_rate_t shape "
                f"{values.shape} does not match the plan's "
                f"{self.expected.shape}")
        dev = np.abs(values - self.expected)
        enough = ewma.updates >= self.min_updates
        for t in np.nonzero(enough & (dev > self.threshold))[0]:
            t = int(t)
            if t in self.drifted:
                continue
            self.drifted.add(t)
            if self.first_detection_tick is None:
                self.first_detection_tick = tick
            ev = SLOEvent("drift", "hit_rate_drift", tick, self.engine,
                          float(values[t]), self.threshold, table=t,
                          expected=float(self.expected[t]))
            self.events.append(ev)
            now = self.telemetry.tracer.now()
            self.telemetry.tracer.add_span(
                "slo.hit_rate_drift", now, now, lane="slo", cat="slo",
                args=ev.to_dict())
        # re-arm tables that recovered to within threshold
        self.drifted -= {int(t) for t in
                         np.nonzero(enough & (dev <= self.threshold))[0]}

    def summary(self) -> Dict[str, object]:
        return {
            "engine": self.engine,
            "threshold": self.threshold,
            "tables_drifted": sorted(int(ev.table) for ev in self.events
                                     if ev.table is not None),
            "first_detection_tick": self.first_detection_tick,
            "events": len(self.events),
        }


def expected_hit_rates(plan, num_tables: int, *,
                       default: float = 1.0) -> np.ndarray:
    """(T,) per-table expected hit rates from a sharding plan.

    "cached" placements contribute their priced ``est_hit_rate``;
    every other placement kind (device-resident, host, remote) is a
    structural hit/miss the cache counters don't observe, so it keeps
    ``default`` — pair with a mask or a generous ``min_updates`` when
    only some tables are cached."""
    out = np.full(num_tables, float(default), np.float64)
    for p in plan.placements:
        if p.strategy == "cached" and p.cache_rows > 0:
            out[p.index] = float(p.est_hit_rate)
    return out
