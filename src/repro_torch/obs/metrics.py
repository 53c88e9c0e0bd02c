"""``MetricsRegistry`` — counters, gauges, and streaming histograms.

The counterpart of ``repro.obs.metrics``, the same instruments and the
same ``snapshot()`` schema.  The paper's contribution is per-phase
*measurement*; this module is the port's one place such measurements
accumulate.  Three instrument kinds:

  * :class:`Counter`   — monotone int (events, bytes moved);
  * :class:`Gauge`     — last-written float (pool bytes, queue depth);
  * :class:`Histogram` — log-bucketed streaming distribution with
    p50/p95/p99 (request latency, span durations).  Buckets are
    geometric (``buckets_per_decade`` per power of ten), so a single
    fixed-size int array covers 100 ns .. 10 ks latencies at ~26%
    relative quantile error worst-case — the classic HDR trade.

Every instrument is get-or-create by name through the registry, and
``snapshot()`` serializes the whole registry under a versioned schema
(``MetricsRegistry.SCHEMA_VERSION``) so artifacts stay machine-comparable
across commits, and across the two packages.  External
stats records join the same snapshot as *producers*:
``register_producer("dlrm.cache", stats.as_dict)`` absorbs a
:class:`repro_torch.cache.stats.CacheStats` (its own ``schema_version`` rides along
inside the producer's dict — the registry never re-interprets it).

Thread model: instruments are updated from the serving thread (both
engines score on the main thread); the pipeline's background prefetch
threads write to the :class:`~repro_torch.obs.trace.Tracer` (which locks)
and to the pipeline's per-stage windowed histograms.
"""
from __future__ import annotations

import math
from typing import Callable, Dict


class Counter:
    """Monotone event/byte counter."""

    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = "1"):
        self.name, self.unit = name, unit
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease by {n}")
        self.value += int(n)

    def to_dict(self) -> Dict[str, object]:
        return {"unit": self.unit, "value": self.value}


class Gauge:
    """Last-written instantaneous value."""

    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = "1"):
        self.name, self.unit = name, unit
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_dict(self) -> Dict[str, object]:
        return {"unit": self.unit, "value": self.value}


class LogBuckets:
    """Shared geometric bucket layout for the streaming histograms.

    Bucket ``i`` (1-based interior) covers
    ``[lo * 10^((i-1)/bpd), lo * 10^(i/bpd))``; bucket 0 is the
    underflow sink (``v <= lo``) and the last bucket the overflow sink.
    :class:`Histogram` (cumulative) and
    :class:`repro_torch.obs.timeseries.WindowedHistogram` (ring-buffered) use
    the SAME layout and the SAME quantile walk, so a windowed quantile
    is exactly the cumulative quantile of the window's observations —
    the brute-force property the timeseries tests pin.
    """

    __slots__ = ("lo", "bpd", "_log_lo", "n")

    def __init__(self, lo: float = 1e-7, hi: float = 1e4,
                 buckets_per_decade: int = 10):
        if lo <= 0 or hi <= lo:
            raise ValueError(f"need 0 < lo < hi, got lo={lo}, hi={hi}")
        self.lo, self.bpd = lo, buckets_per_decade
        self._log_lo = math.log10(lo)
        interior = int(math.ceil((math.log10(hi) - self._log_lo)
                                 * buckets_per_decade))
        self.n = interior + 2               # + underflow + overflow

    def index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = 1 + int((math.log10(v) - self._log_lo) * self.bpd)
        return min(i, self.n - 1)

    def edge(self, i: int) -> float:
        """Left edge of interior bucket ``i`` (1-based)."""
        return self.lo * 10.0 ** ((i - 1) / self.bpd)

    def quantile(self, counts, count: int, q: float, vmin: float,
                 vmax: float) -> float:
        """Cumulative walk over ``counts``; the target bucket reports
        its geometric midpoint clamped into the observed ``[vmin, vmax]``
        — so the tails never report values that were never seen."""
        if count == 0:
            return 0.0
        target = q * count
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c:
                if i == 0:
                    return vmin
                if i == self.n - 1:
                    return vmax
                mid = self.edge(i) * 10.0 ** (0.5 / self.bpd)
                return min(max(mid, vmin), vmax)
        return vmax


class Histogram:
    """Log-bucketed streaming histogram with quantile readout (see
    :class:`LogBuckets` for the bucket/quantile contract)."""

    __slots__ = ("name", "unit", "_b", "_counts",
                 "count", "total", "min", "max")

    def __init__(self, name: str, unit: str = "s", *, lo: float = 1e-7,
                 hi: float = 1e4, buckets_per_decade: int = 10):
        self.name, self.unit = name, unit
        self._b = LogBuckets(lo, hi, buckets_per_decade)
        self._counts = [0] * self._b.n
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v) or v < 0:
            raise ValueError(
                f"histogram {self.name!r}: need a finite value >= 0, "
                f"got {v}")
        self._counts[self._b.index(v)] += 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        """q in [0, 1] -> value estimate (0.0 on an empty histogram)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        return self._b.quantile(self._counts, self.count, q,
                                self.min, self.max)

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p95(self) -> float:
        return self.quantile(0.95)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_dict(self) -> Dict[str, object]:
        return {
            "unit": self.unit,
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean,
            "p50": self.p50,
            "p95": self.p95,
            "p99": self.p99,
        }


class MetricsRegistry:
    """Get-or-create instrument namespace with a versioned snapshot.

    Beyond the cumulative instruments above, the registry hosts the
    WINDOWED kinds from :mod:`repro_torch.obs.timeseries` — ring-buffered
    histograms/counters whose readout covers only the last ``window``
    ticks, and per-element EWMA series.  ``rotate_windows(prefix)``
    advances every windowed instrument under a name prefix by one tick
    — engines call it once per scored micro-batch
    (:meth:`repro_torch.obs.Telemetry.batch_tick`), scoped by their
    ``<obs_name>.`` prefix so two engines sharing one registry never
    cross-rotate each other's windows.
    """

    # bump when snapshot() keys change meaning or spelling, in step with
    # the reference: snapshot artifacts key off this contract.
    # v2: windowed/rolling/ewma sections (obs.timeseries)
    SCHEMA_VERSION = 2

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._windowed: Dict[str, object] = {}
        self._rolling: Dict[str, object] = {}
        self._ewma: Dict[str, object] = {}
        self._producers: Dict[str, Callable[[], Dict]] = {}

    def _get(self, table: Dict, cls, name: str, unit: str, **kw):
        inst = table.get(name)
        if inst is None:
            inst = table[name] = cls(name, unit, **kw)
        elif inst.unit != unit:
            raise ValueError(
                f"{cls.__name__} {name!r} already registered with unit "
                f"{inst.unit!r} (asked for {unit!r})")
        return inst

    def counter(self, name: str, unit: str = "1") -> Counter:
        return self._get(self._counters, Counter, name, unit)

    def gauge(self, name: str, unit: str = "1") -> Gauge:
        return self._get(self._gauges, Gauge, name, unit)

    def histogram(self, name: str, unit: str = "s", *, lo: float = 1e-7,
                  hi: float = 1e4,
                  buckets_per_decade: int = 10) -> Histogram:
        return self._get(self._histograms, Histogram, name, unit, lo=lo,
                         hi=hi, buckets_per_decade=buckets_per_decade)

    # -- windowed instruments (obs.timeseries) --------------------------------

    def windowed_histogram(self, name: str, unit: str = "s", *,
                           window: int = 32, lo: float = 1e-7,
                           hi: float = 1e4, buckets_per_decade: int = 10):
        from repro_torch.obs.timeseries import WindowedHistogram

        inst = self._get(self._windowed, WindowedHistogram, name, unit,
                         window=window, lo=lo, hi=hi,
                         buckets_per_decade=buckets_per_decade)
        if inst.window != window:
            raise ValueError(
                f"WindowedHistogram {name!r} already registered with "
                f"window {inst.window} (asked for {window})")
        return inst

    def rolling_counter(self, name: str, unit: str = "1", *,
                        window: int = 32):
        from repro_torch.obs.timeseries import RollingCounter

        inst = self._get(self._rolling, RollingCounter, name, unit,
                         window=window)
        if inst.window != window:
            raise ValueError(
                f"RollingCounter {name!r} already registered with "
                f"window {inst.window} (asked for {window})")
        return inst

    def ewma(self, name: str, unit: str = "1", *, alpha: float = 0.25):
        from repro_torch.obs.timeseries import EwmaSeries

        inst = self._get(self._ewma, EwmaSeries, name, unit, alpha=alpha)
        if inst.alpha != alpha:
            raise ValueError(
                f"EwmaSeries {name!r} already registered with alpha "
                f"{inst.alpha} (asked for {alpha})")
        return inst

    def rotate_windows(self, prefix: str = "") -> int:
        """Advance every windowed instrument whose name starts with
        ``prefix`` by one tick (EWMA series are time-decayed, not
        windowed — they never rotate); returns the number rotated."""
        n = 0
        for table in (self._windowed, self._rolling):
            for name, inst in table.items():
                if name.startswith(prefix):
                    inst.rotate()
                    n += 1
        return n

    def register_producer(self, prefix: str, fn: Callable[[], Dict], *,
                          replace: bool = False) -> None:
        """Attach an external stats source (e.g. ``CacheStats.as_dict``);
        its dict lands verbatim under ``snapshot()["producers"][prefix]``.

        Duplicate prefixes raise unless ``replace=True`` — engines pass
        it so rebuilding an engine under one long-lived Telemetry simply
        repoints the prefix at the live stats record."""
        if prefix in self._producers and not replace:
            raise ValueError(f"producer {prefix!r} already registered")
        self._producers[prefix] = fn

    @property
    def observation_count(self) -> int:
        """Total histogram observations (the overhead model's op count)."""
        return sum(h.count for h in self._histograms.values())

    def windowed_op_counts(self) -> Dict[str, int]:
        """Lifetime op counts of the windowed instruments, split by kind
        — the inputs of an overhead projection (each multiplied by a
        microbenchmarked per-op cost):

          * ``observe`` — WindowedHistogram observations;
          * ``inc``     — RollingCounter increments;
          * ``rotate``  — window rotations across both windowed kinds;
          * ``ewma``    — per-ELEMENT EwmaSeries updates.
        """
        return {
            "observe": sum(w.lifetime_count
                           for w in self._windowed.values()),
            "inc": sum(c.ops for c in self._rolling.values()),
            "rotate": (sum(w.rotations for w in self._windowed.values())
                       + sum(c.rotations for c in self._rolling.values())),
            "ewma": sum(e.update_ops for e in self._ewma.values()),
        }

    def snapshot(self) -> Dict[str, object]:
        """One stable, JSON-serializable view of every instrument."""
        return {
            "schema_version": self.SCHEMA_VERSION,
            "counters": {k: v.to_dict()
                         for k, v in sorted(self._counters.items())},
            "gauges": {k: v.to_dict()
                       for k, v in sorted(self._gauges.items())},
            "histograms": {k: v.to_dict()
                           for k, v in sorted(self._histograms.items())},
            "windowed": {k: v.to_dict()
                         for k, v in sorted(self._windowed.items())},
            "rolling": {k: v.to_dict()
                        for k, v in sorted(self._rolling.items())},
            "ewma": {k: v.to_dict()
                     for k, v in sorted(self._ewma.items())},
            "producers": {k: fn()
                          for k, fn in sorted(self._producers.items())},
        }
