"""Windowed time-series instruments — the LIVE half of observability.

The counterpart of ``repro.obs.timeseries``.  The cumulative
:class:`~repro_torch.obs.metrics.MetricsRegistry` instruments give one
number per run, read post-hoc.  Online control loops (SLO monitoring,
drift-triggered re-planning — the ROADMAP's drift-adaptive serving item)
need the *recent* value instead: p99 over the last N micro-batches,
per-table hit rate over the last window, queue depth right now.  Three
windowed kinds live here, all registered get-or-create through the
registry and all advanced by ``MetricsRegistry.rotate_windows(prefix)``
(one *tick* = one scored micro-batch — engines tick via
:meth:`repro_torch.obs.Telemetry.batch_tick`):

  * :class:`WindowedHistogram` — a ring of per-tick sparse bucket
    deltas over the SAME :class:`~repro_torch.obs.metrics.LogBuckets` layout
    as the cumulative histogram, plus an incrementally-maintained
    aggregate bucket array.  ``observe``/``rotate`` are O(1) in the
    window length and observation count (rotation subtracts one tick's
    sparse delta); quantiles over the window are EXACTLY what a fresh
    cumulative histogram of the window's observations would report —
    the brute-force equivalence the timeseries tests pin.
  * :class:`RollingCounter` — windowed event/byte totals (window hit
    and lookup counts, whose ratio is the windowed hit rate).
  * :class:`EwmaSeries` — per-element exponentially-weighted averages,
    e.g. the per-table ``hit_rate_t`` the drift detector compares
    against each ``Placement.est_hit_rate``.  Mask-aware: a table with
    no traffic in a window keeps its previous estimate (no decay toward
    stale zeros).  EWMAs are time-decayed, not windowed — they never
    rotate.

Thread model matches the registry: windowed instruments are updated
from the serving thread only.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, Optional

import numpy as np

from repro_torch.obs.metrics import LogBuckets


class _Tick:
    """One tick's observation delta inside a WindowedHistogram ring."""

    __slots__ = ("buckets", "count", "total", "min", "max")

    def __init__(self):
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf


class WindowedHistogram:
    """Log-bucketed histogram whose readout covers the last ``window``
    ticks (the ``window - 1`` most recent CLOSED ticks plus the open
    one).  ``rotate()`` closes the open tick; an observation therefore
    survives exactly ``window`` rotations after the one that closed its
    tick."""

    __slots__ = ("name", "unit", "window", "_b", "_agg", "_closed",
                 "_cur", "count", "total", "lifetime_count", "rotations")

    def __init__(self, name: str, unit: str = "s", *, window: int = 32,
                 lo: float = 1e-7, hi: float = 1e4,
                 buckets_per_decade: int = 10):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.name, self.unit, self.window = name, unit, window
        self._b = LogBuckets(lo, hi, buckets_per_decade)
        self._agg = [0] * self._b.n         # sum of the ring's deltas
        self._closed: collections.deque = collections.deque()
        self._cur = _Tick()
        self.count = 0                      # windowed observation count
        self.total = 0.0                    # windowed sum
        self.lifetime_count = 0             # never evicted (op counting)
        self.rotations = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v) or v < 0:
            raise ValueError(
                f"windowed histogram {self.name!r}: need a finite value "
                f">= 0, got {v}")
        i = self._b.index(v)
        cur = self._cur
        cur.buckets[i] = cur.buckets.get(i, 0) + 1
        cur.count += 1
        cur.total += v
        cur.min = min(cur.min, v)
        cur.max = max(cur.max, v)
        self._agg[i] += 1
        self.count += 1
        self.total += v
        self.lifetime_count += 1

    def rotate(self) -> None:
        """Close the open tick; evict the oldest once the ring is full.

        O(distinct buckets in the evicted tick) — independent of the
        window length and of how many observations the window holds."""
        self.rotations += 1
        self._closed.append(self._cur)
        self._cur = _Tick()
        while len(self._closed) > self.window - 1:
            old = self._closed.popleft()
            for i, c in old.buckets.items():
                self._agg[i] -= c
            self.count -= old.count
            self.total -= old.total

    # -- windowed readout ----------------------------------------------------

    @property
    def min(self) -> float:
        ticks = [t.min for t in self._closed if t.count]
        if self._cur.count:
            ticks.append(self._cur.min)
        return min(ticks) if ticks else math.inf

    @property
    def max(self) -> float:
        ticks = [t.max for t in self._closed if t.count]
        if self._cur.count:
            ticks.append(self._cur.max)
        return max(ticks) if ticks else -math.inf

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """q in [0, 1] -> windowed value estimate (0.0 when empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        return self._b.quantile(self._agg, self.count, q,
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
    def ticks(self) -> int:
        """Ticks currently inside the window (open tick included)."""
        return len(self._closed) + 1

    def to_dict(self) -> Dict[str, object]:
        return {
            "unit": self.unit,
            "window": self.window,
            "ticks": self.ticks,
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean,
            "p50": self.p50,
            "p95": self.p95,
            "p99": self.p99,
            "lifetime_count": self.lifetime_count,
            "rotations": self.rotations,
        }


class RollingCounter:
    """Windowed event/byte totals: ``total`` sums the last ``window``
    ticks (same open-tick semantics as :class:`WindowedHistogram`)."""

    __slots__ = ("name", "unit", "window", "_closed", "_cur", "total",
                 "lifetime_total", "ops", "rotations")

    def __init__(self, name: str, unit: str = "1", *, window: int = 32):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.name, self.unit, self.window = name, unit, window
        self._closed: collections.deque = collections.deque()
        self._cur = 0
        self.total = 0                      # windowed total
        self.lifetime_total = 0
        self.ops = 0                        # inc() calls (op counting)
        self.rotations = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(
                f"rolling counter {self.name!r} cannot decrease by {n}")
        self._cur += int(n)
        self.total += int(n)
        self.lifetime_total += int(n)
        self.ops += 1

    def rotate(self) -> None:
        self.rotations += 1
        self._closed.append(self._cur)
        self._cur = 0
        while len(self._closed) > self.window - 1:
            self.total -= self._closed.popleft()

    @property
    def ticks(self) -> int:
        return len(self._closed) + 1

    @property
    def rate(self) -> float:
        """Mean per-tick total over the window."""
        return self.total / self.ticks

    def to_dict(self) -> Dict[str, object]:
        return {
            "unit": self.unit,
            "window": self.window,
            "ticks": self.ticks,
            "total": self.total,
            "rate": self.rate,
            "lifetime_total": self.lifetime_total,
        }


class EwmaSeries:
    """Per-element exponentially-weighted moving averages (lazy shape).

    ``update(x, mask=)`` folds a (T,) sample in: masked-out elements
    keep their previous value AND their update count (a table with no
    lookups this window contributes no evidence), first-ever updates
    set the value directly (no bias toward an arbitrary init)."""

    __slots__ = ("name", "unit", "alpha", "values", "updates",
                 "update_ops")

    def __init__(self, name: str, unit: str = "1", *,
                 alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.name, self.unit, self.alpha = name, unit, alpha
        self.values: Optional[np.ndarray] = None
        self.updates: Optional[np.ndarray] = None
        self.update_ops = 0                 # element updates (op counting)

    def update(self, x, mask=None) -> None:
        x = np.asarray(x, np.float64)
        if x.ndim != 1:
            raise ValueError(
                f"ewma {self.name!r}: need a 1-D sample, got {x.shape}")
        if self.values is None:
            self.values = np.zeros(x.shape, np.float64)
            self.updates = np.zeros(x.shape, np.int64)
        elif self.values.shape != x.shape:
            raise ValueError(
                f"ewma {self.name!r}: sample shape {x.shape} does not "
                f"match the series shape {self.values.shape}")
        m = np.ones(x.shape, bool) if mask is None \
            else np.asarray(mask, bool)
        if m.shape != x.shape:
            raise ValueError(
                f"ewma {self.name!r}: mask shape {m.shape} does not "
                f"match the sample shape {x.shape}")
        first = m & (self.updates == 0)
        rest = m & ~first
        self.values[first] = x[first]
        self.values[rest] += self.alpha * (x[rest] - self.values[rest])
        self.updates[m] += 1
        self.update_ops += int(m.sum())

    def get(self) -> Optional[np.ndarray]:
        """Copy of the current (T,) estimates (None before any update)."""
        return None if self.values is None else self.values.copy()

    def to_dict(self) -> Dict[str, object]:
        return {
            "unit": self.unit,
            "alpha": self.alpha,
            "n": 0 if self.values is None else int(self.values.size),
            "updates": (0 if self.updates is None
                        else int(self.updates.sum())),
            "values": (None if self.values is None
                       else [round(float(v), 6) for v in self.values]),
        }
