"""Cross-PR perf-regression gate: BenchRecord artifacts + comparison.

The counterpart of ``repro.obs.bench``, with the same schema
(``BENCH_SCHEMA_VERSION`` 1, the same keys) and the same
:func:`config_hash` (canonical JSON), so a config dict hashes alike in
both packages.  Two differences: provenance names the torch version
(``torch_version``), and the CLI's baselines live in the port's own
directory, :data:`DEFAULT_BASELINES`, never in ``benchmarks/baselines``
(the JAX package's CPU records, which a port ``bless`` must not
overwrite).

Before this module the sweeps' ``BENCH_*.json`` files were CI uploads
nobody compared — the perf trajectory existed but nothing checked it.
Three pieces close the loop:

  * :func:`make_bench_record` — ONE canonical JSON schema every sweep
    emits: sweep name, provenance (git sha, UTC timestamp, torch
    version), the sweep's config dict + its content hash, and a flat
    ``metric -> {value, unit, direction, tolerance}`` map.
  * :func:`compare_bench` — direction-aware per-metric comparison of a
    current record against a committed baseline
    (:data:`DEFAULT_BASELINES`).  Verdicts: ``improvement`` /
    ``within_tolerance`` / ``regression`` / ``missing_metric`` /
    ``new_metric`` / ``informational``; only regressions and missing
    metrics gate.  A config-hash mismatch fails the gate outright with
    a "re-bless" message — comparing runs of different shapes is not a
    perf signal.
  * the CLI (``python -m repro_torch.obs.bench compare|bless``) — the
    gate's entry point, and the one-command way to bless
    a new baseline after an intentional change.

Tolerance policy: ``tolerance`` is a RELATIVE bound on the harmful
delta (fraction of the baseline value; for a zero baseline it is read
as an absolute bound — the only consistent reading).  ``None`` marks
the metric informational: recorded for trajectory plots, never gated —
use it for wall-clock metrics, which vary across machines; gate only
on deterministic quantities (hit rates, event counts, detection
latencies in batches).
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.export import provenance

BENCH_SCHEMA_VERSION = 1

# the port's baseline directory, relative to the working directory as
# the reference's is
DEFAULT_BASELINES = "bench_torch/baselines"

DIRECTIONS = ("higher_is_better", "lower_is_better")
# verdict statuses that fail the gate
GATING = ("regression", "missing_metric")
_EPS = 1e-12


def config_hash(config: Dict) -> str:
    """Content hash of a sweep's config dict (canonical JSON, first 16
    hex chars) — equality means the two runs measured the same shape."""
    blob = json.dumps(config, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def make_metric(value: float, unit: str, direction: str,
                tolerance: Optional[float] = None) -> Dict[str, object]:
    """One metric entry; ``tolerance=None`` = informational (never
    gates)."""
    if direction not in DIRECTIONS:
        raise ValueError(
            f"direction must be one of {DIRECTIONS}, got {direction!r}")
    if tolerance is not None and tolerance < 0:
        raise ValueError(f"tolerance must be >= 0, got {tolerance}")
    return {"value": float(value), "unit": unit, "direction": direction,
            "tolerance": tolerance}


def make_bench_record(sweep: str, *, config: Dict,
                      metrics: Dict[str, Dict]) -> Dict[str, object]:
    """Assemble the canonical BenchRecord (validates every metric)."""
    for name, m in metrics.items():
        missing = {"value", "unit", "direction", "tolerance"} - set(m)
        if missing:
            raise ValueError(
                f"metric {name!r} missing fields {sorted(missing)} — "
                f"build entries with make_metric()")
        if m["direction"] not in DIRECTIONS:
            raise ValueError(
                f"metric {name!r} has unknown direction "
                f"{m['direction']!r}")
    return {
        "schema_version": BENCH_SCHEMA_VERSION,
        "sweep": sweep,
        "provenance": provenance(),
        "config": dict(config),
        "config_hash": config_hash(config),
        "metrics": {k: dict(v) for k, v in sorted(metrics.items())},
    }


def write_bench(path: str, record: Dict) -> str:
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=str)
        f.write("\n")
    return path


def load_bench(path: str) -> Dict:
    with open(path) as f:
        record = json.load(f)
    for key in ("schema_version", "sweep", "config_hash", "metrics"):
        if key not in record:
            raise ValueError(f"{path}: not a BenchRecord (missing {key!r})")
    if record["schema_version"] != BENCH_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: BenchRecord schema_version "
            f"{record['schema_version']} != {BENCH_SCHEMA_VERSION}")
    return record


@dataclasses.dataclass(frozen=True)
class MetricVerdict:
    """One metric's comparison outcome."""

    metric: str
    status: str          # improvement | within_tolerance | regression |
    #                      missing_metric | new_metric | informational
    baseline: Optional[float]
    current: Optional[float]
    bad_delta: Optional[float] = None    # harmful relative delta

    @property
    def gating(self) -> bool:
        return self.status in GATING


@dataclasses.dataclass
class BenchComparison:
    """The full verdict set for one (baseline, current) record pair."""

    sweep: str
    verdicts: List[MetricVerdict]
    failures: List[str]

    @property
    def ok(self) -> bool:
        return not self.failures and not any(v.gating
                                             for v in self.verdicts)


def _judge(name: str, base: Dict, cur: Dict) -> MetricVerdict:
    b, c = float(base["value"]), float(cur["value"])
    tol = base["tolerance"]
    # harmful delta: positive = worse, in the metric's own direction;
    # relative to the baseline, absolute when the baseline is zero
    delta = c - b
    scale = abs(b) if abs(b) > _EPS else 1.0
    bad = delta / scale
    if base["direction"] == "higher_is_better":
        bad = -bad
    if tol is None:
        return MetricVerdict(name, "informational", b, c, bad)
    if bad > tol:
        return MetricVerdict(name, "regression", b, c, bad)
    if bad < -tol:
        return MetricVerdict(name, "improvement", b, c, bad)
    return MetricVerdict(name, "within_tolerance", b, c, bad)


def compare_bench(baseline: Dict, current: Dict, *,
                  allow_config_change: bool = False) -> BenchComparison:
    """Compare ``current`` against the committed ``baseline`` record.

    Per-metric tolerances come from the BASELINE (the committed gate
    contract).  Gating outcomes: ``regression`` (harmful delta beyond
    tolerance), ``missing_metric`` (a gated baseline metric vanished);
    everything else — improvements, in-tolerance noise, informational
    (``tolerance=None``) metrics, and metrics new in ``current`` —
    passes.
    """
    failures: List[str] = []
    if baseline["sweep"] != current["sweep"]:
        failures.append(
            f"sweep mismatch: baseline {baseline['sweep']!r} vs current "
            f"{current['sweep']!r}")
    if baseline["config_hash"] != current["config_hash"] \
            and not allow_config_change:
        failures.append(
            f"config hash changed ({baseline['config_hash']} -> "
            f"{current['config_hash']}) — the sweep's shape moved, so "
            f"the baseline no longer measures the same thing; re-bless "
            f"with `python -m repro_torch.obs.bench bless` if intentional")
    verdicts: List[MetricVerdict] = []
    bm, cm = baseline["metrics"], current["metrics"]
    for name in sorted(bm):
        if name not in cm:
            # an informational metric vanishing is not a perf signal
            status = ("informational" if bm[name]["tolerance"] is None
                      else "missing_metric")
            verdicts.append(MetricVerdict(
                name, status, float(bm[name]["value"]), None))
            continue
        if bm[name]["direction"] != cm[name]["direction"]:
            failures.append(
                f"metric {name!r} flipped direction "
                f"({bm[name]['direction']} -> {cm[name]['direction']}) "
                f"— re-bless the baseline")
            continue
        verdicts.append(_judge(name, bm[name], cm[name]))
    verdicts.extend(
        MetricVerdict(name, "new_metric", None,
                      float(cm[name]["value"]))
        for name in sorted(set(cm) - set(bm)))
    return BenchComparison(current["sweep"], verdicts, failures)


# ---------------------------------------------------------------------------
# CLI — the gate's entry point
# ---------------------------------------------------------------------------

def _fmt(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.6g}"


def _print_comparison(cmp_: BenchComparison, path: str) -> None:
    print(f"== {cmp_.sweep} ({os.path.basename(path)}) "
          f"{'OK' if cmp_.ok else 'FAIL'}")
    for msg in cmp_.failures:
        print(f"   FAIL {msg}")
    for v in cmp_.verdicts:
        mark = "FAIL" if v.gating else "  ok"
        delta = "" if v.bad_delta is None \
            else f"  harmful_delta={v.bad_delta:+.4f}"
        print(f"   {mark} {v.metric}: {v.status}  "
              f"base={_fmt(v.baseline)} cur={_fmt(v.current)}{delta}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.bench",
        description="BenchRecord perf-regression gate")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cp = sub.add_parser("compare",
                        help="gate current records against baselines")
    cp.add_argument("current", nargs="+",
                    help="current BENCH_*.json files (globs ok)")
    cp.add_argument("--baselines", default=DEFAULT_BASELINES,
                    help="committed baseline directory")
    cp.add_argument("--allow-config-change", action="store_true")
    bp = sub.add_parser("bless",
                        help="copy current records over the baselines")
    bp.add_argument("current", nargs="+")
    bp.add_argument("--baselines", default=DEFAULT_BASELINES)
    args = ap.parse_args(argv)

    paths = sorted(set(p for pat in args.current
                       for p in (glob.glob(pat) or [pat])))
    if args.cmd == "bless":
        os.makedirs(args.baselines, exist_ok=True)
        for path in paths:
            record = load_bench(path)       # refuse to bless a non-record
            dst = os.path.join(args.baselines, os.path.basename(path))
            write_bench(dst, record)
            print(f"blessed {dst} ({record['sweep']})")
        return 0

    bad = 0
    for path in paths:
        current = load_bench(path)
        base_path = os.path.join(args.baselines, os.path.basename(path))
        if not os.path.exists(base_path):
            print(f"== {current['sweep']} ({os.path.basename(path)}) "
                  f"NO BASELINE — bless to start gating: "
                  f"python -m repro_torch.obs.bench bless {path}")
            continue
        cmp_ = compare_bench(load_bench(base_path), current,
                             allow_config_change=args.allow_config_change)
        _print_comparison(cmp_, path)
        bad += not cmp_.ok
    if bad:
        print(f"bench gate: {bad} record(s) regressed")
        return 1
    print("bench gate: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
