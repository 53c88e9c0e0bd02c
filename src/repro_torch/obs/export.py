"""Shared exporters: one CSV assembler, one snapshot writer.

The counterpart of ``repro.obs.export``.  :class:`SweepReport` is a
column-checked CSV assembler: columns are declared once, every row is
validated against them, and comment lines (``# ...`` context) ride along
in order.  :func:`write_snapshot` is the matching JSON artifact writer —
a :class:`~repro_torch.obs.metrics.MetricsRegistry` snapshot plus
arbitrary extras under one top-level schema.

One difference: the provenance stamp names the torch version
(``torch_version``) where the reference names its jax version; the port
imports no JAX.
"""
from __future__ import annotations

import datetime
import json
import subprocess
from typing import Dict, List, Optional, Sequence

import torch

# v2: provenance header/section (git sha, UTC timestamp, framework
# version)
SNAPSHOT_SCHEMA_VERSION = 2


def git_sha(default: str = "unknown") -> str:
    """The repo's HEAD sha (``default`` outside a checkout / without git)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return default
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else default


def provenance() -> Dict[str, str]:
    """Who/when/what produced an artifact: git sha, UTC timestamp, torch
    version — stamped into every CSV and JSON snapshot so artifacts stay
    attributable across commits."""
    return {
        "git_sha": git_sha(),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ"),
        "torch_version": torch.__version__,
    }


class SweepReport:
    """Column-checked CSV assembly for the benchmark sweeps.

    >>> rep = SweepReport("sweep", "ratio", "hit_rate")
    >>> rep.add(sweep="cache", ratio=0.01, hit_rate="0.9372")
    >>> rep.comment("steady state after 150 warmup batches")
    >>> print(rep.csv())

    Values are written with ``str()`` — callers keep formatting floats
    exactly as before (the column contract is order + presence, not
    precision).
    """

    def __init__(self, *columns: str):
        if not columns:
            raise ValueError("SweepReport needs at least one column")
        if len(set(columns)) != len(columns):
            raise ValueError(f"duplicate columns in {columns}")
        self.columns: Sequence[str] = columns
        self._lines: List[str] = []

    def add(self, **values) -> None:
        """Append one row; every declared column must be present and no
        extras allowed (the drift this class exists to prevent)."""
        missing = [c for c in self.columns if c not in values]
        extra = [k for k in values if k not in self.columns]
        if missing or extra:
            raise ValueError(
                f"row does not match columns {list(self.columns)}: "
                f"missing {missing}, unexpected {extra}")
        self._lines.append(",".join(str(values[c]) for c in self.columns))

    def comment(self, text: str) -> None:
        """Interleave a ``# ...`` context line at the current position."""
        self._lines.append(f"# {text}")

    @property
    def header(self) -> str:
        return ",".join(self.columns)

    def __len__(self) -> int:
        return sum(not ln.startswith("#") for ln in self._lines)

    def csv(self) -> str:
        """Header + rows/comments, newline-terminated."""
        return "\n".join([self.header, *self._lines]) + "\n"

    def write(self, path: str) -> str:
        """Write the CSV with a ``# key: value`` provenance header
        (git sha, UTC timestamp, torch version) ahead of the column
        header — comment lines, so every existing CSV consumer that
        skips ``#`` still parses the file."""
        prov = provenance()
        with open(path, "w") as f:
            for k in ("git_sha", "timestamp_utc", "torch_version"):
                f.write(f"# {k}: {prov[k]}\n")
            f.write(self.csv())
        return path


def write_snapshot(path: str, *, metrics=None,
                   extra: Optional[Dict] = None) -> str:
    """Write a versioned JSON benchmark artifact.

    ``metrics`` is a :class:`~repro.obs.metrics.MetricsRegistry` (its
    ``snapshot()`` lands under ``"metrics"``); ``extra`` merges in
    sweep-specific results (calibration numbers, assertions' measured
    values).  A ``"provenance"`` section (git sha, UTC timestamp, torch
    version) is always stamped in.  Returns ``path``.
    """
    payload: Dict[str, object] = {
        "schema_version": SNAPSHOT_SCHEMA_VERSION,
        "provenance": provenance(),
    }
    if metrics is not None:
        payload["metrics"] = metrics.snapshot()
    if extra:
        payload.update(extra)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    return path
