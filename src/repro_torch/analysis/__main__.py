"""CLI: ``python -m repro_torch.analysis [--lint] [--contracts] [--protocol]``.

The counterpart of ``python -m repro.analysis``.  With no mode flags, runs
all three layers.  Exits 1 on any violation.

    python -m repro_torch.analysis                   # lint+contracts+protocol
    python -m repro_torch.analysis --lint src/repro_torch   # lint only
    python -m repro_torch.analysis --contracts --device cuda  # on the card

The lint's default roots are the port's tree: ``src/repro_torch``, the
``tests/test_torch_*.py`` files and ``chip_smoke.py`` (relative to the
working directory, the repo root).
"""
from __future__ import annotations

import argparse
import glob
import sys
from typing import List

DEFAULT_LINT_PATHS = ("src/repro_torch", "tests/test_torch_*.py",
                      "chip_smoke.py")


def _lint_roots(paths) -> List[str]:
    """Expand globs (a pattern that matches nothing is kept, so a missing
    root still fails loudly)."""
    return [p for pat in paths for p in (sorted(glob.glob(pat)) or [pat])]


def _run_lint(paths) -> int:
    from repro_torch.analysis.lint import lint_paths

    violations = lint_paths(_lint_roots(paths))
    for v in violations:
        print(f"LINT  {v}")
    print(f"lint: {len(violations)} violation(s) over {list(paths)}")
    return len(violations)


def _run_contracts(device: str) -> int:
    # fixtures imports the hot modules — lazy by design
    from repro_torch.analysis.fixtures import run_all

    failures = 0
    for report in run_all(device=device):
        status = "ok" if report.ok else "FAIL"
        print(f"CONTRACT  {report.contract.name}: {status}")
        for violation in report.violations:
            failures += 1
            print(f"  - {violation}")
    return failures


def _run_protocol() -> int:
    from repro_torch.analysis.protocol import check_scheduler_source

    violations = check_scheduler_source()
    print(f"protocol: scheduler call-order check — "
          f"{'ok' if not violations else f'{len(violations)} violation(s)'}")
    for v in violations:
        print(f"PROTOCOL  {v}")
    return len(violations)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static-analysis gate: kernel contracts, epoch "
                    "protocol, repo lint")
    parser.add_argument("--lint", action="store_true")
    parser.add_argument("--contracts", action="store_true")
    parser.add_argument("--protocol", action="store_true")
    parser.add_argument("--device", default="cpu",
                        help="where the contract fixtures run: cpu (the "
                             "kernels' plain versions) or cuda")
    parser.add_argument("paths", nargs="*",
                        help=f"lint roots (default: "
                             f"{' '.join(DEFAULT_LINT_PATHS)})")
    args = parser.parse_args(argv)

    if not (args.lint or args.contracts or args.protocol):
        args.lint = args.contracts = args.protocol = True

    failures = 0
    if args.lint:
        failures += _run_lint(args.paths or list(DEFAULT_LINT_PATHS))
    if args.contracts:
        failures += _run_contracts(args.device)
    if args.protocol:
        failures += _run_protocol()

    if failures:
        print(f"\nFAILED: {failures} violation(s)")
        return 1
    print("\nall static-analysis checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
