"""``repro_torch.analysis`` — static contracts for the paper's invariants.

The counterpart of ``repro.analysis``, with its three layers:

  ``contracts``  one RUN of a hot entry point.  Hot modules attach
      declarative :class:`~repro_torch.analysis.contracts.KernelContract`
      specs (``KERNEL_CONTRACTS`` dicts in ``kernels/ops.py``,
      ``cache/cached_bag.py``, ``core/embedding_bag.py``,
      ``serving/engine.py``, ``cache/tiers.py``);
      :func:`~repro_torch.analysis.contracts.audit` runs the entry point
      once and judges its census (kernel-wrapper calls, launch counts and
      profiler kernels on the card, collective events, a dispatch-mode
      census of dtypes, host transfers and allocations).  The reference's
      ``audit_hlo`` reads XLA HLO and is not ported.
  ``protocol``   the PIPELINE: the epoch state machine, the static
      call-order check of the scheduler source, the timeline sanitizer.
  ``lint``       the SOURCE TREE: AST rules for the repo's failure modes,
      with reason-required per-line suppressions.

Layering rule: this package imports no module of the port at import
time (``fixtures``, which builds the hot modules' inputs, is loaded
only by the CLI), so hot modules import ``contracts`` to declare their
contracts without cycles.

CLI: ``python -m repro_torch.analysis`` (``--lint --contracts
--protocol``, default all three; ``--device cuda`` audits the contracts
on the card).  Exit 1 on any violation.
"""
from repro_torch.analysis.contracts import (
    AuditReport,
    Census,
    ContractViolation,
    KernelContract,
    audit,
    count_launches,
    repo_contracts,
    summarize,
)
from repro_torch.analysis.lint import (
    LintViolation,
    lint_paths,
    lint_source,
)
from repro_torch.analysis.protocol import (
    EpochReplay,
    ProtocolViolation,
    TimelineSpan,
    check_scheduler_source,
    check_timeline,
    extract_scheduler_events,
    load_timeline,
)

__all__ = [
    "AuditReport",
    "Census",
    "ContractViolation",
    "KernelContract",
    "audit",
    "count_launches",
    "repo_contracts",
    "summarize",
    "LintViolation",
    "lint_paths",
    "lint_source",
    "EpochReplay",
    "ProtocolViolation",
    "TimelineSpan",
    "check_scheduler_source",
    "check_timeline",
    "extract_scheduler_events",
    "load_timeline",
]
