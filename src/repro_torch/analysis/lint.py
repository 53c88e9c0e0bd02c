"""AST lint pass for this codebase's real failure modes.

The counterpart of ``repro.analysis.lint`` over the port's tree
(``src/repro_torch``, ``tests/test_torch_*.py``, ``chip_smoke.py``); the
schema pins point at the port's own files.  It keeps the reference's
rules but two that cannot fire here: ``deprecated-cache-field`` (the
port's configs keep no flat cache alias; such a kwarg is a TypeError)
and ``adhoc-jaxpr-assert`` (the port has no jaxpr to match).

Not a style linter — every rule here encodes a defect class that has
either bitten this repo or is one refactor away from doing so:

  ``wall-clock``               ``time.time()`` anywhere — every span,
      stage timer, and calibration sample in this repo sits on the
      shared ``perf_counter`` clock; wall clock is not monotonic and
      silently corrupts overlap math.
  ``frozen-mutation``          ``object.__setattr__`` outside
      ``__post_init__`` / ``__init__`` / ``__setstate__`` — the frozen
      configs' escape hatch must stay construction-only.
  ``schema-pin``               key-set or version drift in the pinned
      serialization schemas (``CacheStats.as_dict``,
      ``MetricsRegistry.snapshot``, ``SLOEvent.to_dict``,
      ``write_snapshot``, ``make_bench_record``) — changing keys
      without bumping the ``SCHEMA_VERSION`` breaks committed bench
      baselines (and parity with the reference's records); bumping
      without updating the pin here means the contract was changed
      without review.
  ``export-drift``             ``__all__`` naming something the module
      never binds (or naming it twice) — a stale export is an
      ImportError deferred to the first ``from x import *`` user.

Suppression policy: a violation line may carry
``# lint: allow[rule-id] -- reason`` (comma-separate several ids).  The
reason is MANDATORY — an allow without one is itself reported
(``suppression-missing-reason``).  Suppressions are for documented
exceptions, never for new code taking shortcuts.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

RULES: Dict[str, str] = {
    "wall-clock":
        "time.time() on a potential span path; use time.perf_counter()",
    "frozen-mutation":
        "object.__setattr__ outside __post_init__/__init__/__setstate__",
    "schema-pin":
        "serialization schema drifted from its pin / SCHEMA_VERSION",
    "export-drift":
        "__all__ entry not bound in module (or duplicated)",
    "suppression-missing-reason":
        "lint: allow[...] without a '-- reason' string",
}

_FROZEN_INIT_METHODS = ("__post_init__", "__init__", "__setstate__")


@dataclasses.dataclass(frozen=True)
class SchemaPin:
    """One pinned serialization contract: the function's literal key
    set (dict-literal keys + subscript-assigned keys) at a version."""

    path_suffix: str         # file the schema lives in
    function: str            # def owning the schema dict
    version_symbol: str      # e.g. "SCHEMA_VERSION"
    version: int
    keys: FrozenSet[str]


PINNED_SCHEMAS: Tuple[SchemaPin, ...] = (
    SchemaPin("repro_torch/cache/stats.py", "as_dict", "SCHEMA_VERSION", 3,
              frozenset({
                  "schema_version", "hits", "misses", "misses_host",
                  "misses_remote", "evictions", "bytes_h2d",
                  "bytes_remote", "fetch_host", "fetch_remote", "batches",
                  "lookups", "hit_rate", "remote_miss_fraction", "hits_t",
                  "misses_t", "evictions_t", "lookups_t", "hit_rate_t",
                  "prefetch_s", "scatter_s", "forward_s", "overlap_s",
                  "overlap_fraction"})),
    SchemaPin("repro_torch/obs/metrics.py", "snapshot", "SCHEMA_VERSION", 2,
              frozenset({
                  "schema_version", "counters", "gauges", "histograms",
                  "windowed", "rolling", "ewma", "producers"})),
    SchemaPin("repro_torch/obs/slo.py", "to_dict",
              "SLO_EVENT_SCHEMA_VERSION", 1,
              frozenset({
                  "schema_version", "kind", "rule", "tick", "engine",
                  "measured", "threshold", "table", "expected"})),
    SchemaPin("repro_torch/obs/export.py", "write_snapshot",
              "SNAPSHOT_SCHEMA_VERSION", 2,
              frozenset({"schema_version", "provenance", "metrics"})),
    SchemaPin("repro_torch/obs/bench.py", "make_bench_record",
              "BENCH_SCHEMA_VERSION", 1,
              frozenset({
                  "schema_version", "sweep", "provenance", "config",
                  "config_hash", "metrics"})),
)


@dataclasses.dataclass(frozen=True)
class LintViolation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

_ALLOW_RE = re.compile(
    r"#\s*lint:\s*allow\[([a-z\-, ]+)\]\s*(?:--\s*(\S.*))?")


def _parse_suppressions(source: str,
                        path: str) -> Tuple[Dict[int, FrozenSet[str]],
                                            List[LintViolation]]:
    """Per-line allowed rule ids, plus violations for reasonless allows."""
    allowed: Dict[int, FrozenSet[str]] = {}
    bad: List[LintViolation] = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        rules = frozenset(r.strip() for r in m.group(1).split(",")
                          if r.strip())
        if not m.group(2):
            bad.append(LintViolation(
                path, lineno, "suppression-missing-reason",
                f"allow[{m.group(1)}] has no '-- reason'; every "
                f"suppression must say why"))
            continue
        allowed[lineno] = rules
    return allowed, bad


# ---------------------------------------------------------------------------
# The AST visitor
# ---------------------------------------------------------------------------

class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.violations: List[LintViolation] = []
        self._func_stack: List[str] = []

    def _flag(self, node, rule: str, message: str) -> None:
        self.violations.append(
            LintViolation(self.path, node.lineno, rule, message))

    # -- function-name stack (frozen-mutation exemption) ---------------------

    def visit_FunctionDef(self, node) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- call-pattern rules --------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "time"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "time"):
            self._flag(node, "wall-clock",
                       "time.time() is not monotonic; spans and stage "
                       "timers must use time.perf_counter()")

        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "__setattr__"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "object"
                and not any(f in _FROZEN_INIT_METHODS
                            for f in self._func_stack)):
            self._flag(node, "frozen-mutation",
                       "object.__setattr__ outside construction mutates "
                       "a frozen config; thread new state through "
                       "dataclasses.replace")

        self.generic_visit(node)


# ---------------------------------------------------------------------------
# Module-level rules (export drift, schema pins)
# ---------------------------------------------------------------------------

class _ModuleScopeBinder(ast.NodeVisitor):
    """Collect every name bound at module scope — defs, classes,
    imports, plus any Store-context Name (assignments, ``for`` targets,
    ``with ... as``, walrus, unpacking) at any statement depth — while
    refusing to descend into nested scopes (function/lambda bodies,
    comprehensions), whose bindings are not module attributes."""

    def __init__(self) -> None:
        self.names: set = set()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.names.add(node.name)

    def visit_AsyncFunctionDef(self, node) -> None:
        self.names.add(node.name)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.names.add(node.name)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_ListComp(self, node) -> None:
        pass

    visit_SetComp = visit_DictComp = visit_GeneratorExp = visit_ListComp

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.names.add(alias.asname or alias.name.split(".")[0])

    visit_ImportFrom = visit_Import

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Store):
            self.names.add(node.id)


def _bound_names(tree: ast.Module) -> FrozenSet[str]:
    binder = _ModuleScopeBinder()
    binder.visit(tree)
    return frozenset(binder.names)


def _check_exports(tree: ast.Module, path: str) -> List[LintViolation]:
    out: List[LintViolation] = []
    for node in tree.body:
        if not (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)
                and isinstance(node.value, (ast.List, ast.Tuple))):
            continue
        entries = [(e.value, e.lineno) for e in node.value.elts
                   if isinstance(e, ast.Constant) and isinstance(e.value,
                                                                 str)]
        bound = _bound_names(tree)
        seen = set()
        for name, lineno in entries:
            if name in seen:
                out.append(LintViolation(
                    path, lineno, "export-drift",
                    f"__all__ lists {name!r} twice"))
            seen.add(name)
            if name not in bound:
                out.append(LintViolation(
                    path, lineno, "export-drift",
                    f"__all__ exports {name!r} but the module never "
                    f"binds it (stale export)"))
    return out


def _schema_keys_of(func: ast.AST) -> Optional[FrozenSet[str]]:
    """Literal key set of the schema built in ``func``: keys of any dict
    literal containing a "schema_version" key, plus string-subscript
    assignments onto the names such dicts were bound to."""
    keys = set()
    dict_names = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Dict):
            literal = [k.value for k in node.keys
                       if isinstance(k, ast.Constant)
                       and isinstance(k.value, str)]
            if "schema_version" in literal:
                keys.update(literal)
                parent = getattr(node, "_pin_parent", None)
                if parent:
                    dict_names.add(parent)
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = node.value
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if isinstance(value, ast.Dict):
                for t in targets:
                    if isinstance(t, ast.Name):
                        value._pin_parent = t.id  # noqa: SLF001
    if not keys:
        return None
    # second pass now that dict-owning names are known
    for node in ast.walk(func):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in dict_names
                        and isinstance(t.slice, ast.Constant)
                        and isinstance(t.slice.value, str)):
                    keys.add(t.slice.value)
    return frozenset(keys)


def _check_schema_pins(tree: ast.Module, path: str) -> List[LintViolation]:
    norm = path.replace(os.sep, "/")
    pins = [p for p in PINNED_SCHEMAS if norm.endswith(p.path_suffix)]
    if not pins:
        return []
    out: List[LintViolation] = []
    for pin in pins:
        func = next((n for n in ast.walk(tree)
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                     and n.name == pin.function), None)
        if func is None:
            out.append(LintViolation(
                path, 1, "schema-pin",
                f"pinned schema function {pin.function!r} is gone; "
                f"update PINNED_SCHEMAS in analysis/lint.py"))
            continue
        version = None
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant):
                for t in node.targets:
                    if isinstance(t, ast.Name) and \
                            t.id == pin.version_symbol:
                        version = node.value.value
        if version != pin.version:
            out.append(LintViolation(
                path, func.lineno, "schema-pin",
                f"{pin.version_symbol} is {version!r} but the analysis "
                f"pin says {pin.version}; review the schema change and "
                f"update PINNED_SCHEMAS"))
            continue    # keys intentionally differ across versions
        keys = _schema_keys_of(func)
        if keys is None:
            out.append(LintViolation(
                path, func.lineno, "schema-pin",
                f"{pin.function} no longer builds a literal "
                f"schema_version dict the pin can check"))
            continue
        if keys != pin.keys:
            added = sorted(keys - pin.keys)
            removed = sorted(pin.keys - keys)
            out.append(LintViolation(
                path, func.lineno, "schema-pin",
                f"{pin.function} key set drifted at version "
                f"{pin.version} (added {added}, removed {removed}); "
                f"bump {pin.version_symbol} and update the pin"))
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str = "<string>") -> List[LintViolation]:
    """Lint one module's source; returns unsuppressed violations (plus
    any reasonless-suppression violations)."""
    tree = ast.parse(source)
    visitor = _Visitor(path)
    visitor.visit(tree)
    found = (visitor.violations + _check_exports(tree, path)
             + _check_schema_pins(tree, path))
    allowed, bad_allows = _parse_suppressions(source, path)
    kept = [v for v in found
            if v.rule not in allowed.get(v.line, frozenset())]
    return sorted(kept + bad_allows, key=lambda v: (v.path, v.line, v.rule))


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for root in paths:
        if os.path.isfile(root):
            yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if not d.startswith(".") and d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_paths(paths: Sequence[str]) -> List[LintViolation]:
    out: List[LintViolation] = []
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as fh:
            out.extend(lint_source(fh.read(), path))
    return out
