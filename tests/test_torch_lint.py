"""The port's AST lint (``repro_torch.analysis.lint``): the reference's
golden violation per rule (``tests/test_analysis.py``'s ``test_lint_*``),
the schema pins at the port's own files, the port's tree clean, and the
CLI (``python -m repro_torch.analysis``)."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

from repro.analysis import lint as ref_lint
from repro.configs.dlrm import DLRMConfig as JDLRMConfig
from repro.core.embedding_bag import EmbeddingBagConfig as JEBConfig
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.lint import (
    PINNED_SCHEMAS,
    RULES,
    lint_paths,
    lint_source,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rules(src, path="pkg/mod.py"):
    return [v.rule for v in lint_source(src, path)]


# The reference's rules the port's lint leaves out, each of which cannot
# fire on the port's tree: its configs keep no flat cache alias, and it
# has no jaxpr to string-match.
_NOT_PORTED_RULES = {"deprecated-cache-field", "adhoc-jaxpr-assert"}
_REF_ALIASES = sorted(set(JEBConfig._CACHE_ALIASES)
                      | set(JDLRMConfig._CACHE_ALIASES))


def test_lint_rules_are_the_references_less_the_two_not_ported():
    assert RULES == {rule: text for rule, text in ref_lint.RULES.items()
                     if rule not in _NOT_PORTED_RULES}


@pytest.mark.parametrize("alias", _REF_ALIASES)
def test_port_configs_refuse_the_references_flat_cache_aliases(alias):
    """Why the port needs no ``deprecated-cache-field`` rule: neither
    config has a field of that name, and the kwarg is a TypeError."""
    from repro_torch.configs.dlrm import DLRMConfig
    from repro_torch.core.embedding_bag import EmbeddingBagConfig

    for cls, kw in ((EmbeddingBagConfig,
                     dict(num_tables=2, rows_per_table=8, dim=4)),
                    (DLRMConfig, {})):
        assert alias not in {f.name for f in dataclasses.fields(cls)}
        with pytest.raises(TypeError):
            cls(**kw, **{alias: 8})


def test_lint_wall_clock():
    assert _rules("import time\nt0 = time.time()\n") == ["wall-clock"]
    assert _rules("import time\nt0 = time.perf_counter()\n") == []


def test_lint_frozen_mutation():
    flagged = ("def resize(cfg, rows):\n"
               "    object.__setattr__(cfg, 'rows', rows)\n")
    assert _rules(flagged) == ["frozen-mutation"]
    exempt = ("class C:\n"
              "    def __post_init__(self):\n"
              "        object.__setattr__(self, 'rows', 4)\n")
    assert _rules(exempt) == []


def test_lint_export_drift():
    stale = ("__all__ = ['real', 'ghost', 'real']\n"
             "def real():\n    pass\n")
    assert _rules(stale).count("export-drift") == 2  # stale + duplicate
    clean = "__all__ = ['real']\ndef real():\n    pass\n"
    assert _rules(clean) == []


def test_lint_export_drift_sees_all_module_scope_bindings():
    clean = ("__all__ = ['looped', 'ctx', 'walrus', 'a', 'b']\n"
             "for looped in (1, 2):\n    pass\n"
             "with open('x') as ctx:\n    pass\n"
             "if (walrus := 3):\n    pass\n"
             "a, (b, _) = 1, (2, 3)\n")
    assert _rules(clean) == []
    nested = ("__all__ = ['inner', 'comp']\n"
              "def outer():\n    inner = 1\n"
              "vals = [comp for comp in (1, 2)]\n")
    assert _rules(nested).count("export-drift") == 2


def test_lint_schema_pin_key_drift():
    """Changing a pinned schema's keys WITHOUT bumping the version is a
    violation; bumping the version flips it to a pin-update reminder.
    The pins point at the port's files, not the reference's."""
    drifted = (
        "SNAPSHOT_SCHEMA_VERSION = 2\n"
        "def write_snapshot(path, metrics=None):\n"
        "    payload = {\n"
        "        'schema_version': SNAPSHOT_SCHEMA_VERSION,\n"
        "        'provenance': 1,\n"
        "        'renamed_metrics': 2,\n"
        "    }\n")
    violations = lint_source(drifted, "src/repro_torch/obs/export.py")
    assert [v.rule for v in violations] == ["schema-pin"]
    assert "bump" in violations[0].message
    bumped = drifted.replace("SNAPSHOT_SCHEMA_VERSION = 2",
                             "SNAPSHOT_SCHEMA_VERSION = 3")
    violations = lint_source(bumped, "src/repro_torch/obs/export.py")
    assert [v.rule for v in violations] == ["schema-pin"]
    assert "update" in violations[0].message
    assert lint_source(drifted, "src/repro/obs/export.py") == []


def test_lint_schema_pin_subscript_keys_counted():
    src = (
        "SLO_EVENT_SCHEMA_VERSION = 1\n"
        "def to_dict(self):\n"
        "    d = {\n"
        "        'schema_version': SLO_EVENT_SCHEMA_VERSION,\n"
        "        'kind': 1, 'rule': 1, 'tick': 1, 'engine': 1,\n"
        "        'measured': 1, 'threshold': 1,\n"
        "    }\n"
        "    d['table'] = 1\n"
        "    d['expected'] = 1\n"
        "    return d\n")
    assert lint_source(src, "src/repro_torch/obs/slo.py") == []


def test_schema_pins_are_the_references_at_the_ports_files():
    """Same functions, versions and key sets as the reference's pins (the
    port's records stay readable by the reference and back), each at the
    port's file, which exists and lints clean."""
    mine = {p.path_suffix: p for p in PINNED_SCHEMAS}
    theirs = {p.path_suffix.replace("repro/", "repro_torch/", 1): p
              for p in ref_lint.PINNED_SCHEMAS}
    assert set(mine) == set(theirs) == {
        "repro_torch/cache/stats.py", "repro_torch/obs/metrics.py",
        "repro_torch/obs/slo.py", "repro_torch/obs/export.py",
        "repro_torch/obs/bench.py"}
    for suffix, pin in mine.items():
        ref = theirs[suffix]
        assert (pin.function, pin.version_symbol, pin.version, pin.keys) \
            == (ref.function, ref.version_symbol, ref.version, ref.keys)
        path = ROOT / "src" / suffix
        assert path.exists() and lint_paths([str(path)]) == []


def test_lint_suppression_requires_reason():
    # the marker is concatenated so THIS file's raw source never contains
    # a reasonless allow (the scanner reads lines, and the gate lints
    # tests/test_torch_*.py)
    allow = "# lint: " + "allow[wall-clock]"
    reasoned = ("import time\n"
                "t = time.time()  " + allow +
                " -- epoch stamp for artifacts\n")
    assert _rules(reasoned) == []
    bare = "import time\nt = time.time()  " + allow + "\n"
    rules = _rules(bare)
    assert "suppression-missing-reason" in rules
    assert "wall-clock" in rules          # the allow did NOT suppress


def test_lint_tree_is_clean():
    """The standing gate: zero unsuppressed violations on the port's
    tree (the package, its tests and the chip smoke script)."""
    roots = [str(ROOT / "src" / "repro_torch"), str(ROOT / "chip_smoke.py")]
    roots += sorted(str(p) for p in (ROOT / "tests").glob("test_torch_*.py"))
    assert len(roots) > 10
    assert lint_paths(roots) == []


def test_analysis_cli_exits_zero_on_the_cpu():
    """``python -m repro_torch.analysis`` -- lint, contracts on the CPU,
    protocol -- exits 0 from the repo root."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "lint: 0 violation(s)" in out.stdout
    assert out.stdout.count("CONTRACT  ") == 7
    assert "all static-analysis checks passed" in out.stdout


def test_analysis_cli_protocol_mode_alone(capsys):
    assert analysis_main(["--protocol"]) == 0
    out = capsys.readouterr().out
    assert "protocol: scheduler call-order check — ok" in out
    assert "lint:" not in out and "CONTRACT" not in out


def test_analysis_cli_lint_fails_on_a_violation(tmp_path, capsys):
    bad = tmp_path / "mod.py"
    bad.write_text("import time\nt0 = time.time()\n")
    assert analysis_main(["--lint", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "[wall-clock]" in out and "lint: 1 violation(s)" in out
    assert "FAILED: 1 violation(s)" in out
