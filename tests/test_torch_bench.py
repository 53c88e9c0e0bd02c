"""The port's BenchRecord gate (``repro_torch.obs.bench``) against the
reference's cases (``tests/test_slo.py``'s compare_bench and CLI tests)
and against the reference's own functions: the same verdicts, the same
config hashes, the same record keys.  Exact: the gate is pure Python."""
import json
import os

import pytest

from repro.obs import bench as ref_bench
from repro_torch.obs import bench
from repro_torch.obs.bench import (
    BENCH_SCHEMA_VERSION,
    DEFAULT_BASELINES,
    compare_bench,
    config_hash,
    load_bench,
    make_bench_record,
    make_metric,
    write_bench,
)
from repro_torch.obs.bench import main as bench_main


def _record(metrics, sweep="demo", config=None):
    return make_bench_record(sweep, config=config or {"shape": 1},
                             metrics=metrics)


def _matrix(mod):
    m = mod.make_metric
    base = mod.make_bench_record("demo", config={"shape": 1}, metrics={
        "lat_ms": m(10.0, "ms", "lower_is_better", 0.10),
        "hit_rate": m(0.90, "1", "higher_is_better", 0.02),
        "gone": m(1.0, "1", "lower_is_better", 0.1),
        "gone_info": m(1.0, "1", "lower_is_better", None),
        "wall_s": m(3.0, "s", "lower_is_better", None),
        "zero": m(0.0, "1", "lower_is_better", 0.5),
    })
    cur = mod.make_bench_record("demo", config={"shape": 1}, metrics={
        "lat_ms": m(8.0, "ms", "lower_is_better", 0.10),
        "hit_rate": m(0.70, "1", "higher_is_better", 0.02),
        "wall_s": m(30.0, "s", "lower_is_better", None),
        "zero": m(0.4, "1", "lower_is_better", 0.5),
        "brand_new": m(5.0, "1", "lower_is_better", 0.1),
    })
    return mod.compare_bench(base, cur)


def test_compare_bench_verdict_matrix():
    cmp_ = _matrix(bench)
    by = {v.metric: v.status for v in cmp_.verdicts}
    assert by == {
        "lat_ms": "improvement",          # 20% faster, beyond tolerance
        "hit_rate": "regression",         # -22% relative, gates
        "gone": "missing_metric",         # gated metric vanished: gates
        "gone_info": "informational",     # informational vanished: ok
        "wall_s": "informational",        # 10x slower but never gates
        "zero": "within_tolerance",       # baseline 0 -> absolute delta
        "brand_new": "new_metric",
    }
    assert not cmp_.ok
    assert {v.metric for v in cmp_.verdicts if v.gating} == \
        {"hit_rate", "gone"}


def test_verdicts_equal_the_reference():
    """Every verdict field (status, baseline, current, harmful delta)
    equals the reference's on the same records."""
    got, want = _matrix(bench), _matrix(ref_bench)
    assert [(v.metric, v.status, v.baseline, v.current, v.bad_delta)
            for v in got.verdicts] == \
        [(v.metric, v.status, v.baseline, v.current, v.bad_delta)
         for v in want.verdicts]
    assert got.failures == want.failures and got.ok == want.ok


def test_compare_bench_config_hash_gate():
    base = _record({"m": make_metric(1.0, "1", "lower_is_better", 0.1)},
                   config={"rows": 64})
    cur = _record({"m": make_metric(1.0, "1", "lower_is_better", 0.1)},
                  config={"rows": 128})
    cmp_ = compare_bench(base, cur)
    assert not cmp_.ok and "config hash changed" in cmp_.failures[0]
    assert "repro_torch.obs.bench bless" in cmp_.failures[0]
    assert compare_bench(base, cur, allow_config_change=True).ok
    assert config_hash({"rows": 64}) != config_hash({"rows": 128})
    assert base["config_hash"] == config_hash({"rows": 64})


@pytest.mark.parametrize("config", [
    {}, {"rows": 64}, {"shape": 1, "zipf_a": 1.05, "tables": 26},
    {"b": [1, 2, {"c": None}], "a": "x", "nested": {"z": 1.5, "y": True}},
    {"plan": ("tuple", 3), "obj": object.__name__},
])
def test_config_hash_equals_the_reference(config):
    assert config_hash(config) == ref_bench.config_hash(config)


def test_compare_bench_direction_flip_fails():
    base = _record({"m": make_metric(1.0, "1", "lower_is_better", 0.1)})
    cur = _record({"m": make_metric(1.0, "1", "higher_is_better", 0.1)})
    cmp_ = compare_bench(base, cur)
    assert not cmp_.ok and "flipped direction" in cmp_.failures[0]


def test_make_metric_validation():
    with pytest.raises(ValueError, match="direction"):
        make_metric(1.0, "ms", "sideways", 0.1)
    with pytest.raises(ValueError, match="tolerance"):
        make_metric(1.0, "ms", "lower_is_better", -0.5)
    with pytest.raises(ValueError, match="make_metric"):
        make_bench_record("s", config={}, metrics={"m": {"value": 1.0}})


def test_bench_record_round_trip_and_provenance(tmp_path):
    rec = _record({"m": make_metric(1.0, "1", "lower_is_better", 0.1)})
    path = str(tmp_path / "BENCH_demo.json")
    write_bench(path, rec)
    loaded = load_bench(path)
    assert loaded == json.loads(json.dumps(rec, default=str))
    assert {"git_sha", "timestamp_utc", "torch_version"} <= \
        set(loaded["provenance"])
    assert "jax_version" not in loaded["provenance"]
    with pytest.raises(ValueError, match="not a BenchRecord"):
        bad = str(tmp_path / "bad.json")
        with open(bad, "w") as f:
            json.dump({"hello": 1}, f)
        load_bench(bad)


def test_records_match_the_reference_schema(tmp_path):
    """Same schema version and key set as the reference's records, and
    each package loads the other's (provenance aside)."""
    metrics = {"m": make_metric(2.0, "ms", "lower_is_better", 0.1)}
    mine = make_bench_record("demo", config={"rows": 8}, metrics=metrics)
    theirs = ref_bench.make_bench_record("demo", config={"rows": 8},
                                         metrics=metrics)
    assert BENCH_SCHEMA_VERSION == ref_bench.BENCH_SCHEMA_VERSION
    assert set(mine) == set(theirs)
    assert {k: v for k, v in mine.items() if k != "provenance"} == \
        {k: v for k, v in theirs.items() if k != "provenance"}
    p_mine, p_theirs = (str(tmp_path / "mine.json"),
                        str(tmp_path / "theirs.json"))
    write_bench(p_mine, mine)
    ref_bench.write_bench(p_theirs, theirs)
    assert compare_bench(load_bench(p_theirs), load_bench(p_mine)).ok
    assert ref_bench.compare_bench(ref_bench.load_bench(p_mine),
                                   ref_bench.load_bench(p_theirs)).ok


def test_bench_cli_bless_then_compare(tmp_path, capsys):
    cur_dir, base_dir = tmp_path / "cur", tmp_path / "baselines"
    cur_dir.mkdir()
    path = str(cur_dir / "BENCH_demo.json")
    write_bench(path, _record(
        {"hit_rate": make_metric(0.9, "1", "higher_is_better", 0.02)}))
    # no baseline yet: compare passes with a bless hint
    assert bench_main(["compare", path, "--baselines",
                       str(base_dir)]) == 0
    out = capsys.readouterr().out
    assert "NO BASELINE" in out and "repro_torch.obs.bench bless" in out
    assert bench_main(["bless", path, "--baselines", str(base_dir)]) == 0
    assert os.listdir(base_dir) == ["BENCH_demo.json"]
    assert bench_main(["compare", path, "--baselines",
                       str(base_dir)]) == 0
    assert "bench gate: clean" in capsys.readouterr().out
    # regress the metric: the gate must fail with exit code 1
    write_bench(path, _record(
        {"hit_rate": make_metric(0.5, "1", "higher_is_better", 0.02)}))
    assert bench_main(["compare", path, "--baselines",
                       str(base_dir)]) == 1
    out = capsys.readouterr().out
    assert "regression" in out and "FAIL" in out


def test_default_baselines_are_the_ports_own(tmp_path, monkeypatch,
                                             capsys):
    """``bless`` without ``--baselines`` writes under the port's own
    directory, relative to the working directory, and never into the JAX
    package's ``benchmarks/baselines``."""
    assert DEFAULT_BASELINES == "bench_torch/baselines"
    assert not DEFAULT_BASELINES.startswith("benchmarks")
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "BENCH_demo.json")
    write_bench(path, _record(
        {"m": make_metric(1.0, "1", "lower_is_better", 0.1)}))
    assert bench_main(["bless", path]) == 0
    assert os.listdir(tmp_path / "bench_torch" / "baselines") == \
        ["BENCH_demo.json"]
    assert not (tmp_path / "benchmarks").exists()
    assert bench_main(["compare", path]) == 0
    assert "bench gate: clean" in capsys.readouterr().out
