"""The port's planner -> engine round trip against the JAX package, on the
CPU: ``core/perf_model.py``, ``core/sharding_plan.py``,
``DLRMConfig.sharding_plan`` and plan-sized heterogeneous slot pools
through both engines.

Tolerances: every copied perf-model function agrees with the reference's
to ``rtol=1e-12`` (the same float operations in the same order); plans
agree field by field, exactly.  The engines' pCTR agrees to ``rtol=1e-4,
atol=1e-5`` (two frameworks' MLPs, the tolerance of test_torch_serving),
their cache counters and per-table hit rates exactly (the same numpy state
machine on the same ids); inside the port, cached scores are bitwise the
uncached ones and the pipelined engine's bitwise the serialized one's.

The reference's remote-tier plan checks (``tests/_plan_checks.py``) need
one jax device per simulated host, so their reference side runs once per
module in a subprocess with 4 forced CPU devices: this file run as a
script, as ``tests/test_torch_remote.py`` does.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import CacheConfig as JCacheConfig
from repro.cache import CachedEmbeddingBag as JBag
from repro.cache import SlotPoolManager as JManager
from repro.configs import dlrm as jcfg_mod
from repro.core import perf_model as jpm
from repro.core import sharding_plan as jsp
from repro.core.embedding_bag import EmbeddingBagConfig as JBagConfig
from repro.core.jagged import JaggedBatch as JJagged
from repro.models import dlrm as jdlrm
from repro.serving.engine import CTRRequest as JRequest
from repro.serving.engine import DLRMEngine as JEngine
from repro.serving.engine import make_dlrm_engine as jmake_engine
from repro_torch.cache.cached_bag import CachedEmbeddingBag
from repro_torch.cache.manager import CacheCapacityError, SlotPoolManager
from repro_torch.configs import dlrm as tcfg_mod
from repro_torch.core import embedding_bag as teb
from repro_torch.core import perf_model as pm
from repro_torch.core import sharding_plan as sp
from repro_torch.core.cache_config import CacheConfig
from repro_torch.core.jagged import JaggedBatch, random_jagged_batch
from repro_torch.pipeline import DoubleBufferedSlotPool
from repro_torch.serving.engine import (CTRRequest, DLRMEngine,
                                        PipelinedDLRMEngine, make_dlrm_engine)
from repro_torch.utils.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12
PCTR = dict(rtol=1e-4, atol=1e-5)
COUNTERS = ("hits", "misses", "misses_host", "misses_remote", "evictions",
            "bytes_h2d", "bytes_remote", "fetch_host", "fetch_remote",
            "batches")
PER_TABLE = ("hits_t", "misses_t", "evictions_t")
H = 4                                   # simulated hosts (remote checks)
# benchmarks/plan_roundtrip_sweep.py's SMOKE shape
SMOKE = dict(tables=6, rows=2048, dim=16, pooling=8, batch=8,
             budget=48_000, zipf=0.9)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _port_hw(hw):
    """The port's Hardware with the field values of a reference one."""
    d = {f.name: getattr(hw, f.name) for f in dataclasses.fields(hw)}
    d["bulk"] = pm.Transport(**dataclasses.asdict(hw.bulk))
    d["onesided"] = pm.Transport(**dataclasses.asdict(hw.onesided))
    return pm.Hardware(**d)


def _workload(mod, **kw):
    base = dict(num_tables=26, batch_per_device=2048, pooling=32, dim=128)
    return mod.EmbeddingWorkload(**{**base, **kw})


# ---------------------------------------------------------------------------
# perf_model parity
# ---------------------------------------------------------------------------

def test_platform_constants_match_reference():
    assert dataclasses.asdict(pm.H100_DGX) == \
        dataclasses.asdict(jpm.H100_DGX)
    assert set(pm._OP_FACTOR) == set(jpm._OP_FACTOR)
    # the TPU platform and roofline terms are left out on purpose
    for name in ("TPU_V5E", "roofline_terms", "ICI_LINK_Bps",
                 "V5E_PEAK_BF16", "V5E_HBM_Bps"):
        assert hasattr(jpm, name) and not hasattr(pm, name), name


@pytest.mark.parametrize("op", sorted(jpm._OP_FACTOR))
@pytest.mark.parametrize("transport", ["bulk", "onesided"])
def test_collective_time_matches(op, transport):
    for n in (1, 2, 4, 8, 16, 128):
        for b in (0.0, 64.0, 2048.0, 3.7e5, 1.2e9):
            _close(pm.collective_time(op, b, n,
                                      getattr(pm.H100_DGX, transport)),
                   jpm.collective_time(op, b, n,
                                       getattr(jpm.H100_DGX, transport)))


@pytest.mark.parametrize("a", [0.5, 0.9, 1.05, 1.2])
def test_zipf_hit_rate_matches(a):
    for rows, cache_rows in ((64, 8), (2048, 409), (8192, 1024),
                             (10**6, 5000), (10**6, 200_000),
                             (10**6, 65_536), (100, 0), (100, 100)):
        _close(pm.zipf_hit_rate(a, rows, cache_rows),
               jpm.zipf_hit_rate(a, rows, cache_rows))
    assert pm.zipf_hit_rate(0.0, 100, 10) == jpm.zipf_hit_rate(0.0, 100, 10)


@pytest.mark.parametrize("a", [0.0, 0.6, 0.9, 1.0, 1.05, 1.2])
def test_expected_unique_misses_matches(a):
    for rows, c, n in ((512, 64, 512), (2048, 0, 64), (8192, 1024, 256),
                       (10**6, 200_000, 65_536), (10**6, 65_536, 65_536),
                       (1000, 1000, 64)):
        _close(pm.expected_unique_misses(a, rows, c, n),
               jpm.expected_unique_misses(a, rows, c, n))


def _tiered_cases():
    """(kwargs of the tiered functions, workload kwargs): with and without
    the traffic model, one and several hosts, both transports."""
    for hosts in (1, 4):
        for onesided in (False, True):
            yield dict(hit_rate=0.9, hosts=hosts, onesided=onesided), {}
            yield (dict(hit_rate=0.959, hosts=hosts, onesided=onesided,
                        zipf_a=1.05, rows=10**6, cache_rows=200_000),
                   dict(num_tables=1))
            yield (dict(hit_rate=0.5, hosts=hosts, onesided=onesided,
                        zipf_a=0.9, rows=2048, cache_rows=409),
                   dict(num_tables=1, batch_per_device=8, pooling=8,
                        dim=16))


@pytest.mark.parametrize("fn", ["tiered_phase_times",
                                "tiered_embedding_bag_time",
                                "overlapped_phase_times",
                                "overlapped_embedding_bag_time"])
def test_tiered_models_match(fn):
    for kw, wkw in _tiered_cases():
        got = getattr(pm, fn)(_workload(pm, **wkw), pm.H100_DGX, **kw)
        want = getattr(jpm, fn)(_workload(jpm, **wkw), jpm.H100_DGX, **kw)
        if isinstance(want, dict):
            assert list(got) == list(want)
            got, want = list(got.values()), list(want.values())
        _close(got, want)
    if fn.startswith("overlapped"):
        for depth in (1, 2, 3):
            kw = dict(hit_rate=0.8, hosts=4, depth=depth)
            got = getattr(pm, fn)(_workload(pm), pm.H100_DGX, **kw)
            want = getattr(jpm, fn)(_workload(jpm), jpm.H100_DGX, **kw)
            if isinstance(want, dict):
                got, want = list(got.values()), list(want.values())
            _close(got, want)


def test_phase_and_projection_models_match():
    for n in (1, 4, 8, 128):
        for onesided in (False, True):
            got = pm.phase_times(_workload(pm), n, pm.H100_DGX,
                                 onesided=onesided)
            want = jpm.phase_times(_workload(jpm), n, jpm.H100_DGX,
                                   onesided=onesided)
            assert list(got) == list(want)
            _close(list(got.values()), list(want.values()))
            _close(pm.embedding_bag_time(_workload(pm), n, pm.H100_DGX,
                                         onesided=onesided),
                   jpm.embedding_bag_time(_workload(jpm), n, jpm.H100_DGX,
                                          onesided=onesided))
    for fused in (False, True):
        _close(list(pm.tbe_gather_phases(_workload(pm), pm.H100_DGX,
                                         fused=fused).values()),
               list(jpm.tbe_gather_phases(_workload(jpm), jpm.H100_DGX,
                                          fused=fused).values()))
    for tb in (1e9, 13.3e9, 1e13):
        assert pm.devices_for_table(tb, pm.H100_DGX) == \
            jpm.devices_for_table(tb, jpm.H100_DGX)
        _close(pm.local_vs_distributed_speedup(tb, _workload(pm),
                                               pm.H100_DGX),
               jpm.local_vs_distributed_speedup(tb, _workload(jpm),
                                                jpm.H100_DGX))
        _close(pm.cache_speedup_vs_distributed(tb, _workload(pm),
                                               pm.H100_DGX, hit_rate=0.9),
               jpm.cache_speedup_vs_distributed(tb, _workload(jpm),
                                                jpm.H100_DGX, hit_rate=0.9))
        kw = dict(hit_rate=0.9, hosts=4, fetch_onesided=True)
        _close(pm.tiered_speedup_vs_distributed(tb, _workload(pm),
                                                pm.H100_DGX, **kw),
               jpm.tiered_speedup_vs_distributed(tb, _workload(jpm),
                                                 jpm.H100_DGX, **kw))
        _close(pm.pipelined_speedup_vs_distributed(tb, _workload(pm),
                                                   pm.H100_DGX, **kw),
               jpm.pipelined_speedup_vs_distributed(tb, _workload(jpm),
                                                    jpm.H100_DGX, **kw))
    got = pm.cached_phase_times(_workload(pm), pm.H100_DGX, hit_rate=0.7)
    want = jpm.cached_phase_times(_workload(jpm), jpm.H100_DGX, hit_rate=0.7)
    assert list(got) == list(want)
    _close(list(got.values()), list(want.values()))
    _close(pm.cached_embedding_bag_time(_workload(pm), pm.H100_DGX,
                                        hit_rate=0.7),
           jpm.cached_embedding_bag_time(_workload(jpm), jpm.H100_DGX,
                                         hit_rate=0.7))


def test_slot_pool_bytes_match():
    for slots in ([200_000] * 8 + [100_000] * 2 + [65_536] * 16,
                  [200_000] * 16 + [100_000] * 10, [64, 16, 32], [], [0]):
        for dim, dtype_bytes in ((128, 4), (16, 4), (128, 2)):
            assert pm.slot_pool_bytes(slots, dim, dtype_bytes) == \
                jpm.slot_pool_bytes(slots, dim, dtype_bytes)
            assert pm.padded_slot_pool_bytes(slots, dim, dtype_bytes) == \
                jpm.padded_slot_pool_bytes(slots, dim, dtype_bytes)
    # plan A's pool (the smoke run's phase 6c(a)): the exact byte count
    assert pm.slot_pool_bytes([200_000] * 8 + [100_000] * 2 + [65_536] * 16,
                              128) == 1_458_470_912
    for fn in ("slot_pool_bytes", "padded_slot_pool_bytes"):
        with pytest.raises(ValueError) as got:
            getattr(pm, fn)([4, -1], 8)
        with pytest.raises(ValueError) as want:
            getattr(jpm, fn)([4, -1], 8)
        assert str(got.value) == str(want.value)


def _synthetic_samples(mod, hw, rng, *, n_each=6, hosts=4, onesided=False):
    out = []
    for b in rng.uniform(1e4, 1e6, n_each):
        out.append(mod.StageSample(
            "h2d", hw.gather_overhead_s + b / hw.host_Bps, b))
    t = hw.onesided if onesided else hw.bulk
    for b in rng.uniform(1e4, 1e6, n_each):
        out.append(mod.StageSample(
            "fetch_remote", mod.collective_time("fetch_rows", b, hosts, t),
            b, hosts))
    return out


def _hw_values(hw):
    d = dataclasses.asdict(hw)
    return [d.pop("name"), d.pop("bulk"), d.pop("onesided")], d


def _same_hw(got, want):
    g_named, g_vals = _hw_values(got)
    w_named, w_vals = _hw_values(want)
    assert g_named[0] == w_named[0]
    for a, b in ((g_named[1], w_named[1]), (g_named[2], w_named[2])):
        assert a["name"] == b["name"]
        _close([a["alpha_s"], a["beta_Bps"]], [b["alpha_s"], b["beta_Bps"]])
    assert list(g_vals) == list(w_vals)
    _close(list(g_vals.values()), list(w_vals.values()))


@pytest.mark.parametrize("onesided", [False, True])
def test_calibrate_matches_reference(onesided):
    """Synthetic samples from a known platform, both transports: the same
    fitted Hardware, counts and errors as the reference's, and the fit
    recovers the platform."""
    true = dataclasses.replace(
        jpm.H100_DGX, gather_overhead_s=5e-4, host_Bps=2e8,
        bulk=jpm.Transport("true", alpha_s=1.2e-3, beta_Bps=1e8),
        onesided=jpm.Transport("t1", alpha_s=2e-4, beta_Bps=5e8))
    want_s = _synthetic_samples(jpm, true, np.random.default_rng(0),
                                onesided=onesided)
    got_s = _synthetic_samples(pm, _port_hw(true), np.random.default_rng(0),
                               onesided=onesided)
    want = jpm.calibrate(want_s, jpm.H100_DGX, onesided=onesided)
    got = pm.calibrate(got_s, pm.H100_DGX, onesided=onesided)
    assert (got.n_h2d, got.n_remote, got.onesided) == \
        (want.n_h2d, want.n_remote, want.onesided) == (6, 6, onesided)
    _same_hw(got.hw, want.hw)
    t = got.hw.onesided if onesided else got.hw.bulk
    true_t = true.onesided if onesided else true.bulk
    assert t.alpha_s == pytest.approx(true_t.alpha_s, rel=1e-6)
    assert t.beta_Bps == pytest.approx(true_t.beta_Bps, rel=1e-6)
    assert got.hw.host_Bps == pytest.approx(2e8, rel=1e-6)
    for samples, res in ((got_s, got), (want_s, want)):
        assert res.error(samples)["total"] < 1e-9
    g_err = pm.stage_time_error(got_s, pm.H100_DGX, onesided=onesided)
    w_err = jpm.stage_time_error(want_s, jpm.H100_DGX, onesided=onesided)
    assert list(g_err) == list(w_err)
    _close(list(g_err.values()), list(w_err.values()))
    for g, w in zip(got_s, want_s):
        _close(pm.predicted_stage_time(g, pm.H100_DGX, onesided=onesided),
               jpm.predicted_stage_time(w, jpm.H100_DGX, onesided=onesided))


@pytest.mark.parametrize("case", ["empty", "one", "rank1", "single_host",
                                  "negative_slope", "negative_intercept"])
def test_calibrate_degenerate_inputs_match(case):
    samples = {
        "empty": [],
        "one": [("h2d", 1e-3, 1e5)],
        "rank1": [("h2d", 1e-3, 1e5), ("h2d", 2e-3, 1e5)],
        "single_host": [("fetch_remote", 1e-3, 1e5, 1)],
        # slower for more bytes never happens; the clamps must agree
        "negative_slope": [("h2d", 3e-3, 1e4), ("h2d", 1e-3, 1e6),
                           ("fetch_remote", 3e-3, 1e4, 4),
                           ("fetch_remote", 1e-3, 1e6, 4)],
        "negative_intercept": [("h2d", 1e-6, 1e4), ("h2d", 1e-3, 1e6),
                               ("h2d", 2e-3, 2e6)],
    }[case]
    for onesided in (False, True):
        got = pm.calibrate([pm.StageSample(*s) for s in samples],
                           pm.H100_DGX, onesided=onesided)
        want = jpm.calibrate([jpm.StageSample(*s) for s in samples],
                             jpm.H100_DGX, onesided=onesided)
        assert (got.n_h2d, got.n_remote) == (want.n_h2d, want.n_remote)
        _same_hw(got.hw, want.hw)
        assert got.hw.gather_overhead_s >= 0 and got.hw.host_Bps > 0
    with pytest.raises(ValueError) as got:
        pm.stage_time_error([pm.StageSample("nope", 1.0, 1.0)], pm.H100_DGX)
    with pytest.raises(ValueError) as want:
        jpm.stage_time_error([jpm.StageSample("nope", 1.0, 1.0)],
                             jpm.H100_DGX)
    assert str(got.value) == str(want.value)


def test_calibrate_reads_a_tracer():
    """``calibrate`` takes anything with ``stage_samples()``."""
    class Source:
        def stage_samples(self):
            return [pm.StageSample("h2d", 1e-3, 1e5),
                    pm.StageSample("h2d", 3e-3, 3e5)]

    res = pm.calibrate(Source())
    assert res.n_h2d == 2 and res.base == pm.H100_DGX
    assert res.hw.host_Bps == pytest.approx(1e8)


# ---------------------------------------------------------------------------
# sharding_plan parity
# ---------------------------------------------------------------------------

def _specs(mod, rows_dims):
    return [mod.TableSpec(name, rows=r, dim=d, pooling=p)
            for name, r, d, p in rows_dims]


def _placements(p):
    return ([(dataclasses.astuple(pl.table), pl.strategy, pl.shard,
              pl.cache_rows, pl.est_hit_rate, pl.est_time_s, pl.index)
             for pl in p.placements], list(p.per_shard_bytes))


FULL = [(f"t{i}", 10**6, 128, 32) for i in range(26)]
# (tables, plan kwargs): the reference tests' table sets and plans A/B
PLANS = {
    "ceil_rw": ([("t", 1000, 32, 4)],
                dict(num_shards=7, batch_per_shard=8, hbm_budget_bytes=1.0)),
    "tw_packs_small": (
        [(f"small{i}", 1000, 32, 4) for i in range(6)]
        + [("huge", 30_000_000, 128, 32)],
        dict(num_shards=8, batch_per_shard=128, hbm_budget_bytes=2.5e9)),
    "unique_names": ([(f"t{i}", 1000, 16, 4) for i in range(3)],
                     dict(num_shards=2, batch_per_shard=8,
                          hbm_budget_bytes=1e9)),
    "duplicate_names": ([("t", 2048, 16, 8)] * 6,
                        dict(num_shards=2, batch_per_shard=8,
                             hbm_budget_bytes=48_000, zipf_a=0.9)),
    "smoke": ([(f"t{i}", 128, 16, 4) for i in range(8)],
              dict(num_shards=2, batch_per_shard=4, hbm_budget_bytes=4000,
                   zipf_a=0.9)),
    "paper_cached": ([(f"t{i}", 50_000_000, 128, 32) for i in range(8)],
                     dict(num_shards=8, batch_per_shard=1024,
                          hbm_budget_bytes=8e9, zipf_a=1.2)),
    "paper_no_budget": ([(f"t{i}", 50_000_000, 128, 32) for i in range(8)],
                        dict(num_shards=8, batch_per_shard=1024,
                             hbm_budget_bytes=1, zipf_a=1.2)),
    "no_zipf": ([("small", 1000, 64, 8), ("big", 10_000_000, 128, 32)],
                dict(num_shards=4, batch_per_shard=256,
                     hbm_budget_bytes=1e9)),
    "remote_hosts": ([(f"t{i}", 8192, 16, 8) for i in range(6)],
                     dict(num_shards=2, batch_per_shard=32,
                          hbm_budget_bytes=190_000, zipf_a=0.9,
                          cache_hosts=4, cache_backend="onesided")),
    "plan_A": (FULL, dict(num_shards=2, batch_per_shard=2048,
                          hbm_budget_bytes=0.5e9, zipf_a=1.05)),
    "plan_B": (FULL, dict(num_shards=16, batch_per_shard=2048,
                          hbm_budget_bytes=0.2e9, zipf_a=1.05)),
    "plan_A_remote": (FULL, dict(num_shards=2, batch_per_shard=2048,
                                 hbm_budget_bytes=0.5e9, zipf_a=1.05,
                                 cache_hosts=4, cache_backend="onesided")),
}


@pytest.mark.parametrize("name, platform", [
    (name, platform) for name in sorted(PLANS)
    for platform in ("H100_DGX", "TPU_V5E")
    if platform == "H100_DGX" or not name.startswith("plan_")])
def test_plan_matches_reference(name, platform):
    """Field by field, on the reference's H100 platform and (as an input
    only: the port does not carry it) on its TPU platform; the full-width
    plans A and B are priced for the H100 only."""
    tables, kw = PLANS[name]
    jhw = getattr(jpm, platform)
    want = jsp.plan(_specs(jsp, tables), hw=jhw, **kw)
    got = sp.plan(_specs(sp, tables), hw=_port_hw(jhw), **kw)
    assert _placements(got) == _placements(want)
    for default in (0, 8, 65_536):
        assert got.cache_rows_vector(len(tables), default=default) == \
            want.cache_rows_vector(len(tables), default=default)


def test_full_width_plans_are_the_stated_ones():
    """Plans A and B, from the port alone (its default platform is
    H100_DGX): A caches 8 tables at 200,000 slots and 2 at 100,000 and
    places 16 row-wise; B caches all 26; under 4 one-sided hosts nothing
    is cached."""
    a = sp.plan(_specs(sp, FULL), **PLANS["plan_A"][1])
    b = sp.plan(_specs(sp, FULL), **PLANS["plan_B"][1])
    remote = sp.plan(_specs(sp, FULL), **PLANS["plan_A_remote"][1])
    assert sp.plan.__kwdefaults__["hw"] is pm.H100_DGX
    assert [pl.cache_rows for pl in sorted(a.placements,
                                           key=lambda p: p.index)] == \
        [200_000] * 8 + [100_000] * 2 + [0] * 16
    assert [pl.strategy for pl in a.placements].count("row") == 16
    assert a.cache_rows_vector(26, default=65_536) == \
        [200_000] * 8 + [100_000] * 2 + [65_536] * 16
    assert b.cache_rows_vector(26) == [200_000] * 16 + [100_000] * 10
    assert {pl.strategy for pl in remote.placements} == {"row"}
    assert round(a.placement_at(0).est_hit_rate, 3) == 0.959
    assert round(a.placement_at(9).est_hit_rate, 3) == 0.941


def test_one_shard_plans_cache_nothing():
    for budget in (0.2e9, 0.5e9, 2e9):
        p = sp.plan(_specs(sp, FULL), num_shards=1, batch_per_shard=2048,
                    hbm_budget_bytes=budget, zipf_a=1.05)
        assert "cached" not in {pl.strategy for pl in p.placements}


def _dup_plan(mod):
    spec = mod.TableSpec("t", rows=1000, dim=16, pooling=4)
    return mod.ShardingPlan(
        [mod.Placement(spec, "cached", 0, 1e-6, cache_rows=64,
                       est_hit_rate=0.9, index=0),
         mod.Placement(spec, "cached", 0, 1e-6, cache_rows=16,
                       est_hit_rate=0.5, index=1),
         mod.Placement(spec, "row", -1, 1e-6, index=2)],
        [64 * 16 * 4])


def _raised(fn):
    try:
        fn()
    except (KeyError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("call", [
    lambda p: p.cache_rows_of("t"), lambda p: p.strategy_of("t"),
    lambda p: p.cache_rows_of("nope"), lambda p: p.placement_at(3),
    lambda p: p.cache_rows_vector(4), lambda p: p.cache_rows_vector(2),
    lambda p: p.cache_rows_vector(3, default=7),
    lambda p: p.placement_at(1).cache_rows,
])
def test_duplicate_names_and_errors_match(call):
    got, want = _dup_plan(sp), _dup_plan(jsp)
    g, w = _raised(lambda: call(got)), _raised(lambda: call(want))
    assert g == w
    if g is None:
        assert call(got) == call(want)


def test_duplicate_placement_index_is_refused_alike():
    def dup(mod):
        spec = mod.TableSpec("t", rows=10, dim=4, pooling=2)
        return mod.ShardingPlan([mod.Placement(spec, "row", -1, 0.0,
                                               index=0)] * 2, [0])

    assert _raised(lambda: dup(sp).cache_rows_vector(2)) == \
        _raised(lambda: dup(jsp).cache_rows_vector(2))
    assert sp.CACHE_RATIOS == jsp.CACHE_RATIOS


# ---------------------------------------------------------------------------
# The engines over a plan (the sweep's SMOKE shape), against the reference
# ---------------------------------------------------------------------------

def _smoke_shape_cfgs():
    s = SMOKE
    fields = dict(num_sparse_features=s["tables"], rows_per_table=s["rows"],
                  embedding_dim=s["dim"], pooling=s["pooling"],
                  bottom_mlp=(32, s["dim"]))
    jcfg = dataclasses.replace(jcfg_mod.smoke(), kernel_mode="reference",
                               **fields)
    return jcfg, dataclasses.replace(tcfg_mod.smoke(), **fields)


def _smoke_shape_plan(mod):
    s = SMOKE
    specs = [mod.TableSpec(f"t{i}", rows=s["rows"], dim=s["dim"],
                           pooling=s["pooling"]) for i in range(s["tables"])]
    hw = jpm.H100_DGX if mod is jsp else pm.H100_DGX
    return mod.plan(specs, num_shards=2, batch_per_shard=s["batch"],
                    hbm_budget_bytes=s["budget"], hw=hw, zipf_a=s["zipf"])


@pytest.fixture(scope="module")
def smoke_shape():
    jcfg, tcfg = _smoke_shape_cfgs()
    jparams = jdlrm.init_params(jax.random.key(5), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, tcfg, params


def _zipf_requests(cfg, n, seed, a=0.9):
    """The sweep's traffic: zipf(a) ids, full lengths, one request per
    column of a random batch."""
    T, L, F = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    rng = np.random.default_rng(seed)
    b = random_jagged_batch(rng, T, n, L, cfg.rows_per_table, zipf_a=a,
                            device="cpu")
    idx = b.indices.numpy()
    dense = rng.standard_normal((n, F)).astype(np.float32)
    return [dict(rid=i, dense=dense[i], indices=idx[:, i, :].copy(),
                 lengths=np.full(T, L, np.int32)) for i in range(n)]


def _serve(engine, cls, reqs):
    for r in reqs:
        engine.submit(cls(**r))
    return engine.run_to_completion()


def _with_plan(cfg, p, **cache):
    return dataclasses.replace(cfg, sharding_plan=p,
                               cache=dataclasses.replace(cfg.cache, **cache))


def _same_counters(got, want):
    assert [getattr(got, k) for k in COUNTERS] == \
        [getattr(want, k) for k in COUNTERS]
    for k in PER_TABLE:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    np.testing.assert_array_equal(got.hit_rate_t, want.hit_rate_t)


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_over_plan_matches_reference(smoke_shape, depth):
    jcfg, jparams, tcfg, params = smoke_shape
    jp, tp = _smoke_shape_plan(jsp), _smoke_shape_plan(sp)
    jc = _with_plan(jcfg, jp, pipeline_depth=depth)
    tc = _with_plan(tcfg, tp, pipeline_depth=depth)
    assert tc.cache_rows_vector() == jc.cache_rows_vector()
    assert len(set(tc.cache_rows_vector())) >= 2       # heterogeneous
    assert tc.embedding_config().cache.rows_per_table == \
        jc.embedding_config().cache.rows_per_table
    reqs = _zipf_requests(tcfg, 48, seed=7)
    want = _serve(jmake_engine(jparams, jc, SMOKE["batch"]), JRequest, reqs)
    eng = make_dlrm_engine(params, tc, SMOKE["batch"], device="cpu")
    assert isinstance(eng, PipelinedDLRMEngine if depth > 1 else DLRMEngine)
    got = _serve(eng, CTRRequest, reqs)
    assert sorted(got) == sorted(want) == list(range(48))
    np.testing.assert_allclose([got[k] for k in range(48)],
                               [want[k] for k in range(48)], **PCTR)
    jeng = jmake_engine(jparams, jc, SMOKE["batch"])
    _serve(jeng, JRequest, reqs)
    _same_counters(eng.cache_stats(), jeng.cache_stats())
    assert eng.cache_stats().fetch_host > 0
    assert eng.cache_stats().evictions > 0       # small pools churn


def test_plan_engines_bitwise_inside_the_port(smoke_shape):
    """Cached over a plan == uncached, and the pipelined engine over a plan
    with no cache.rows == the serialized one, bitwise."""
    _, _, tcfg, params = smoke_shape
    tp = _smoke_shape_plan(sp)
    assert tcfg.cache.rows == 0 and not tcfg.cache.enabled
    reqs = _zipf_requests(tcfg, 40, seed=8)
    uncached = _serve(DLRMEngine(params, tcfg, SMOKE["batch"],
                                 device="cpu"), CTRRequest, reqs)
    serial = DLRMEngine(params, _with_plan(tcfg, tp), SMOKE["batch"],
                        device="cpu")
    assert serial.cache is not None and serial.params["tables"] is None
    got_s = _serve(serial, CTRRequest, reqs)
    piped = make_dlrm_engine(params, _with_plan(tcfg, tp, pipeline_depth=2),
                             SMOKE["batch"], device="cpu")
    assert isinstance(piped, PipelinedDLRMEngine)
    got_p = _serve(piped, CTRRequest, reqs)
    assert got_s == uncached and got_p == got_s


def test_both_pools_take_the_plan_vector(smoke_shape):
    _, _, tcfg, params = smoke_shape
    tc = _with_plan(tcfg, _smoke_shape_plan(sp), pipeline_depth=2)
    vec = np.asarray(tc.cache_rows_vector())
    eng = make_dlrm_engine(params, tc, SMOKE["batch"], device="cpu")
    ring = eng.cache
    assert isinstance(ring, DoubleBufferedSlotPool) and ring.depth == 2
    for buf in ring.buffers:
        np.testing.assert_array_equal(buf.mgr.slots_per_table, vec)
        assert buf.pool.shape == (int(vec.sum()), tcfg.embedding_dim)
        assert buf.pool_bytes == pm.slot_pool_bytes(vec, tcfg.embedding_dim)
    assert ring.pool_bytes == 2 * pm.slot_pool_bytes(vec, tcfg.embedding_dim)


def test_fallback_slots_follow_the_reference(smoke_shape):
    """Non-"cached" placements take cache.rows, or pooling at rows=0."""
    jcfg, _, tcfg, _ = smoke_shape
    spec = (sp.TableSpec("t", rows=2048, dim=16, pooling=8),
            jsp.TableSpec("t", rows=2048, dim=16, pooling=8))

    def half(mod, s):
        return mod.ShardingPlan(
            [mod.Placement(s, "cached" if i % 2 else "row", 0, 0.0,
                           cache_rows=100 + i, index=i) for i in range(6)],
            [0])

    for rows in (0, 32):
        tc = _with_plan(tcfg, half(sp, spec[0]), rows=rows)
        jc = _with_plan(jcfg, half(jsp, spec[1]), rows=rows)
        assert tc.cache_rows_vector() == jc.cache_rows_vector()
        assert tc.cache_rows_vector()[0] == (rows or tcfg.pooling)
    assert tcfg.cache_rows_vector() is None and \
        tcfg.embedding_config().cache.rows_per_table is None


def test_plan_pool_below_pooling_refused_alike(smoke_shape):
    jcfg, jparams, tcfg, params = smoke_shape

    def tiny(mod):
        s = mod.TableSpec("t", rows=2048, dim=16, pooling=8)
        return mod.ShardingPlan(
            [mod.Placement(s, "cached", 0, 1e-6,
                           cache_rows=8 - (i % 2), est_hit_rate=0.5,
                           index=i) for i in range(6)], [0])

    with pytest.raises(ValueError) as want:
        JEngine(jparams, dataclasses.replace(jcfg, sharding_plan=tiny(jsp)),
                batch_size=2)
    for depth in (1, 2):
        with pytest.raises(ValueError) as got:
            make_dlrm_engine(params, _with_plan(tcfg, tiny(sp),
                                                pipeline_depth=depth),
                             2, device="cpu")
        assert str(got.value) == str(want.value)
        assert "smaller than pooling" in str(got.value)


# ---------------------------------------------------------------------------
# The reference's single-device round-trip tests, held against the port
# ---------------------------------------------------------------------------

def _bag_cfgs(T=3, R=256, D=8, per_table=(64, 16, 32), **cache):
    j = JBagConfig(num_tables=T, rows_per_table=R, dim=D,
                   kernel_mode="reference",
                   cache=JCacheConfig(rows_per_table=per_table, **cache))
    t = teb.EmbeddingBagConfig(num_tables=T, rows_per_table=R, dim=D,
                               cache=CacheConfig(rows_per_table=per_table,
                                                 **cache))
    return j, t


def _tables_np(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * shape[-1] ** -0.5).astype(
        np.float32)


def _batches(seed, n, T, B, L, R, **kw):
    rng = np.random.default_rng(seed)
    return [random_jagged_batch(rng, T, B, L, R, device="cpu", **kw)
            for _ in range(n)]


def _j(batch):
    return JJagged(jnp.asarray(batch.indices.numpy()),
                   jnp.asarray(batch.lengths.numpy()))


def test_heterogeneous_pools_bitwise_under_churn():
    jc, tc = _bag_cfgs()
    tables = _tables_np((3, 256, 8), 0)
    jbag = JBag(tables, jc)
    bag = CachedEmbeddingBag(torch.as_tensor(tables), tc, device="cpu")
    assert (bag.mgr.slots_per_table == [64, 16, 32]).all()
    assert bag.pool.shape == (64 + 16 + 32, 8)
    assert bag.pool_bytes == (64 + 16 + 32) * 8 * 4
    for b in _batches(0, 6, 3, 8, 5, 256, fixed_pooling=False, zipf_a=1.1):
        got = bag.lookup(b)
        assert torch.equal(got, teb.pooled_lookup_local(
            torch.as_tensor(tables), b, tc))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jbag.lookup(_j(b))),
                                   rtol=1e-6, atol=1e-6)
    _same_counters(bag.stats, jbag.stats)
    assert bag.stats.evictions_t[1] > 0
    for t in range(3):
        st = bag.mgr.slots_per_table[t]
        assert bag.mgr.slot_of_id[t].max() < st
        res = bag.mgr.resident_ids(t)
        np.testing.assert_array_equal(res, jbag.mgr.resident_ids(t))
        slots = bag.mgr.slot_of_id[t][res]
        assert np.array_equal(np.sort(bag.mgr.id_of_slot_t(t)[slots]), res)
        assert bag.mgr.id_of_slot_t(t).size == st


def test_per_table_capacity_error_is_isolated_and_atomic():
    jc, tc = _bag_cfgs(per_table=(64, 4, 64))
    tables = _tables_np((3, 256, 8), 1)
    jbag = JBag(tables, jc)
    bag = CachedEmbeddingBag(torch.as_tensor(tables), tc, device="cpu")
    idx = np.zeros((3, 2, 3), np.int32)
    idx[1] = np.arange(6).reshape(2, 3)
    lens = np.full((3, 2), 3, np.int32)
    with pytest.raises(CacheCapacityError, match="table 1") as got:
        bag.prefetch_arrays(idx, lens)
    with pytest.raises(Exception) as want:
        jbag.prefetch_arrays(idx, lens)
    assert str(got.value) == str(want.value)
    assert bag.mgr.resident_rows == 0 and bag.stats.lookups == 0
    idx[1] = 0
    np.testing.assert_array_equal(bag.prefetch_arrays(idx, lens),
                                  jbag.prefetch_arrays(idx, lens))


def test_per_table_stats_splits_sum_to_totals():
    jc, tc = _bag_cfgs(per_table=(64, 24, 32))
    tables = _tables_np((3, 256, 8), 2)
    jbag = JBag(tables, jc)
    bag = CachedEmbeddingBag(torch.as_tensor(tables), tc, device="cpu")
    for b in _batches(1, 4, 3, 8, 5, 256, zipf_a=1.2):
        bag.prefetch(b)
        jbag.prefetch(_j(b))
    s = bag.stats
    _same_counters(s, jbag.stats)
    assert int(s.hits_t.sum()) == s.hits
    assert int(s.misses_t.sum()) == s.misses
    assert int(s.evictions_t.sum()) == s.evictions
    counts = lambda d: {k: v for k, v in d.items()         # noqa: E731
                        if not k.endswith("_s") and "overlap" not in k}
    assert counts(s.as_dict()) == counts(jbag.stats.as_dict())
    s.reset()
    assert s.hits_t is None and s.hit_rate_t is None


def test_scalar_cache_rows_path_unchanged():
    base = dict(num_tables=2, rows_per_table=128, dim=8)
    cfg_s = teb.EmbeddingBagConfig(cache=CacheConfig(rows=16), **base)
    cfg_v = teb.EmbeddingBagConfig(
        cache=CacheConfig(rows_per_table=(16, 16)), **base)
    tables = torch.as_tensor(_tables_np((2, 128, 8), 3))
    a = CachedEmbeddingBag(tables, cfg_s, device="cpu")
    b = CachedEmbeddingBag(tables, cfg_v, device="cpu")
    for batch in _batches(2, 5, 2, 6, 4, 128, zipf_a=1.2):
        assert torch.equal(a.lookup(batch), b.lookup(batch))
    assert (a.mgr.slot_of_id == b.mgr.slot_of_id).all()
    assert a.stats.as_dict()["hits"] == b.stats.as_dict()["hits"]


@pytest.mark.parametrize("args", [
    dict(num_tables=3, rows=64, slots=[8, 8]),
    dict(num_tables=2, rows=64, slots=[8, 0]),
])
def test_manager_slot_vector_validation(args):
    with pytest.raises(ValueError) as got:
        SlotPoolManager(**args)
    with pytest.raises(ValueError) as want:
        JManager(**args)
    assert str(got.value) == str(want.value)
    m = SlotPoolManager(2, rows=8, slots=[100, 4])
    assert m.slots_per_table.tolist() == [8, 4] and m.S == 8


def test_warmup_then_serve_lru_eviction_order():
    cache = dict(rows=2, policy="lru")
    freqs = np.zeros((1, 32))
    freqs[0, 0], freqs[0, 1] = 5, 4
    tables = _tables_np((1, 32, 4), 4)
    tcfg = teb.EmbeddingBagConfig(
        num_tables=1, rows_per_table=32, dim=4,
        cache=CacheConfig(warmup_freqs=freqs, **cache))
    jcfg = JBagConfig(num_tables=1, rows_per_table=32, dim=4,
                      kernel_mode="reference",
                      cache=JCacheConfig(warmup_freqs=freqs, **cache))
    bag = CachedEmbeddingBag(torch.as_tensor(tables), tcfg, device="cpu")
    jbag = JBag(tables, jcfg)
    assert set(bag.mgr.resident_ids(0)) == {0, 1} and bag.mgr.tick == 1
    for ids, want in (([0], {0, 1}), ([5], {0, 5}), ([9], {5, 9})):
        arr = np.array(ids, np.int32).reshape(1, 1, -1)
        lens = np.full((1, 1), len(ids), np.int32)
        bag.prefetch_arrays(arr, lens)
        jbag.prefetch_arrays(arr, lens)
        assert set(bag.mgr.resident_ids(0)) == want == \
            set(jbag.mgr.resident_ids(0))


def test_expected_unique_misses_matches_monte_carlo():
    rng = np.random.default_rng(0)
    for a, R, c, n in ((0.6, 512, 64, 512), (1.0, 512, 64, 256),
                       (1.2, 1024, 128, 512)):
        b = random_jagged_batch(rng, 200, 1, n, R, zipf_a=a, device="cpu")
        ids = b.indices.numpy().reshape(200, n)
        if a > 1:
            resident = lambda x: (x < c - 1) | (x == R - 1)  # noqa: E731
        else:
            resident = lambda x: x < c                        # noqa: E731
        mc = np.mean([len(np.unique(row[~resident(row)])) for row in ids])
        model = pm.expected_unique_misses(a, R, c, n)
        assert abs(model - mc) / mc < 0.05, (a, model, mc)
    old = (1 - pm.zipf_hit_rate(0.6, 512, 64)) * 512
    assert old > pm.expected_unique_misses(0.6, 512, 64, 512) * 1.3
    with np.errstate(all="raise"):
        for a in (0.6, 1.0, 1.2):
            assert 0.0 < pm.expected_unique_misses(a, 1000, 0, 64) <= 64.0
        assert pm.expected_unique_misses(1.2, 1000, 1000, 64) == 0.0


def test_unique_miss_pricing_matches_measured_warm_sweep():
    """A warm LFU bag of the port: measured unique fetched rows per batch
    within 10 % of expected_unique_misses, the hit rate within 0.03 of
    zipf_hit_rate, and every counter the reference bag's."""
    T, R, c, B, L, a = 2, 8192, 1024, 32, 8, 1.0
    freqs = np.arange(1, R + 1, dtype=np.float64) ** -a * 1e6
    tables = _tables_np((T, R, 8), 5)
    bag = CachedEmbeddingBag(
        torch.as_tensor(tables),
        teb.EmbeddingBagConfig(num_tables=T, rows_per_table=R, dim=8,
                               cache=CacheConfig(rows=c,
                                                 warmup_freqs=freqs)),
        device="cpu")
    jbag = JBag(tables, JBagConfig(num_tables=T, rows_per_table=R, dim=8,
                                   kernel_mode="reference",
                                   cache=JCacheConfig(rows=c,
                                                      warmup_freqs=freqs)))
    batches = _batches(3, 38, T, B, L, R, zipf_a=a)
    for b in batches[:8]:
        bag.prefetch_arrays(b.indices.numpy(), b.lengths.numpy())
        jbag.prefetch_arrays(b.indices.numpy(), b.lengths.numpy())
    bag.stats.reset()
    jbag.stats.reset()
    for b in batches[8:]:
        bag.prefetch_arrays(b.indices.numpy(), b.lengths.numpy())
        jbag.prefetch_arrays(b.indices.numpy(), b.lengths.numpy())
    _same_counters(bag.stats, jbag.stats)
    measured = bag.stats.fetch_host / 30
    model = T * pm.expected_unique_misses(a, R, c, B * L)
    assert abs(measured - model) / measured < 0.10, (measured, model)
    assert abs(bag.stats.hit_rate - pm.zipf_hit_rate(a, R, c)) < 0.03


def test_engine_consumes_sharding_plan():
    """The reference's smoke plan (T=8, R=128, pooling 4) through the
    port's engine, against the reference's engine and the port's direct
    forward."""
    jcfg = dataclasses.replace(jcfg_mod.smoke(), kernel_mode="reference")
    tcfg = tcfg_mod.smoke()
    kw = PLANS["smoke"][1]
    jp = jsp.plan(_specs(jsp, PLANS["smoke"][0]), hw=jpm.H100_DGX, **kw)
    tp = sp.plan(_specs(sp, PLANS["smoke"][0]), hw=pm.H100_DGX, **kw)
    jparams = jdlrm.init_params(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    jc = dataclasses.replace(jcfg, sharding_plan=jp)
    tc = dataclasses.replace(tcfg, sharding_plan=tp)
    vec = tc.cache_rows_vector()
    assert vec == jc.cache_rows_vector() and len(set(vec)) >= 2
    eng = make_dlrm_engine(params, tc, batch_size=4, device="cpu")
    assert type(eng) is DLRMEngine and eng.params["tables"] is None
    assert (eng.cache.mgr.slots_per_table == np.asarray(vec)).all()
    rng = np.random.default_rng(4)
    T, L, F = 8, 4, 4
    reqs = [dict(rid=i, dense=rng.standard_normal(F).astype(np.float32),
                 indices=rng.integers(0, 128, (T, L)).astype(np.int32),
                 lengths=rng.integers(1, L + 1, T).astype(np.int32))
            for i in range(10)]
    got = _serve(eng, CTRRequest, reqs)
    jeng = jmake_engine(jparams, jc, batch_size=4)
    want = _serve(jeng, JRequest, reqs)
    np.testing.assert_allclose([got[i] for i in range(10)],
                               [want[i] for i in range(10)], **PCTR)
    _same_counters(eng.cache_stats(), jeng.cache_stats())
    # the direct forward, request by request: other batch shapes, so
    # within the reference's own 1e-6 rather than bitwise
    direct = _serve(DLRMEngine(params, tcfg, 1, device="cpu"), CTRRequest,
                    reqs)
    np.testing.assert_allclose([got[i] for i in range(10)],
                               [direct[i] for i in range(10)], rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The remote-tier plan checks (tests/_plan_checks.py), reference in a
# subprocess with 4 forced CPU devices
# ---------------------------------------------------------------------------

def _remote_requests(n, seed):
    """_plan_checks.py's traffic: Zipf(1.2) ranks with a shifting id window
    so the small pools churn while hot rows repeat."""
    cfg = tcfg_mod.smoke()
    T, L, F = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    R = cfg.rows_per_table
    rng = np.random.default_rng(seed)
    idx, lens, dense = [], [], []
    for rid in range(n):
        ranks = np.minimum(rng.zipf(1.2, size=(T, L)) - 1, R - 1)
        window = (ranks + (rid // 3) * (R // 4)) % R
        idx.append(np.where(rng.random((T, L)) < 0.33, window, ranks))
        dense.append(rng.standard_normal(F).astype(np.float32))
        lens.append(rng.integers(1, L + 1, T).astype(np.int32))
    return (np.asarray(dense), np.asarray(idx, np.int32),
            np.asarray(lens, np.int32))


def _remote_inputs() -> dict:
    x = {}
    x["dense"], x["idx"], x["lens"] = _remote_requests(24, seed=1)
    x["bag_tables"] = _tables_np((2, 256, 8), 2)
    rng = np.random.default_rng(3)
    bag_idx = []
    for i in range(6):
        lo = (i * 32) % 192
        b = rng.integers(lo, lo + 24, (2, 2, 4))
        b[1] = rng.integers(lo, lo + 8, (2, 4))
        bag_idx.append(b)
    x["bag_idx"] = np.asarray(bag_idx, np.int32)
    return x


def _stats_vector(s):
    return np.concatenate([[getattr(s, k) for k in COUNTERS]]
                          + [getattr(s, k) for k in PER_TABLE]).astype(
                              np.int64)


def _jax_reference(inputs: Path, outputs: Path) -> None:
    """The reference's side of _plan_checks.py on ``inputs``; runs in the
    subprocess, with four forced CPU devices."""
    from repro.cache import RemoteStore as JRemoteStore
    from repro.core.embedding_bag import pooled_lookup_local as jlookup

    assert len(jax.devices()) == H, jax.devices()
    x = dict(np.load(inputs))
    out = {}
    base = dataclasses.replace(
        jcfg_mod.smoke(), kernel_mode="reference",
        cache=JCacheConfig(cold_tier="remote", remote_hosts=H,
                           policy="lru"))
    p = jsp.plan(_specs(jsp, PLANS["smoke"][0]), hw=jpm.H100_DGX,
                 **PLANS["smoke"][1])
    cfg = dataclasses.replace(base, sharding_plan=p)
    params = jax.tree_util.tree_map(
        np.asarray, jdlrm.init_params(jax.random.key(0), base))
    out["tables"] = params["tables"]
    for part in ("bottom", "top"):
        for i, layer in enumerate(params[part]):
            out[f"{part}_{i}_w"], out[f"{part}_{i}_b"] = layer["w"], layer["b"]
    out["vector"] = np.asarray(cfg.cache_rows_vector())
    for depth in (1, 2):
        eng = jmake_engine(params, dataclasses.replace(
            cfg, cache=dataclasses.replace(cfg.cache, pipeline_depth=depth)),
            batch_size=3)
        bufs = getattr(eng.cache, "buffers", [eng.cache])
        assert all(isinstance(b.cold, JRemoteStore) for b in bufs)
        for i in range(len(x["idx"])):
            eng.submit(JRequest(rid=i, dense=x["dense"][i],
                                indices=x["idx"][i], lengths=x["lens"][i]))
        scores = eng.run_to_completion()
        out[f"scores_{depth}"] = np.array([scores[i]
                                           for i in range(len(x["idx"]))])
        out[f"stats_{depth}"] = _stats_vector(eng.cache_stats())
    bcfg = JBagConfig(num_tables=2, rows_per_table=256, dim=8,
                      kernel_mode="reference",
                      cache=JCacheConfig(rows_per_table=(32, 8),
                                         cold_tier="remote", remote_hosts=H,
                                         policy="lru"))
    bag = JBag(x["bag_tables"], bcfg)
    pooled = []
    for idx in x["bag_idx"]:
        b = JJagged(jnp.asarray(idx), jnp.full((2, 2), 4, jnp.int32))
        got = np.asarray(bag.lookup(b))
        np.testing.assert_array_equal(got, np.asarray(jlookup(
            jnp.asarray(x["bag_tables"]), b, bcfg)))
        pooled.append(got)
    out["bag_pooled"] = np.asarray(pooled)
    out["bag_stats"] = _stats_vector(bag.stats)
    idx = np.zeros((2, 3, 3), np.int32)
    idx[1] = np.arange(9).reshape(3, 3)
    try:
        bag.prefetch_arrays(idx, np.full((2, 3), 3, np.int32))
        out["bag_error"] = np.array("")
    except Exception as e:  # noqa: BLE001 -- the message is compared
        out["bag_error"] = np.array(str(e))
    np.savez(outputs, **out)


@pytest.fixture(scope="module")
def remote_ref(tmp_path_factory):
    """(inputs, the JAX reference's outputs), computed once per module."""
    tmp = tmp_path_factory.mktemp("plan_ref")
    x = _remote_inputs()
    np.savez(tmp / "inputs.npz", **x)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={H}"}
    proc = subprocess.run(
        [sys.executable, __file__, str(tmp / "inputs.npz"),
         str(tmp / "outputs.npz")], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return x, dict(np.load(tmp / "outputs.npz"))


def test_plan_driven_remote_serialized_and_pipelined(remote_ref):
    """A planner-made heterogeneous plan over the remote tier (4 hosts,
    LRU): serialized and depth 2 bitwise the port's uncached scores and
    each other, within PCTR of the reference, counters exact."""
    x, want = remote_ref
    tcfg = tcfg_mod.smoke()
    params = params_from_numpy(
        {"tables": want["tables"],
         **{part: [{"w": want[f"{part}_{i}_w"], "b": want[f"{part}_{i}_b"]}
                   for i in range(len(getattr(tcfg, f"{part}_mlp")))]
            for part in ("bottom", "top")}}, device="cpu")
    p = sp.plan(_specs(sp, PLANS["smoke"][0]), **PLANS["smoke"][1])
    base = dataclasses.replace(tcfg, cache=CacheConfig(
        cold_tier="remote", remote_hosts=H, policy="lru"))
    assert list(dataclasses.replace(base, sharding_plan=p)
                .cache_rows_vector()) == want["vector"].tolist()
    n = len(x["idx"])
    reqs = [dict(rid=i, dense=x["dense"][i], indices=x["idx"][i],
                 lengths=x["lens"][i]) for i in range(n)]
    direct = _serve(DLRMEngine(params, tcfg, 3, device="cpu"), CTRRequest,
                    reqs)
    scores = {}
    for depth in (1, 2):
        eng = make_dlrm_engine(params, _with_plan(base, p,
                                                  pipeline_depth=depth),
                               3, device="cpu")
        bufs = getattr(eng.cache, "buffers", [eng.cache])
        for b in bufs:
            np.testing.assert_array_equal(b.mgr.slots_per_table,
                                          want["vector"])
            assert b.cold.tier == "remote" and b.cold.hosts == H
        scores[depth] = _serve(eng, CTRRequest, reqs)
        np.testing.assert_allclose([scores[depth][i] for i in range(n)],
                                   want[f"scores_{depth}"], **PCTR)
        np.testing.assert_array_equal(_stats_vector(eng.cache_stats()),
                                      want[f"stats_{depth}"])
        s = eng.cache_stats()
        assert s.evictions > 0 and s.misses_remote > 0
        small = np.flatnonzero(want["vector"] == want["vector"].min())
        assert s.evictions_t[small].sum() > 0
    assert scores[1] == direct and scores[2] == scores[1]


def test_per_table_pools_remote_churn(remote_ref):
    x, want = remote_ref
    cfg = teb.EmbeddingBagConfig(
        num_tables=2, rows_per_table=256, dim=8,
        cache=CacheConfig(rows_per_table=(32, 8), cold_tier="remote",
                          remote_hosts=H, policy="lru"))
    tables = torch.as_tensor(x["bag_tables"])
    bag = CachedEmbeddingBag(tables, cfg, device="cpu")
    assert bag.mgr.S == 32 and bag.pool.shape == (32 + 8, 8)
    for k, idx in enumerate(x["bag_idx"]):
        b = JaggedBatch(torch.as_tensor(idx),
                        torch.full((2, 2), 4, dtype=torch.int32))
        got = bag.lookup(b)
        assert torch.equal(got, teb.pooled_lookup_local(tables, b, cfg))
        np.testing.assert_allclose(got.numpy(), want["bag_pooled"][k],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_stats_vector(bag.stats),
                                  want["bag_stats"])
    assert bag.stats.evictions_t[1] > 0 and bag.stats.misses_remote > 0
    idx = np.zeros((2, 3, 3), np.int32)
    idx[1] = np.arange(9).reshape(3, 3)
    before = bag.mgr.resident_rows
    with pytest.raises(CacheCapacityError) as err:
        bag.prefetch_arrays(idx, np.full((2, 3), 3, np.int32))
    assert str(err.value) == str(want["bag_error"]) and "table 1" in \
        str(err.value)
    assert bag.mgr.resident_rows == before


if __name__ == "__main__":
    _jax_reference(Path(sys.argv[1]), Path(sys.argv[2]))
