"""The port's pipelined DLRM engine (``repro_torch.pipeline`` and
``PipelinedDLRMEngine``) and its protocol checkers against the JAX
reference's, on the CPU, at the smoke config.

Inside the port, depth 2 is held BITWISE to depth 1 (the pooled output
does not depend on which slots hold a row).  Against the reference's
``PipelinedDLRMEngine`` (``kernel_mode="reference"``) pCTR agrees to
``rtol=1e-4, atol=1e-5``, the cached engine's tolerance in
test_torch_serving, and the ring's admission counters agree exactly: both
run the same numpy state machine on the same ids.  On the CPU the
scheduler has no streams to order; the side-stream ordering runs on the
card (``chip_smoke.py`` phase 6b).
"""
import dataclasses
import json
import os
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

from repro.analysis import protocol as jproto
from repro.cache import CacheConfig as JCacheConfig
from repro.configs import dlrm as jcfg_mod
from repro.core.embedding_bag import EmbeddingBagConfig as JBagConfig
from repro.models import dlrm as jdlrm
from repro.pipeline import DoubleBufferedSlotPool as JRing
from repro.pipeline import PipelineTrace as JTrace
from repro.serving.engine import CTRRequest as JRequest
from repro.serving.engine import make_dlrm_engine as jmake_engine
from repro_torch.analysis import (EpochReplay, check_scheduler_source,
                                  check_timeline, extract_scheduler_events,
                                  load_timeline)
from repro_torch.cache.manager import CacheCapacityError
from repro_torch.cache.stats import CacheStats
from repro_torch.configs import dlrm as tcfg_mod
from repro_torch.core.cache_config import CacheConfig
from repro_torch.core.embedding_bag import EmbeddingBagConfig
from repro_torch.kernels import build as kbuild
from repro_torch.pipeline import STAGES, DoubleBufferedSlotPool, PipelineTrace
from repro_torch.serving.engine import (CTRRequest, DLRMEngine,
                                        PipelinedDLRMEngine, make_dlrm_engine)
from repro_torch.utils.convert import params_from_numpy

PCTR = dict(rtol=1e-4, atol=1e-5)
COUNTERS = ("hits", "misses", "misses_host", "misses_remote", "evictions",
            "bytes_h2d", "bytes_remote", "fetch_host", "fetch_remote",
            "batches")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jcfg_mod.smoke(), kernel_mode="reference")
    jparams = jdlrm.init_params(jax.random.key(3), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, tcfg_mod.smoke(), params


def _with_cache(cfg, **cache):
    return dataclasses.replace(cfg, cache=CacheConfig(**cache))


def _requests(cfg, n, seed, churn=0):
    """Zipf(1.2) traffic, lengths in [1, L]; ``churn`` shifts 40 % of the
    ids of every other request, so LRU pools evict across flushes."""
    T, L, F = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    R = cfg.rows_per_table
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        idx = np.minimum(rng.zipf(1.2, size=(T, L)) - 1, R - 1)
        if churn:
            shifted = (idx + (rid // 2) * churn) % R
            idx = np.where(rng.random((T, L)) < 0.4, shifted, idx)
        out.append(dict(rid=rid,
                        dense=rng.standard_normal(F).astype(np.float32),
                        indices=idx.astype(np.int32),
                        lengths=rng.integers(1, L + 1, T).astype(np.int32)))
    return out


def _score(engine, cls, reqs):
    for r in reqs:
        engine.submit(cls(**r))
    return engine.run_to_completion()


def _bitwise(got, want, n):
    assert sorted(got) == sorted(want) == list(range(n))
    assert all(got[rid] == want[rid] for rid in want)


# ---------------------------------------------------------------------------
# DoubleBufferedSlotPool: the epoch swap protocol
# ---------------------------------------------------------------------------

def _bag_cfg(cache_rows=16):
    return EmbeddingBagConfig(num_tables=2, rows_per_table=64, dim=8,
                              cache=CacheConfig(rows=cache_rows))


def _tables(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, 64, 8), generator=g) * 8 ** -0.5


def _stale_error(ring):
    """Commit a plan across a dropped swap; return the refusal's text."""
    idx = np.arange(8, dtype=np.int32).reshape(2, 2, 2)
    lens = np.full((2, 2), 2, np.int32)
    plan = ring.prepare_next(idx, lens)
    rows = ring.fetch_next(plan)
    ring.swap()                                   # injected extra swap
    with pytest.raises(RuntimeError, match="stale prefetch plan") as err:
        ring.commit_next(plan, rows)
    return str(err.value)


def test_double_buffer_epoch_swap_protocol():
    tables = _tables(0)
    pool = DoubleBufferedSlotPool(tables, _bag_cfg(), depth=2, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        DoubleBufferedSlotPool(tables, _bag_cfg(), depth=1, device="cpu")
    live0, shadow0 = pool.live, pool.shadow
    assert live0 is not shadow0
    assert shadow0.cold is live0.cold          # one shared cold tier...
    # ...over the caller's tables, not a copy of them
    assert shadow0.cold.tables.data_ptr() == tables.data_ptr()
    assert shadow0.stats is pool.stats is live0.stats
    assert pool.pool_bytes == 2 * live0.pool_bytes

    idx = np.arange(8, dtype=np.int32).reshape(1, 2, 4).repeat(2, axis=0)
    plan = pool.prepare_next(idx, None)
    assert plan.epoch == shadow0.mgr.epoch + 1 == 1
    rows = pool.fetch_next(plan)
    assert tuple(rows.shape) == (plan.fetch_rows.size, 8)
    pool.commit_next(plan, rows)
    # the payload landed in the SHADOW pool; the live pool is untouched
    assert shadow0.pool.any() and not live0.pool.any()
    pool.swap()
    assert pool.live is shadow0 and pool.shadow is live0
    assert shadow0.mgr.epoch == 1              # the swap published epoch 1
    # committing the SAME plan again is stale, and the refusal rolls its
    # residency back in its OWNING buffer
    with pytest.raises(RuntimeError, match="stale"):
        pool.commit_next(plan, rows)
    assert (shadow0.mgr.slot_of_id[0, :8] < 0).all()
    # the serialized facade serves from the (new) live buffer
    assert pool.prefetch_arrays(idx, None).shape == idx.shape
    assert torch.equal(pool.pool, shadow0.pool)


def test_stale_commit_refusal_text_matches_reference():
    """A swap dropped between fetch and commit: both rings refuse the plan
    with the same message."""
    tables = _tables(1)
    port = DoubleBufferedSlotPool(tables, _bag_cfg(), depth=2, device="cpu")
    ref = JRing(tables.numpy(),
                JBagConfig(num_tables=2, rows_per_table=64, dim=8,
                           kernel_mode="reference",
                           cache=JCacheConfig(rows=16)), depth=2)
    assert _stale_error(port) == _stale_error(ref)


def test_double_buffer_stale_slot_invalidation_on_fetch_failure():
    """A failed fetch rolls back the shadow buffer's residency (no slot
    claims a row that never arrived), and a retry re-fetches correctly."""
    tables = _tables(2)
    pool = DoubleBufferedSlotPool(tables, _bag_cfg(), depth=2, device="cpu")
    shadow = pool.shadow
    idx = np.arange(6, dtype=np.int32).reshape(1, 2, 3).repeat(2, axis=0)
    plan = pool.prepare_next(idx, None)
    assert (shadow.mgr.slot_of_id[0, :6] >= 0).all()   # residency committed

    def broken(*_):
        raise RuntimeError("injected cold-tier failure")

    real_fetch, shadow.cold.fetch = shadow.cold.fetch, broken
    try:
        with pytest.raises(RuntimeError, match="injected"):
            pool.fetch_next(plan)
    finally:
        shadow.cold.fetch = real_fetch
    assert (shadow.mgr.slot_of_id[0, :6] < 0).all()
    assert (shadow.mgr.id_of_slot < 0).all()
    plan2 = pool.prepare_next(idx, None)
    pool.commit_next(plan2, pool.fetch_next(plan2))
    pool.swap()
    got = pool.live.device_lookup(pool.pool, torch.as_tensor(plan2.remapped),
                                  None, None)
    want = tables[:, :6].reshape(2, 2, 3, 8).sum(dim=2)
    assert torch.equal(got.transpose(0, 1), want)


def test_double_buffer_capacity_error_is_atomic():
    pool = DoubleBufferedSlotPool(_tables(3), _bag_cfg(cache_rows=4),
                                  depth=2, device="cpu")
    idx = np.arange(8, dtype=np.int32).reshape(1, 1, 8).repeat(2, axis=0)
    with pytest.raises(CacheCapacityError):
        pool.prepare_next(idx, None)
    assert (pool.shadow.mgr.id_of_slot < 0).all()  # nothing half-admitted


# ---------------------------------------------------------------------------
# PipelinedDLRMEngine: bitwise equality, parity, fallback, requeue
# ---------------------------------------------------------------------------

def test_pipelined_engine_bitwise_equals_serialized(models):
    """Depth 2 over the host cold tier, LRU churn across 6 flushes: scores
    bitwise-equal to the depth-1 engine; both record the stage timers,
    only the pipeline measures overlap."""
    _, _, tcfg, params = models
    base = _with_cache(tcfg, rows=12, policy="lru")
    serial = make_dlrm_engine(params, base, 4, device="cpu")
    piped = make_dlrm_engine(params, _with_cache(tcfg, rows=12, policy="lru",
                                                 pipeline_depth=2), 4,
                             device="cpu")
    reqs = _requests(tcfg, 24, seed=4, churn=32)
    want = _score(serial, CTRRequest, reqs)
    got = _score(piped, CTRRequest, reqs)
    _bitwise(got, want, 24)
    s, ss = piped.cache_stats(), serial.cache_stats()
    assert s.evictions > 0 and s.batches == 6
    for st in (s, ss):
        assert st.prefetch_s > 0 and st.forward_s > 0 and st.scatter_s >= 0
    assert ss.overlap_s == 0.0 and ss.overlap_fraction == 0.0
    assert s.overlap_s >= 0.0
    for stage in STAGES:
        assert piped.trace.by_stage(stage)
    assert piped.trace.total("forward") == pytest.approx(s.forward_s)
    assert piped.scheduler.fallbacks == 0 and not piped.queue


@pytest.mark.parametrize("policy", ["lfu", "lru"])
def test_pipelined_engine_matches_reference(models, policy):
    """The port's depth 2 against the reference's PipelinedDLRMEngine on
    one stream with churn: pCTR within tolerance, the ring's counters
    (per table too) exactly equal."""
    jcfg, jparams, tcfg, params = models
    jc = dataclasses.replace(jcfg, cache=JCacheConfig(
        rows=12, policy=policy, pipeline_depth=2))
    tc = _with_cache(tcfg, rows=12, policy=policy, pipeline_depth=2)
    reqs = _requests(tcfg, 20, seed=5, churn=32)
    jeng = jmake_engine(jparams, jc, batch_size=4)
    teng = make_dlrm_engine(params, tc, 4, device="cpu")
    want = _score(jeng, JRequest, reqs)
    got = _score(teng, CTRRequest, reqs)
    assert sorted(got) == sorted(want) == list(range(20))
    for rid in want:
        np.testing.assert_allclose(got[rid], want[rid], **PCTR)
    js, ts = jeng.cache_stats(), teng.cache_stats()
    assert ts.evictions > 0
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    for name in ("hits_t", "misses_t", "evictions_t"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    assert [(s.stage, s.batch) for s in teng.trace.spans] == \
        [(s.stage, s.batch) for s in jeng.trace.spans]


@pytest.mark.parametrize("backend", ["bulk", "onesided"])
def test_pipelined_engine_remote_tier_bitwise(models, backend):
    """Depth 2 over the remote cold tier (4 simulated hosts): bitwise equal
    to the port's depth 1 on the same tier, remote misses counted."""
    _, _, tcfg, params = models
    cache = dict(rows=12, policy="lru", cold_tier="remote", remote_hosts=4,
                 remote_backend=backend)
    serial = make_dlrm_engine(params, _with_cache(tcfg, **cache), 4,
                              device="cpu")
    piped = make_dlrm_engine(
        params, _with_cache(tcfg, **cache, pipeline_depth=2), 4,
        device="cpu")
    reqs = _requests(tcfg, 16, seed=6, churn=32)
    want = _score(serial, CTRRequest, reqs)
    got = _score(piped, CTRRequest, reqs)
    _bitwise(got, want, 16)
    ring = piped.cache
    assert ring.buffers[1].cold is ring.buffers[0].cold
    st = piped.cache_stats()
    assert st.misses_remote > 0 and st.evictions > 0


def test_pipeline_overflow_falls_back_to_serialized_flush(models):
    """A micro-batch overflowing the shadow buffer takes the serialized
    CacheCapacityError split path: every request scored, none stranded,
    bitwise equal to depth 1, and within tolerance of the reference."""
    jcfg, jparams, tcfg, params = models
    L, T, F = tcfg.pooling, tcfg.num_sparse_features, tcfg.num_dense_features
    piped = make_dlrm_engine(params, _with_cache(tcfg, rows=L,
                                                 pipeline_depth=2), 2,
                             device="cpu")
    serial = make_dlrm_engine(params, _with_cache(tcfg, rows=L), 2,
                              device="cpu")
    jeng = jmake_engine(jparams, dataclasses.replace(
        jcfg, cache=JCacheConfig(rows=L, pipeline_depth=2)), batch_size=2)
    rng = np.random.default_rng(6)
    # disjoint full-length working sets: every 2-request union overflows
    reqs = [dict(rid=rid, dense=rng.standard_normal(F).astype(np.float32),
                 indices=((np.arange(T * L, dtype=np.int32).reshape(T, L)
                           + rid * L) % tcfg.rows_per_table),
                 lengths=np.full(T, L, np.int32)) for rid in range(5)]
    got = _score(piped, CTRRequest, reqs)
    want = _score(serial, CTRRequest, reqs)
    _bitwise(got, want, 5)
    assert not piped.queue and piped.scheduler.fallbacks == 2
    ref = _score(jeng, JRequest, reqs)
    for rid in ref:
        np.testing.assert_allclose(got[rid], ref[rid], **PCTR)


def test_pipeline_error_requeues_requests(models):
    """A mid-run cold-tier failure loses no request: every submitted
    request goes back on the queue and a retry scores them all."""
    _, _, tcfg, params = models
    piped = make_dlrm_engine(params, _with_cache(tcfg, rows=16,
                                                 pipeline_depth=2), 4,
                             device="cpu")
    serial = make_dlrm_engine(params, _with_cache(tcfg, rows=16), 4,
                              device="cpu")
    reqs = _requests(tcfg, 12, seed=8)
    for r in reqs:
        piped.submit(CTRRequest(**r))
    cold = piped.cache.buffers[0].cold            # shared by both buffers
    real_fetch, calls = cold.fetch, {"n": 0}

    def flaky(t, r):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("transient cold-tier failure")
        return real_fetch(t, r)

    cold.fetch = flaky
    try:
        with pytest.raises(RuntimeError, match="transient"):
            piped.run_to_completion()
    finally:
        cold.fetch = real_fetch
    assert len(piped.queue) == 12                 # nothing lost
    got = piped.run_to_completion()               # clean retry
    want = _score(serial, CTRRequest, reqs)
    _bitwise(got, want, 12)


def test_engine_selection_and_guards(models):
    _, _, tcfg, params = models
    base = _with_cache(tcfg, rows=16)
    assert type(make_dlrm_engine(params, base, 2, device="cpu")) is DLRMEngine
    piped = make_dlrm_engine(params, _with_cache(tcfg, rows=16,
                                                 pipeline_depth=3), 2,
                             device="cpu")
    assert isinstance(piped, PipelinedDLRMEngine)
    assert isinstance(piped.cache, DoubleBufferedSlotPool)
    assert piped.cache.depth == 3 and piped.scheduler.side is None
    # a pipeline without a cache (and without a plan sizing one) has no
    # prefetch stage to overlap
    with pytest.raises(ValueError, match="cache_rows") as err:
        PipelinedDLRMEngine(params, _with_cache(tcfg, rows=0,
                                                pipeline_depth=2), 2,
                            device="cpu")
    assert "sharding_plan" in str(err.value)
    with pytest.raises(ValueError, match="pipeline_depth"):
        PipelinedDLRMEngine(params, base, 2, device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth"):
        CacheConfig(pipeline_depth=0)
    # the cached path scores on one device: a context is refused
    from repro_torch.core.parallel import make_context

    with pytest.raises(NotImplementedError, match="ParallelContext"):
        PipelinedDLRMEngine(params, _with_cache(tcfg, rows=16,
                                                pipeline_depth=2), 2,
                            make_context(tp_size=2), device="cpu")
    # device=None is the card, as for every other entry point
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelinedDLRMEngine(params, _with_cache(tcfg, rows=16,
                                                pipeline_depth=2), 2)


# ---------------------------------------------------------------------------
# Observability: CacheStats stage timers + PipelineTrace
# ---------------------------------------------------------------------------

def test_cache_stats_stage_timers():
    s = CacheStats()
    s.add_time("prefetch", 0.2)
    s.add_time("forward", 0.5)
    s.add_time("scatter", 0.1)
    s.add_time("overlap", 0.15)
    assert s.prefetch_s == pytest.approx(0.2)
    assert s.overlap_fraction == pytest.approx(0.75)
    d = s.as_dict()
    for k in ("prefetch_s", "scatter_s", "forward_s", "overlap_s",
              "overlap_fraction"):
        assert k in d
    with pytest.raises(ValueError, match="stage"):
        s.add_time("gather", 1.0)
    s.reset()
    assert s.prefetch_s == s.overlap_s == 0.0
    assert s.overlap_fraction == 0.0


SYNTHETIC_SPANS = [
    [("forward", 0, 0.0, 1.0), ("fetch", 1, 0.5, 1.5),
     ("admit", 1, 0.9, 1.1), ("scatter", 1, 0.0, 2.0)],
    [("admit", 0, 0.0, 0.3), ("fetch", 0, 0.3, 0.9),
     ("forward", 0, 1.0, 2.0), ("admit", 1, 1.1, 1.4),
     ("fetch", 1, 1.4, 2.6), ("forward", 1, 2.7, 3.5),
     ("admit", 2, 2.8, 3.0), ("fetch", 2, 3.0, 3.2)],
    [("admit", 0, 0.0, 1.0), ("fetch", 0, 1.0, 2.0)],
]


@pytest.mark.parametrize("spans", SYNTHETIC_SPANS)
def test_pipeline_trace_overlap_matches_reference(spans):
    tr, ref = PipelineTrace(), JTrace()
    for s in spans:
        tr.record(*s)
        ref.record(*s)
    assert tr.overlap_s() == ref.overlap_s()
    assert tr.overlap_fraction() == ref.overlap_fraction()
    for stage in STAGES:
        assert tr.total(stage) == ref.total(stage)


def test_pipeline_trace_overlap_measures_intersections():
    tr = PipelineTrace()
    for s in SYNTHETIC_SPANS[0]:
        tr.record(*s)                    # 0.5 + 0.1 s inside the forward
    assert tr.overlap_s() == pytest.approx(0.6)
    assert tr.overlap_fraction() == pytest.approx(0.6 / 1.2)
    with pytest.raises(ValueError, match="stage"):
        tr.record("nope", 0, 0.0, 1.0)
    tr.clear()
    assert tr.overlap_s() == 0.0 and tr.overlap_fraction() == 0.0


# ---------------------------------------------------------------------------
# Protocol checkers: the port's scheduler, recorded traces, the reference's
# ---------------------------------------------------------------------------

REORDERED = """
def run(self, batches):
    for payload in batches:
        plan = self.pool.prepare_next(payload)
        rows = self.pool.fetch_next(plan)
        self.pool.swap()
        self.pool.commit_next(plan, rows)
        self.forward(payload)
"""
MISSING = "def run(self):\n    self.pool.prepare_next(None)\n"


def test_scheduler_source_satisfies_protocol():
    """The port's PipelineScheduler.run, streams and events included,
    extracts to the canonical per-batch order and replays clean."""
    assert extract_scheduler_events() == \
        ["prepare", "fetch", "commit", "serve", "swap"]
    assert check_scheduler_source() == []


@pytest.mark.parametrize("source,kinds", [
    (REORDERED, {"stale-commit", "swap-uncommitted"}),
    (MISSING, {"missing-stage"}),
])
def test_scheduler_source_faults_are_caught_as_in_reference(source, kinds):
    got = {v.kind for v in check_scheduler_source(source)}
    assert got & kinds
    assert got == {v.kind for v in jproto.check_scheduler_source(source)}


def _span(stage, batch, start, end):
    return {"stage": stage, "batch": batch, "start": start, "end": end}


TIMELINES = [
    # clean depth-2 pipeline: batch k+1's scatter overlaps batch k's
    # forward, into the OTHER slot
    [_span("scatter", 0, 0.0, 1.0), _span("forward", 0, 1.5, 3.0),
     _span("scatter", 1, 1.6, 2.5), _span("forward", 1, 3.1, 4.5),
     _span("scatter", 2, 3.2, 4.0), _span("forward", 2, 4.6, 5.0)],
    # batch 2 writes slot 1 while batch 0's forward still reads it
    [_span("scatter", 0, 0.0, 1.0), _span("forward", 0, 1.5, 4.0),
     _span("scatter", 2, 2.0, 3.0)],
    # a scatter still running when its own forward starts
    [_span("scatter", 0, 1.0, 3.0), _span("forward", 0, 2.0, 4.0)],
    # a scatter entirely after its own forward
    [_span("forward", 0, 1.0, 2.0), _span("scatter", 0, 5.0, 6.0)],
]
EVENTS = [
    [("prepare", 1), ("fetch", 1), ("commit", 1), ("serve", 1), ("swap",),
     ("prepare", 2), ("fetch", 2), ("commit", 2), ("serve", 2), ("swap",)],
    [("prepare", 1), ("fetch", 1), ("commit", 1), ("serve", 1), ("swap",),
     ("prepare", 2), ("fetch", 2), ("swap",), ("commit", 2)],
    [("prepare", 1), ("fetch", 1), ("commit", 1), ("commit", 1)],
    [("prepare", 2), ("fetch", 1), ("serve", 1), ("swap",)],
]


@pytest.mark.parametrize("spans", TIMELINES)
def test_check_timeline_matches_reference(spans):
    for depth in (1, 2, 3):
        got = check_timeline(spans, depth=depth)
        want = jproto.check_timeline(spans, depth=depth)
        assert [(v.kind, v.detail) for v in got] == \
            [(v.kind, v.detail) for v in want]


@pytest.mark.parametrize("events", EVENTS)
def test_epoch_replay_matches_reference(events):
    got = EpochReplay().replay(events)
    want = jproto.EpochReplay().replay(events)
    assert [(v.kind, v.detail) for v in got] == \
        [(v.kind, v.detail) for v in want]
    assert bool(got) == (events is not EVENTS[0])


def test_check_timeline_on_a_recorded_trace(models):
    """A recorded CPU trace of the port's engine replays clean; an
    injected race and a scatter after its own dispatch are both caught."""
    _, _, tcfg, params = models
    piped = make_dlrm_engine(params, _with_cache(tcfg, rows=24,
                                                 pipeline_depth=2), 4,
                             device="cpu")
    _score(piped, CTRRequest, _requests(tcfg, 16, seed=9))
    spans = piped.trace.spans
    assert len(piped.trace.by_stage("forward")) == 4
    assert check_timeline(spans, depth=2) == []
    fwd0 = piped.trace.by_stage("forward")[0]
    # batch 2 writes the slot batch 0 reads, inside batch 0's forward
    race = list(spans) + [_span("scatter", 2, fwd0.start, fwd0.end)]
    assert {v.kind for v in check_timeline(race, depth=2)} == \
        {"buffer-race"}
    # batch 0's scatter moved after its own forward started
    late = [s for s in spans if (s.stage, s.batch) != ("scatter", 0)]
    late.append(_span("scatter", 0, fwd0.start, fwd0.end + 1.0))
    assert "scatter-after-dispatch" in \
        {v.kind for v in check_timeline(late, depth=2)}


@pytest.mark.parametrize("spans", TIMELINES)
def test_load_timeline_matches_reference(tmp_path, spans):
    """A stage-trace artifact loads to the same spans and depth in both
    packages, and replays to the same violations."""
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"schema_version": 1, "depth": 2,
                                "spans": spans}))
    got, depth = load_timeline(str(path))
    want, jdepth = jproto.load_timeline(str(path))
    assert depth == jdepth == 2
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert [v.kind for v in check_timeline(got, depth)] == \
        [v.kind for v in jproto.check_timeline(want, jdepth)]
    path.write_text(json.dumps({"schema_version": 2, "spans": []}))
    with pytest.raises(ValueError, match="schema_version"):
        load_timeline(str(path))


# ---------------------------------------------------------------------------
# The kernel loader under threads
# ---------------------------------------------------------------------------

STUB_NVCC = """#!{python}
import sys, threading, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as fh:
    fh.write(out + "\\n")
time.sleep(0.3)              # widen the window two unlocked builds race in
with open(out, "w") as fh:
    fh.write("stub library")
"""


@pytest.mark.parametrize("names", [("stub", "stub"), ("stub", "other")])
def test_build_load_from_two_threads(tmp_path, monkeypatch, names):
    """Two threads' first ``load`` at once: one nvcc per source, each
    writing a temporary file named by process and thread, none left
    behind.  A stub nvcc on PATH stands in for the compiler, and a stub
    loader for ctypes: no library is really loaded."""
    bindir, csrc, out = tmp_path / "bin", tmp_path / "csrc", tmp_path / "b"
    bindir.mkdir()
    csrc.mkdir()
    for n in set(names):
        (csrc / f"{n}.cu").write_text(f"// {n}\n")
    log = tmp_path / "nvcc.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(STUB_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(kbuild, "CSRC", csrc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", out)
    monkeypatch.setattr(kbuild, "_LIBS", {})
    monkeypatch.setattr(kbuild, "RECORDS", {})
    monkeypatch.setattr(kbuild, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: ("lib", path)))

    barrier = threading.Barrier(len(names))
    got, idents = {}, {}

    def first_launch(i, name):
        idents[i] = threading.get_ident()
        barrier.wait(timeout=10)
        got[i] = kbuild.load(name)

    threads = [threading.Thread(target=first_launch, args=(i, n))
               for i, n in enumerate(names)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert len(got) == len(names)
    for i, name in enumerate(names):
        assert got[i] == ("lib", str(kbuild.library_path(name)))
    runs = log.read_text().split()
    assert len(runs) == len(set(names))           # one nvcc per source
    pid = os.getpid()
    assert all(any(r.endswith(f".{pid}.{t}.tmp") for t in idents.values())
               for r in runs)
    assert sorted(p.name for p in out.iterdir()) == \
        sorted(kbuild.library_path(n).name for n in set(names))
