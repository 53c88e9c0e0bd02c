"""The port's DLRMEngine and tiered cache against the JAX engine on one
request stream, on the CPU.

pCTR agrees to ``rtol=1e-4, atol=1e-5`` (the logit tolerance of
test_torch_dlrm; the sigmoid only shrinks differences).  The cache's
admission and eviction run the same numpy state machine on the same ids,
so its counters must agree EXACTLY; inside the port the cached pooled
lookup is bitwise-equal to the uncached one.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.cache import CacheConfig as JCacheConfig
from repro.configs import dlrm as jcfg_mod
from repro.models import dlrm as jdlrm
from repro.serving.engine import CTRRequest as JRequest
from repro.serving.engine import DLRMEngine as JEngine
from repro_torch.cache.cached_bag import CachedEmbeddingBag, make_cold_store
from repro_torch.cache.manager import CacheCapacityError
from repro_torch.configs import dlrm as tcfg_mod
from repro_torch.core import embedding_bag as teb
from repro_torch.core.cache_config import CacheConfig
from repro_torch.core.jagged import JaggedBatch
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
    jparams = jdlrm.init_params(jax.random.key(1), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, tcfg_mod.smoke(), params


def _requests(cfg, n, seed, zipf=1.2, pad=-1):
    """Zipf traffic, lengths in [1, L], ``pad`` beyond lengths."""
    T, L, F = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        idx = np.minimum(rng.zipf(zipf, (T, L)) - 1,
                         cfg.rows_per_table - 1).astype(np.int32)
        lens = rng.integers(1, L + 1, (T,)).astype(np.int32)
        idx[np.arange(L) >= lens[:, None]] = pad
        out.append(dict(rid=rid,
                        dense=rng.standard_normal(F).astype(np.float32),
                        indices=idx, lengths=lens))
    return out


def _serve(engine, cls, reqs):
    for r in reqs:
        engine.submit(cls(**r))
    flushes = []
    while engine.queue:
        flushes.append(engine.flush())
    return flushes


def _merged(flushes):
    out = {}
    for f in flushes:
        out.update(f)
    return out


@pytest.mark.parametrize("jax_mode", ["interpret", "reference"])
def test_uncached_engine_matches_jax(models, jax_mode):
    jcfg, jparams, tcfg, params = models
    jcfg = dataclasses.replace(jcfg, kernel_mode=jax_mode)
    reqs = _requests(tcfg, 7, seed=0, pad=0)
    want = _merged(_serve(JEngine(jparams, jcfg, batch_size=3), JRequest,
                          reqs))
    got = _merged(_serve(DLRMEngine(params, tcfg, 3, device="cpu"),
                         CTRRequest, reqs))
    assert sorted(got) == sorted(want) == list(range(7))
    for rid in want:
        assert 0.0 < got[rid] < 1.0
        np.testing.assert_allclose(got[rid], want[rid], **PCTR)


def test_minus_one_padding_matches_jax(models):
    """Requests padded with -1 beyond lengths score as with 0 padding."""
    jcfg, jparams, tcfg, params = models
    want = _merged(_serve(JEngine(jparams, jcfg, batch_size=4), JRequest,
                          _requests(tcfg, 6, seed=1, pad=0)))
    for cache in (CacheConfig(), CacheConfig(rows=16)):
        cfg = dataclasses.replace(tcfg, cache=cache)
        got = _merged(_serve(DLRMEngine(params, cfg, 4, device="cpu"),
                             CTRRequest, _requests(tcfg, 6, seed=1)))
        for rid in want:
            np.testing.assert_allclose(got[rid], want[rid], **PCTR)


@pytest.mark.parametrize("policy", ["lfu", "lru"])
def test_cached_engine_matches_jax(models, policy):
    """Slot pools small enough to evict every flush and to split
    micro-batches: pCTR matches, every counter matches exactly, and the
    flushes split the same way."""
    jcfg, jparams, tcfg, params = models
    jc = dataclasses.replace(jcfg, cache=JCacheConfig(rows=6, policy=policy))
    tc = dataclasses.replace(tcfg, cache=CacheConfig(rows=6, policy=policy))
    reqs = _requests(tcfg, 10, seed=2, zipf=1.1)
    jeng = JEngine(jparams, jc, batch_size=4)
    teng = DLRMEngine(params, tc, 4, device="cpu")
    jflush, tflush = _serve(jeng, JRequest, reqs), _serve(teng, CTRRequest,
                                                          reqs)
    assert [sorted(f) for f in tflush] == [sorted(f) for f in jflush]
    assert len(tflush) > -(-len(reqs) // 4)          # some flush was split
    want, got = _merged(jflush), _merged(tflush)
    assert sorted(got) == list(range(10))
    for rid in want:
        np.testing.assert_allclose(got[rid], want[rid], **PCTR)
    js, ts = jeng.cache_stats(), teng.cache_stats()
    assert ts.evictions > 0 and ts.hits > 0
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    for name in ("hits_t", "misses_t", "evictions_t"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))


def test_warmup_admission_matches_jax(models):
    """warmup_freqs seeds LFU and pre-admits the top rows: the first flush
    hits them, and every counter matches the reference's."""
    jcfg, jparams, tcfg, params = models
    freqs = np.random.default_rng(5).integers(
        0, 20, (tcfg.num_sparse_features, tcfg.rows_per_table))
    jc = dataclasses.replace(jcfg, cache=JCacheConfig(rows=10,
                                                      warmup_freqs=freqs))
    tc = dataclasses.replace(tcfg, cache=CacheConfig(rows=10,
                                                     warmup_freqs=freqs))
    reqs = _requests(tcfg, 6, seed=6)
    jeng, teng = JEngine(jparams, jc, 3), DLRMEngine(params, tc, 3,
                                                     device="cpu")
    want = _merged(_serve(jeng, JRequest, reqs))
    got = _merged(_serve(teng, CTRRequest, reqs))
    for rid in want:
        np.testing.assert_allclose(got[rid], want[rid], **PCTR)
    js, ts = jeng.cache_stats(), teng.cache_stats()
    assert ts.fetch_host > ts.misses > 0           # warmup fetched rows too
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_cached_pooled_bitwise_equal_uncached(combiner):
    """Inside the port: after prefetch the slot-pool lookup is bitwise the
    lookup over the full tables, across evictions."""
    cfg = teb.EmbeddingBagConfig(num_tables=3, rows_per_table=40, dim=8,
                                 combiner=combiner,
                                 cache=CacheConfig(rows=12, policy="lru"))
    tables = teb.init_tables(torch.Generator().manual_seed(3), cfg,
                             device="cpu")
    cache = teb.make_cache(tables, cfg, device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(4):
        idx = torch.as_tensor(rng.integers(0, 40, (3, 3, 4)).astype(np.int32))
        lens = torch.as_tensor(rng.integers(0, 5, (3, 3)).astype(np.int32))
        batch = JaggedBatch(idx, lens)
        got = teb.pooled_lookup_cached(cache, batch)
        want = teb.pooled_lookup_local(tables, batch, cfg)
        assert torch.equal(got, want)
        # the engine's path: the flat pool through pooled_lookup_local
        slots = cache.prefetch(batch)
        assert torch.equal(teb.pooled_lookup_local(cache.pool, slots, cfg),
                           want)
    assert cache.stats.evictions > 0
    assert cache.pool_bytes == 3 * 12 * 8 * 4


def test_failed_pool_copy_rolls_back_residency():
    """A cold fetch that dies after admission leaves no slot claiming a row
    that was never copied; the retry serves exact rows."""
    cfg = teb.EmbeddingBagConfig(num_tables=1, rows_per_table=64, dim=8,
                                 cache=CacheConfig(rows=16))
    tables = teb.init_tables(torch.Generator().manual_seed(11), cfg,
                             device="cpu")
    cache = teb.make_cache(tables, cfg, device="cpu")
    batch = JaggedBatch(torch.tensor([[[1, 2, 3]]], dtype=torch.int32),
                        torch.full((1, 1), 3, dtype=torch.int32))
    real = cache.cold.fetch
    cache.cold.fetch = lambda *a: (_ for _ in ()).throw(
        RuntimeError("injected cold-tier failure"))
    try:
        with pytest.raises(RuntimeError, match="injected"):
            cache.prefetch(batch)
    finally:
        cache.cold.fetch = real
    assert cache.mgr.resident_rows == 0
    assert torch.equal(cache.lookup(batch),
                       teb.pooled_lookup_local(tables, batch, cfg))


def test_capacity_error_and_remote_tier():
    cfg = teb.EmbeddingBagConfig(num_tables=1, rows_per_table=64, dim=4,
                                 cache=CacheConfig(rows=3))
    tables = torch.zeros((1, 64, 4))
    cache = CachedEmbeddingBag(tables, cfg, device="cpu")
    batch = JaggedBatch(torch.arange(8, dtype=torch.int32).reshape(1, 2, 4),
                        torch.full((1, 2), 4, dtype=torch.int32))
    with pytest.raises(CacheCapacityError):
        cache.lookup(batch)
    # the remote tier: one simulated host per device by default, and the
    # CPU is one host -- too few; remote_hosts=4 builds it
    with pytest.raises(ValueError, match="remote|hosts"):
        make_cold_store(tables, CacheConfig(rows=3, cold_tier="remote"),
                        device="cpu")
    assert make_cold_store(
        tables, CacheConfig(rows=3, cold_tier="remote", remote_hosts=4),
        device="cpu").tier == "remote"
    with pytest.raises(ValueError, match="cold_tier"):
        make_cold_store(tables, CacheConfig(rows=3, cold_tier="disk"))


# ---------------------------------------------------------------------------
# submit() rejections (tests/test_serving.py, mirrored)
# ---------------------------------------------------------------------------

def _engine(models, **kw):
    _, _, tcfg, params = models
    return tcfg, DLRMEngine(params, dataclasses.replace(tcfg, **kw), 2,
                            device="cpu")


def test_rejects_bad_shapes(models):
    cfg, eng = _engine(models)
    with pytest.raises(ValueError):
        eng.submit(CTRRequest(
            rid=0, dense=np.zeros(cfg.num_dense_features, np.float32),
            indices=np.zeros((1, 1), np.int32),
            lengths=np.zeros((1,), np.int32)))
    assert not eng.queue


def test_rejects_bad_dtypes(models):
    cfg, eng = _engine(models)
    T, L, F = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    good = dict(dense=np.zeros(F, np.float32),
                indices=np.zeros((T, L), np.int32),
                lengths=np.ones(T, np.int32))
    with pytest.raises(TypeError, match="indices"):
        eng.submit(CTRRequest(rid=0, **{
            **good, "indices": np.zeros((T, L), np.float32)}))
    with pytest.raises(TypeError, match="lengths"):
        eng.submit(CTRRequest(rid=1, **{
            **good, "lengths": np.ones(T, np.float64)}))
    with pytest.raises(TypeError, match="dense"):
        eng.submit(CTRRequest(rid=2, **{
            **good, "dense": np.zeros(F, np.int32)}))
    assert not eng.queue
    eng.submit(CTRRequest(rid=3, **good))
    assert len(eng.queue) == 1


def test_rejects_out_of_range_values(models):
    cfg, eng = _engine(models)
    T, L, F = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    good = dict(dense=np.zeros(F, np.float32),
                indices=np.zeros((T, L), np.int32),
                lengths=np.ones(T, np.int32))
    with pytest.raises(ValueError, match="indices"):
        eng.submit(CTRRequest(rid=0, **{
            **good,
            "indices": np.full((T, L), cfg.rows_per_table, np.int32)}))
    with pytest.raises(ValueError, match="lengths"):
        eng.submit(CTRRequest(rid=1, **{
            **good, "lengths": np.full(T, L + 1, np.int32)}))
    assert not eng.queue
    padded = np.full((T, L), -1, np.int32)      # sentinel beyond lengths
    padded[:, 0] = 3
    eng.submit(CTRRequest(rid=2, **{**good, "indices": padded}))
    assert len(eng.queue) == 1


def test_cache_smaller_than_pooling_rejected(models):
    _, _, tcfg, params = models
    for cache in (CacheConfig(rows=tcfg.pooling - 1),
                  CacheConfig(rows_per_table=[8] * 7 + [tcfg.pooling - 1])):
        with pytest.raises(ValueError, match="pooling"):
            DLRMEngine(params, dataclasses.replace(tcfg, cache=cache), 2,
                       device="cpu")


def test_entry_points_need_a_card_or_an_explicit_cpu(models):
    """device=None means the card: without one every entry point raises,
    the pipelined engine (depth >= 2) too; on an explicit CPU depth 2
    builds the pipelined engine."""
    _, _, tcfg, params = models
    with pytest.raises(RuntimeError, match="CUDA"):
        DLRMEngine(params, tcfg, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_dlrm_engine(params, tcfg, 2)
    cached = dataclasses.replace(tcfg, cache=CacheConfig(rows=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        teb.make_cache(params["tables"], cached.embedding_config())
    piped = dataclasses.replace(tcfg, cache=CacheConfig(rows=8,
                                                        pipeline_depth=2))
    assert isinstance(make_dlrm_engine(params, piped, 2, device="cpu"),
                      PipelinedDLRMEngine)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_dlrm_engine(params, piped, 2)
    assert isinstance(make_dlrm_engine(params, cached, 2, device="cpu"),
                      DLRMEngine)
    with pytest.raises(ValueError, match="parameters"):
        DLRMEngine(params, tcfg, 2, device="meta")
