"""The remote cold tier with one host per process, on the CPU.

The same seeded numpy inputs as ``tests/test_torch_remote.py`` go through
three paths: the reference's ``shard_map`` path (that file's JAX
subprocess with 4 forced CPU devices, the one-sided fetch in Pallas
interpret mode; run once per test session and shared), the port's stacked
simulation of the hosts on one device, and the port's per-rank path:
``run_ranks`` spawns 4 gloo processes on the CPU once per module, and
every case runs inside them, each rank a host that holds only its own row
shard.

Tolerances: every comparison is bitwise -- a fetched row is a copy, and
the sum over owners adds one value to zeros, in any order, on either
route (the inputs hold no ``-0.0``, which would come back ``+0.0``); the
ring permute moves blocks -- except the engine's pCTR against the
reference's remote-tier engine, which goes through two frameworks' MLPs
and agrees to ``atol=1e-6``, as in ``tests/test_torch_remote.py``.  The
port's engines over ranks are held bitwise to its stacked engines, and
their counters and fallbacks exactly.  ``CollectiveEvent``s (op,
bytes_in, axis_size, backend): equal to the reference's.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import test_torch_remote as tr
from repro_torch.cache import RemoteStore
from repro_torch.cache.cached_bag import make_cold_store
from repro_torch.configs import dlrm as tcfg_mod
from repro_torch.core import comm
from repro_torch.core import parallel
from repro_torch.core.cache_config import CacheConfig
from repro_torch.kernels import onesided_a2a as oa
from repro_torch.serving.engine import (CTRRequest, DLRMEngine,
                                        PipelinedDLRMEngine, make_dlrm_engine)
from repro_torch.utils.convert import params_from_numpy

H = tr.H
T, R, D = tr.T, tr.R, tr.D
BACKENDS = tr.BACKENDS
STATS = tr.STATS
REQUESTS = ("same", "ranks")          # one request for all, or one a rank
# the pipelined leg: 24 Zipf requests in micro-batches of 4 over pools of
# 8 slots a table, which half of the micro-batches overflow
PIPE_REQS, PIPE_BATCH, PIPE_ROWS, PIPE_SEED = 24, 4, 8, 7


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _events(events):
    return [f"{e.op}:{e.bytes_in}:{e.axis_size}:{e.backend}" for e in events]


def _engine_params(want):
    """The reference engine's parameters, as numpy arrays by name."""
    return {k: v for k, v in want.items()
            if k == "tables" or k.startswith(("bottom_", "top_"))}


def _params(arrays):
    cfg = tcfg_mod.smoke()
    return params_from_numpy(
        {"tables": arrays["tables"],
         **{part: [{"w": arrays[f"{part}_{i}_w"],
                    "b": arrays[f"{part}_{i}_b"]}
                   for i in range(len(getattr(cfg, f"{part}_mlp")))]
            for part in ("bottom", "top")}}, device="cpu")


def _cfg(**cache):
    return dataclasses.replace(tcfg_mod.smoke(), cache=CacheConfig(**cache))


def _remote(backend, **kw):
    return dict(cold_tier="remote", remote_backend=backend, **kw)


def _engine_requests(x):
    return [CTRRequest(rid=i, dense=x["req_dense"][i],
                       indices=x["req_idx"][i], lengths=x["req_lens"][i])
            for i in range(tr.ENGINE_REQS)]


def _pipe_requests():
    """Zipf(1.2) ids over the smoke config's rows, lengths in [1, L]."""
    cfg = tcfg_mod.smoke()
    t_, l_, f_ = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    rng = np.random.default_rng(PIPE_SEED)
    idx = np.minimum(rng.zipf(1.2, (PIPE_REQS, t_, l_)) - 1,
                     cfg.rows_per_table - 1).astype(np.int32)
    lens = rng.integers(1, l_ + 1, (PIPE_REQS, t_)).astype(np.int32)
    dense = rng.standard_normal((PIPE_REQS, f_)).astype(np.float32)
    return [CTRRequest(rid=i, dense=dense[i], indices=idx[i],
                       lengths=lens[i]) for i in range(PIPE_REQS)]


def _score(eng, reqs):
    for r in reqs:
        eng.submit(r)
    scores = eng.run_to_completion()
    return np.array([scores[i] for i in range(len(reqs))])


def _pipe_cache(backend, **kw):
    return _remote(backend, rows=PIPE_ROWS, policy="lru", **kw)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _refusals(ctx, x, params):
    """Each refusal a rank must raise, by its message."""
    out = {}
    tables = _t(x["tables"])
    remote = _cfg(rows=tr.ENGINE_ROWS, **_remote("bulk"))
    m = 3 + (ctx.rank == 1)              # rank 1 asks for one row more
    for name, fn in (
            ("with_ctx", lambda: DLRMEngine(params, remote, 4, ctx,
                                            remote_ctx=ctx)),
            ("host_tier", lambda: DLRMEngine(
                params, _cfg(rows=tr.ENGINE_ROWS), 4, remote_ctx=ctx)),
            ("host_store", lambda: make_cold_store(
                tables, CacheConfig(rows=8), ctx=ctx)),
            ("hosts", lambda: RemoteStore(tables, hosts=2, ctx=ctx)),
            ("rows", lambda: RemoteStore(torch.zeros((T, 66, D)), ctx=ctx)),
            ("unequal_m", lambda: comm.fetch_rows(
                _t(x["shards"][ctx.rank]), _t(x["addr"][:m]),
                _t(x["owner"][:m]), ctx=ctx))):
        try:
            fn()
            out[name] = None
        except (ValueError, TypeError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _rank_cases(ctx, x, arrays):
    """Every case on this rank; rank 0 returns every rank's results."""
    r = ctx.rank
    out = {}
    oa.reset_launch_counts()
    calls0 = dict(oa.CALL_COUNTS)
    shard = _t(x["shards"][r])
    for be in BACKENDS:
        for req in REQUESTS:
            addr = x["addr"] if req == "same" else x["rank_addr"][r]
            owner = x["owner"] if req == "same" else x["rank_owner"][r]
            with comm.instrument() as events:
                got = comm.fetch_rows(shard, _t(addr), _t(owner),
                                      backend=be, ctx=ctx)
            out[("fetch", be, req)] = (got, _events(events))
        for shift in tr.RING_SHIFTS:
            with comm.instrument() as events:
                got = comm.permute_ring(_t(x["ring"][r]), shift=shift,
                                        backend=be, ctx=ctx)
            out[("permute", be, shift)] = (got, _events(events))
        tables = _t(x["tables"])
        store = RemoteStore(tables, hosts=H if be == "bulk" else None,
                            backend=be, ctx=ctx)
        with comm.instrument() as events:
            got = store.fetch(x["t_ids"], x["row_ids"])
        out[("store", be)] = dict(
            got=got, shard=store.shards,
            own=store.shards.untyped_storage().nbytes()
            == store.shards.numel() * store.shards.element_size(),
            keeps_tables=any(v is tables for v in vars(store).values()),
            layout=(store.hosts, store.home, store.rows_per_host,
                    store.owner_of(x["row_ids"]).tolist()),
            events=[(e.op, e.bytes_in, e.axis_size, e.backend, e.t1 > e.t0)
                    for e in events])
    params = _params(arrays)
    for be in BACKENDS:
        eng = DLRMEngine(params, _cfg(rows=tr.ENGINE_ROWS, **_remote(be)),
                         tr.ENGINE_BATCH, remote_ctx=ctx)
        scores = _score(eng, _engine_requests(x))
        st = eng.cache_stats()
        out[("engine", be)] = dict(
            scores=scores, stats=[getattr(st, k) for k in STATS],
            tables=eng.params["tables"], device=str(eng.device),
            shard=tuple(eng.cache.cold.shards.shape))
        serial = DLRMEngine(params, _cfg(**_pipe_cache(be)), PIPE_BATCH,
                            remote_ctx=ctx)
        piped = make_dlrm_engine(params, _cfg(**_pipe_cache(
            be, pipeline_depth=2)), PIPE_BATCH, remote_ctx=ctx)
        ring = piped.cache
        out[("pipelined", be)] = dict(
            serial=_score(serial, _pipe_requests()),
            scores=_score(piped, _pipe_requests()),
            fallbacks=piped.scheduler.fallbacks,
            stats=[getattr(piped.cache_stats(), k) for k in STATS],
            kind=type(piped).__name__,
            one_store=all(b.cold is ring.buffers[0].cold
                          for b in ring.buffers))
    out["launches"] = dict(oa.LAUNCH_COUNTS)
    out["calls"] = {k: v - calls0[k] for k, v in oa.CALL_COUNTS.items()}
    out["refusals"] = _refusals(ctx, x, params)
    gathered = [None] * ctx.world
    torch.distributed.all_gather_object(gathered, out, group=ctx.group)
    return gathered


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tr.reference_outputs(tmp_path_factory)


@pytest.fixture(scope="module")
def ranks(ref):
    """Every rank's results of the 4-process run."""
    x, want = ref
    return parallel.run_ranks(_rank_cases, H, backend="gloo", device="cpu",
                              args=(x, _engine_params(want)), timeout_s=240)


# ---------------------------------------------------------------------------
# comm.fetch_rows(ctx=) and comm.permute_ring(ctx=)
# ---------------------------------------------------------------------------

def test_inputs_hold_no_negative_zero(ref):
    """An owner's -0.0 would come back +0.0 on every route: the inputs
    hold none, so every comparison here can be bitwise."""
    x, _ = ref
    for name in ("shards", "tables", "ring"):
        a = x[name]
        assert not (np.signbit(a) & (a == 0)).any(), name


@pytest.mark.parametrize("req", REQUESTS)
@pytest.mark.parametrize("be", BACKENDS)
def test_rank_fetch_rows_matches_jax_and_stacked(ranks, ref, be, req):
    x, want = ref
    for r, out in enumerate(ranks):
        got, _ = out[("fetch", be, req)]
        addr = x["addr"] if req == "same" else x["rank_addr"][r]
        owner = x["owner"] if req == "same" else x["rank_owner"][r]
        ref_r = want[f"fetch_{be}"] if req == "same" \
            else want[f"fetch_ranks_{be}"][r]
        stacked = comm.fetch_rows(_t(x["shards"]), _t(addr), _t(owner),
                                  backend=be)
        assert got.shape == (len(addr), D) and got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got), _bits(ref_r))
        np.testing.assert_array_equal(_bits(got), _bits(stacked))
        np.testing.assert_array_equal(_bits(got),
                                      _bits(x["shards"][owner, addr]))


@pytest.mark.parametrize("req", REQUESTS)
@pytest.mark.parametrize("be", BACKENDS)
def test_rank_fetch_rows_events_match_jax(ranks, ref, be, req):
    """One fetch_rows event a call, the (E, M, D) contributions' bytes,
    none for the requests' all-gathers: the reference's."""
    _, want = ref
    key = f"events_fetch_{be}" if req == "same" \
        else f"events_fetch_ranks_{be}"
    for out in ranks:
        _, events = out[("fetch", be, req)]
        assert events == want[key].tolist()
        assert events == [f"fetch_rows:{H * 10 * D * 4}:{H}:{be}"]


@pytest.mark.parametrize("shift", tr.RING_SHIFTS)
@pytest.mark.parametrize("be", BACKENDS)
def test_rank_permute_ring_matches_jax(ranks, ref, be, shift):
    """Rank r returns the block of rank (r - shift) % H: the reference's
    ppermute, torch.roll of the stacked blocks, the stacked port's."""
    x, want = ref
    ring = _t(x["ring"])
    rolled = torch.roll(ring, shift, dims=0)
    stacked = comm.permute_ring(ring, shift=shift, backend=be)
    for r, out in enumerate(ranks):
        got, events = out[("permute", be, shift)]
        np.testing.assert_array_equal(_bits(got), _bits(want[
            f"permute_{shift}"][r]))
        assert torch.equal(got, rolled[r]) and torch.equal(got, stacked[r])
        assert events == want[f"events_permute_{be}_{shift}"].tolist()


# ---------------------------------------------------------------------------
# RemoteStore(ctx=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("be", BACKENDS)
def test_rank_remote_store_holds_its_shard_and_fetches_as_jax(ranks, ref,
                                                              be):
    """Each rank holds only its own (T * R/H, D) shard, the reference's
    shard h, in storage of its own and with no reference to the tables it
    was given; fetch returns the reference's RemoteStore.fetch on every
    rank, with comm's event and the store's timed one."""
    x, want = ref
    stacked = RemoteStore(_t(x["tables"]), hosts=H, backend=be,
                          device="cpu").fetch(x["t_ids"], x["row_ids"])
    nbytes = H * 8 * D * 4                        # M = 5, padded to 8
    for r, out in enumerate(ranks):
        rec = out[("store", be)]
        assert rec["shard"].shape == (T * R // H, D)
        np.testing.assert_array_equal(_bits(rec["shard"]),
                                      _bits(want["store_shards"][r]))
        assert rec["own"] and not rec["keeps_tables"]
        assert rec["layout"] == (H, 0, R // H, [0, 1, 2, 3, 0])
        np.testing.assert_array_equal(_bits(rec["got"]),
                                      _bits(want[f"store_{be}"]))
        assert torch.equal(rec["got"], stacked)
        assert rec["events"] == [("fetch_rows", nbytes, H, be, False),
                                 ("fetch_rows", nbytes, H, be, True)]


# ---------------------------------------------------------------------------
# the engines with remote_ctx
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("be", BACKENDS)
def test_rank_engine_matches_stacked_and_jax(ranks, ref, be):
    """Every rank scores bitwise the stacked remote engine, within the
    reference's remote-tier engine's tolerance, with the stacked engine's
    counters, holding only the slot pool and its shard."""
    x, want = ref
    eng = DLRMEngine(_params(_engine_params(want)), _cfg(
        rows=tr.ENGINE_ROWS, **_remote(be, remote_hosts=H)),
        tr.ENGINE_BATCH, device="cpu")
    stacked = _score(eng, _engine_requests(x))
    st = eng.cache_stats()
    assert st.misses_remote > 0
    for out in ranks:
        rec = out[("engine", be)]
        np.testing.assert_array_equal(rec["scores"], stacked)
        np.testing.assert_allclose(rec["scores"], want["engine_scores"],
                                   rtol=0, atol=tr.PCTR_ATOL)
        assert rec["stats"] == [getattr(st, k) for k in STATS]
        assert rec["tables"] is None and rec["device"] == "cpu"
        assert rec["shard"] == (tcfg_mod.smoke().num_sparse_features
                                * tcfg_mod.smoke().rows_per_table // H,
                                tcfg_mod.smoke().embedding_dim)


@pytest.mark.parametrize("be", BACKENDS)
def test_rank_pipelined_engine_matches_serialized_and_stacked(ranks, ref,
                                                              be):
    """Depth 2 over the per-rank remote tier: bitwise the serialized
    engine on the same ranks and the stacked pipelined engine; the same
    capacity fallbacks on every rank (the same requests give the same
    decisions), equal to the stacked engine's."""
    _, want = ref
    params = _params(_engine_params(want))
    eng = make_dlrm_engine(params, _cfg(**_pipe_cache(
        be, remote_hosts=H, pipeline_depth=2)), PIPE_BATCH, device="cpu")
    stacked = _score(eng, _pipe_requests())
    fallbacks = eng.scheduler.fallbacks
    assert 0 < fallbacks < -(-PIPE_REQS // PIPE_BATCH)
    for out in ranks:
        rec = out[("pipelined", be)]
        assert rec["kind"] == "PipelinedDLRMEngine" and rec["one_store"]
        np.testing.assert_array_equal(rec["scores"], rec["serial"])
        np.testing.assert_array_equal(rec["scores"], stacked)
        assert rec["fallbacks"] == fallbacks
        assert rec["stats"] == [getattr(eng.cache_stats(), k)
                                for k in STATS]


def test_rank_cpu_path_launches_nothing(ranks):
    """On the CPU every wrapper takes its plain version: no launch, and
    each one-sided call still counted as a call."""
    for out in ranks:
        assert set(out["launches"].values()) == {0}
        assert out["calls"]["onesided_put_rows"] > 0
        assert out["calls"]["onesided_ring_permute"] == len(tr.RING_SHIFTS)


# ---------------------------------------------------------------------------
# refusals: no silent fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what, match", [
    ("with_ctx", r"ValueError: DLRMEngine: remote_ctx .* and ctx"),
    ("host_tier", r"ValueError: .*remote_ctx needs .* cold_tier='host'"),
    ("host_store", r"ValueError: .*cache.cold_tier is 'host'"),
    ("hosts", r"ValueError: RemoteStore: hosts=2 with a ProcessContext "
              r"of 4 ranks"),
    ("rows", r"ValueError: rows_per_table \(66\) must divide evenly over 4"),
    ("unequal_m", r"ValueError: fetch_rows: the ranks ask for unequal row "
                  r"counts \[3, 4, 3, 3\]"),
])
def test_rank_refusals(ranks, what, match):
    for out in ranks:
        msg = out["refusals"][what]
        assert msg is not None and re.search(match, msg), msg


def test_remote_ctx_must_be_a_process_context(ref):
    """A simulated model axis is no host group: refused, like a remote
    context on the pipelined engine without a cache."""
    _, want = ref
    params = _params(_engine_params(want))
    with pytest.raises(TypeError, match="remote_ctx must be a "
                                        "ProcessContext"):
        DLRMEngine(params, _cfg(rows=tr.ENGINE_ROWS, **_remote("bulk")),
                   4, device="cpu", remote_ctx=parallel.make_context(4))
    with pytest.raises(TypeError, match="remote_ctx must be a "
                                        "ProcessContext"):
        PipelinedDLRMEngine(params, _cfg(**_pipe_cache(
            "bulk", pipeline_depth=2)), 4, device="cpu",
            remote_ctx=parallel.make_context(4))
