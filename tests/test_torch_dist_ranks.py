"""The distributed embedding bag with each rank a process, on the CPU.

The same seeded numpy inputs as ``tests/test_torch_distributed.py`` go
through three paths: the reference's ``shard_map`` path (that file's JAX
subprocess, run once per test session and shared), the port's stacked
simulation of the ranks in one process, and the port's per-rank path:
``run_ranks`` spawns 4 gloo processes on the CPU once per module (2 for
the table-wise run), and every case runs inside them.

Tolerances:

  * against the stacked path, bitwise wherever every collective moves
    values or adds them in rank order: the one-sided routes (their plain
    versions sum the gathered chunks in rank order, as ``x.sum(0)`` does),
    ``emulate_rs_with_a2a``, the column, table-wise and replicated
    strategies, the all-to-alls and all-gathers;
  * the bulk all-reduce and reduce-scatter take gloo's summation order:
    each pooled element within ``E * 2**-24 * sum_s |partial_s|`` of the
    stacked sum (two f32 orders of E terms), ``E * 2**-8 * sum_s
    |partial_s|`` under ``rs_dtype="bfloat16"`` (gloo adds in bf16, the
    stacked sum in f32 rounded once);
  * against the reference, the tolerances of ``test_torch_distributed.py``
    for pooled vectors, and the reference's ``rtol=1e-4, atol=1e-5`` for
    pCTR;
  * dropped lookups and ``CollectiveEvent``s (op, bytes_in, axis_size,
    backend) per rank: equal.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import test_torch_distributed as td
from repro_torch.configs import dlrm as tcfg_mod
from repro_torch.core import comm
from repro_torch.core import embedding_bag as teb
from repro_torch.core import parallel
from repro_torch.core.cache_config import CacheConfig
from repro_torch.core.jagged import JaggedBatch
from repro_torch.kernels import onesided_a2a as oa
from repro_torch.models import dlrm as tdlrm
from repro_torch.serving.engine import CTRRequest, make_dlrm_engine

E = td.E
T, R, D, B = td.T, td.R, td.D, td.B
PCTR_TOL = dict(rtol=1e-4, atol=1e-5)
ULP = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}
BACKENDS = ("bulk", "onesided")
# the pooled-lookup cases of test_torch_distributed.py, on both backends
RANK_CASES = [(name, be) for name in td.CASES for be in BACKENDS]
# the engine's requests: 6 in batches of 8 (two padding rows a flush)
ENGINES = {"a2a_bulk": "bulk", "a2a_onesided": "onesided"}


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _case_cfg(name, backend, t=None):
    fields, kw = td.CASES[name]
    return td._ecfg(t or td._num_tables(name),
                    **{**fields, "rw_backend": backend}), kw


def _bulk_sum(cfg) -> bool:
    """Whether the case's strategy sums partials over the group's bulk
    route, in gloo's order."""
    return (cfg.sharding == "row" and cfg.rw_backend == "bulk"
            and not cfg.emulate_rs_with_a2a)


def _mass(ctx, rs, batch, cfg, kw):
    """sum_s |partial_s| of each element this rank returns, in f32: the
    bound's measure for the bulk sums, through the rank-order routes."""
    mass = teb.row_partials(rs, batch, cfg).abs().contiguous()
    if cfg.rw_impl == "allgather":
        if kw.get("scatter_batch"):
            return comm.reduce_scatter(
                mass.reshape(E, B // E, *mass.shape[1:]), backend="onesided",
                ctx=ctx)
        return comm.all_reduce(mass, backend="onesided", ctx=ctx)
    mass = comm.reduce_scatter(mass, backend="onesided", ctx=ctx)
    return comm.all_gather(mass.reshape(-1, cfg.num_tables, D), axis=0,
                           tiled=True, ctx=ctx)


def _events(events):
    return [f"{e.op}:{e.bytes_in}:{e.axis_size}:{e.backend}" for e in events]


def _collectives(ctx, x):
    """The raw per-rank collectives on the reference's inputs."""
    r = ctx.rank
    out = {}
    for dt in ("int32", "float32", "bfloat16"):
        a = _t(x[f"a2a_{dt}"][r])
        if dt == "bfloat16":
            a = a.to(torch.bfloat16)
        for be in BACKENDS:
            out[f"a2a_{dt}_{be}"] = comm.all_to_all(a, backend=be, ctx=ctx)
    for dt in ("float32", "int32"):
        a = _t(x[f"rs_{dt}"][r])
        for be in BACKENDS:
            out[f"rs_{dt}_{be}"] = comm.reduce_scatter(a, backend=be,
                                                       ctx=ctx)
        out[f"rs_{dt}_emulate"] = comm.reduce_scatter(
            a, backend="bulk", emulate_with_a2a=True, ctx=ctx)
    a = _t(x["rs_int32"][r, 0])
    for be in BACKENDS:
        out[f"ar_int32_{be}"] = comm.all_reduce(a, backend=be, ctx=ctx)
    a = _t(x["a2a_float32"][r])
    out["ag_stack"] = comm.all_gather(a, axis=1, ctx=ctx)
    out["ag_tiled"] = comm.all_gather(a, axis=1, tiled=True, ctx=ctx)
    return out


def _refusals(ctx):
    """Each refusal a rank must raise, by its message (``no_card`` only
    where the rank sees no card: ``cuda`` says whether it does)."""
    out = {"cuda": torch.cuda.is_available()}
    cached = dataclasses.replace(tcfg_mod.smoke(), cache=CacheConfig(rows=8))
    for sharding, shape in (("row", (4, 66, D)), ("column", (4, R, 18)),
                            ("table", (6, R, D))):
        cfg = teb.EmbeddingBagConfig(num_tables=shape[0],
                                     rows_per_table=shape[1], dim=shape[2],
                                     sharding=sharding)
        try:
            teb.shard_for_rank(torch.zeros(shape), cfg, ctx)
            out[sharding] = None
        except ValueError as e:
            out[sharding] = str(e)
    for name, fn in (
            ("tp_size", lambda: parallel.make_process_context(E + 1)),
            ("no_card", lambda: parallel.make_process_context(E)),
            ("symmetric_cpu", lambda: oa.SymmetricBuffers(
                ctx.group, ctx.rank, ctx.world, "cpu", 64)),
            ("cache", lambda: make_dlrm_engine(
                tdlrm.init_params(torch.Generator().manual_seed(0), cached,
                                  device="cpu"), cached, 4, ctx))):
        try:
            fn()
            out[name] = None
        except (ValueError, RuntimeError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _dp_context():
    """The (2, 2) context of this world of 4 (collective: every rank
    creates the mesh's groups): its queries and the groups' ranks."""
    c = parallel.make_process_context(2, dp_size=2, device="cpu")
    return (c.dp_size, c.dp_rank, c.rank, c.world, c.dp_for(8), c.dp_for(3),
            torch.distributed.get_process_group_ranks(c.group),
            torch.distributed.get_process_group_ranks(c.data_group))


def _rank_cases(ctx, x, want_params):
    """Every case on this rank; rank 0 returns every rank's results."""
    out = {"collectives": _collectives(ctx, x)}
    tables = _t(x["tables"])
    for name, be in RANK_CASES:
        cfg, kw = _case_cfg(name, be)
        rs = teb.shard_for_rank(tables[:cfg.num_tables], cfg, ctx)
        batch = td._batch(x, name)
        with comm.instrument() as events:
            got = teb.pooled_lookup_sharded(rs, batch, cfg, **kw)
        rec = dict(got=got, events=_events(events))
        if _bulk_sum(cfg):
            rec["mass"] = _mass(ctx, rs, batch, cfg, kw)
        out[(name, be)] = rec
    for be in BACKENDS:
        cfg = td._ecfg(T, sharding="row", rw_impl="a2a", rw_backend=be,
                       capacity_factor=td.DROP_CF)
        pooled, dropped = teb.pooled_lookup_rw_a2a_with_stats(
            teb.shard_for_rank(tables[:T], cfg, ctx), td._batch(x, "drops"),
            cfg)
        out[("drops", be)] = (pooled, int(dropped))
    params = td._params(want_params)
    base = tcfg_mod.smoke()
    dense = _t(x["dense"])
    fwd = JaggedBatch(_t(x["fwd_idx"]), _t(x["fwd_lens"]))
    for name, be in ENGINES.items():
        cfg = dataclasses.replace(base, rw_impl="a2a", rw_backend=be)
        out[("forward", name)] = tdlrm.forward(params, dense, fwd, cfg, ctx)
        eng = make_dlrm_engine(params, cfg, td.ENGINE_BATCH, ctx)
        assert isinstance(eng.params["tables"], teb.RankShard)
        for i in range(td.ENGINE_REQS):
            eng.submit(CTRRequest(rid=i, dense=x["req_dense"][i],
                                  indices=x["req_idx"][i],
                                  lengths=x["req_lens"][i]))
        scores = eng.run_to_completion()
        out[("engine", name)] = np.array([scores[i]
                                          for i in range(td.ENGINE_REQS)])
    for name, (ranks, fields) in td.FORWARDS.items():
        if ranks == E:
            out[("forward", name)] = tdlrm.forward(
                params, dense, fwd, dataclasses.replace(base, **fields), ctx)
    out["refusals"] = _refusals(ctx)
    out["dp_context"] = _dp_context()
    gathered = [None] * ctx.world
    torch.distributed.all_gather_object(gathered, out, group=ctx.group)
    return gathered


def _table_cases(ctx, x, want_params):
    """Table-wise over 2 ranks: the pooled lookup (both backends, kept
    sharded and gathered) and the forward."""
    out = {}
    tables = _t(x["tables"])
    for be in BACKENDS:
        for keep in (False, True):
            cfg = td._ecfg(8, sharding="table", rw_backend=be)
            rs = teb.shard_for_rank(tables, cfg, ctx)
            out[(be, keep)] = teb.pooled_lookup_sharded(
                rs, td._batch(x, "table"), cfg, keep_sharded=keep)
            out["shard", be] = rs.shard(ctx.rank)
    out["forward"] = tdlrm.forward(
        td._params(want_params), _t(x["dense"]),
        JaggedBatch(_t(x["fwd_idx"]), _t(x["fwd_lens"])),
        dataclasses.replace(tcfg_mod.smoke(), sharding="table"), ctx)
    gathered = [None] * ctx.world
    torch.distributed.all_gather_object(gathered, out, group=ctx.group)
    return gathered


def _params_arrays(want):
    return {k: v for k, v in want.items() if k.startswith("p_")}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return td.reference_outputs(tmp_path_factory)


@pytest.fixture(scope="module")
def ranks(ref):
    """Every rank's results of the 4-process run."""
    x, want = ref
    return parallel.run_ranks(_rank_cases, E, backend="gloo", device="cpu",
                              args=(x, _params_arrays(want)), timeout_s=240)


@pytest.fixture(scope="module")
def ranks2(ref):
    x, want = ref
    return parallel.run_ranks(_table_cases, 2, backend="gloo", device="cpu",
                              args=(x, _params_arrays(want)), timeout_s=240)


def _stacked(x, name, be):
    cfg, kw = _case_cfg(name, be)
    tables = _t(x["tables"][:cfg.num_tables])
    with comm.instrument() as events:
        got = teb.pooled_lookup_sharded(teb.shard_tables(tables, cfg, E),
                                        td._batch(x, name), cfg, **kw)
    return cfg, kw, got, _events(events)


def _rank_part(got, r, kw):
    """Rank r's share of a stacked result."""
    if kw.get("scatter_batch") or kw.get("keep_sharded"):
        return got[r]
    return got


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# the raw collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["int32", "float32", "bfloat16"])
@pytest.mark.parametrize("be", BACKENDS)
def test_rank_all_to_all_matches_jax(ranks, ref, dt, be):
    _, want = ref
    for r, out in enumerate(ranks):
        got = out["collectives"][f"a2a_{dt}_{be}"]
        got = got.float() if dt == "bfloat16" else got
        np.testing.assert_array_equal(got.numpy(), want[f"a2a_{dt}"][r])


@pytest.mark.parametrize("route", ["bulk", "onesided", "emulate"])
@pytest.mark.parametrize("dt", ["float32", "int32"])
def test_rank_reduce_scatter_matches_jax(ranks, ref, route, dt):
    """In rank order (one-sided, emulated): bitwise the reference's
    one-sided kernel; gloo's order: within two f32 orders' bound, and
    exact for int32 (which wraps, in any order)."""
    x, want = ref
    for r, out in enumerate(ranks):
        got = out["collectives"][f"rs_{dt}_{route}"].numpy()
        if dt == "int32" or route != "bulk":
            np.testing.assert_array_equal(got, want[f"rs_{dt}"][r])
        else:
            mass = np.abs(x["rs_float32"][:, r]).sum(0)
            assert (np.abs(got - want["rs_float32"][r])
                    <= E * ULP[torch.float32] * mass).all()


@pytest.mark.parametrize("be", BACKENDS)
def test_rank_int32_all_reduce_wraps_as_jax(ranks, ref, be):
    _, want = ref
    for r, out in enumerate(ranks):
        got = out["collectives"][f"ar_int32_{be}"]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want["ar_int32"][r])


def test_rank_all_gather(ranks, ref):
    x, _ = ref
    a = _t(x["a2a_float32"])
    for out in ranks:
        assert torch.equal(out["collectives"]["ag_stack"],
                           torch.stack(a.unbind(0), dim=1))
        assert torch.equal(out["collectives"]["ag_tiled"],
                           torch.cat(a.unbind(0), dim=1))


# ---------------------------------------------------------------------------
# pooled_lookup_sharded, every strategy on both backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, be", RANK_CASES)
def test_rank_pooled_lookup_matches_stacked_and_jax(ranks, ref, name, be):
    x, want = ref
    cfg, kw, stacked, _ = _stacked(x, name, be)
    for r, out in enumerate(ranks):
        rec = out[(name, be)]
        got, mine = rec["got"], _rank_part(stacked, r, kw)
        assert got.shape == mine.shape and got.dtype == mine.dtype
        if _bulk_sum(cfg):
            ulp = ULP[teb.DTYPES[cfg.rs_dtype]]
            assert (got - mine).abs().le(E * ulp * rec["mass"]).all(), \
                float((got - mine).abs().max())
        else:
            assert _same_bits(got, mine)
        ref_out = want[name]
        if kw.get("scatter_batch"):
            ref_out = ref_out.reshape(E, B // E, T, D)[r]
        elif kw.get("keep_sharded"):
            ref_out = ref_out.reshape(B, T, E, D // E)[:, :, r]
        if name in td.EXACT:
            np.testing.assert_allclose(got.numpy(), ref_out, **td.LOCAL)
        else:
            atol = td.BF16_ATOL if name.endswith("bf16") else td.ROW_ATOL
            np.testing.assert_allclose(got.numpy(), ref_out, rtol=0,
                                       atol=atol)


@pytest.mark.parametrize("name", ["row_allgather", "row_a2a_bulk",
                                  "row_a2a_onesided", "row_allgather_scatter",
                                  "column", "column_keep_sharded", "table"])
def test_rank_collective_events_match_jax(ranks, ref, name):
    """One event per collective call on every rank, with the reference's
    op, one rank's payload bytes, axis size and backend, in order."""
    x, want = ref
    be = td.CASES[name][0].get("rw_backend", "bulk")
    _, _, _, stacked = _stacked(x, name, be)
    for out in ranks:
        assert out[(name, be)]["events"] == want[f"events_{name}"].tolist()
        assert out[(name, be)]["events"] == stacked


@pytest.mark.parametrize("be", BACKENDS)
def test_rank_drops_match_jax(ranks, ref, be):
    x, want = ref
    cfg = td._ecfg(T, sharding="row", rw_impl="a2a", rw_backend=be,
                   capacity_factor=td.DROP_CF)
    pooled, dropped = teb.pooled_lookup_rw_a2a_with_stats(
        teb.shard_tables(_t(x["tables"][:T]), cfg, E), td._batch(x, "drops"),
        cfg)
    assert sum(out[("drops", be)][1] for out in ranks) > 0
    for r, out in enumerate(ranks):
        got, d = out[("drops", be)]
        assert d == int(want[f"drops_{be}"][r]) == int(dropped[r])
        np.testing.assert_allclose(got.numpy(), want[f"drops_pooled_{be}"],
                                   rtol=0, atol=td.ROW_ATOL)
        if be == "onesided":
            assert _same_bits(got, pooled)


def test_rank_table_wise_over_two_processes(ranks2, ref):
    x, _ = ref
    tables = _t(x["tables"])
    local = teb.pooled_lookup_local(tables, td._batch(x, "table"),
                                    td._ecfg(8, sharding="table"))
    for r, out in enumerate(ranks2):
        for be in BACKENDS:
            assert _same_bits(out[(be, False)], local)
            assert _same_bits(out[(be, True)], local[:, 4 * r:4 * r + 4])
            # the rank's shard: its 4 tables, a copy of its own
            assert torch.equal(out["shard", be], tables[4 * r:4 * r + 4])


# ---------------------------------------------------------------------------
# the DLRM forward and the engine under a ProcessContext
# ---------------------------------------------------------------------------

def _pctr(logits):
    return torch.sigmoid(torch.as_tensor(logits)).numpy()


@pytest.mark.parametrize("name", list(td.ENGINES)[:2] + list(td.FORWARDS))
def test_rank_forward_matches_jax_and_stacked(ranks, ranks2, ref, name):
    """Every rank returns the same logits: within the reference's pCTR
    tolerance, and bitwise the stacked path's where no bulk sum is on
    the way."""
    x, want = ref
    outs = ranks2 if name == "table_2" else ranks
    key = "forward" if name == "table_2" else ("forward", name)
    got = [out[key] for out in outs]
    assert all(torch.equal(g, got[0]) for g in got)
    np.testing.assert_allclose(_pctr(got[0]), _pctr(want[f"forward_{name}"]),
                               **PCTR_TOL)
    if name in td.FORWARDS:
        n, fields = td.FORWARDS[name]
        cfg = dataclasses.replace(tcfg_mod.smoke(), **fields)
    else:
        n = E
        cfg = dataclasses.replace(tcfg_mod.smoke(), rw_impl="a2a",
                                  rw_backend=td.ENGINES[name][1])
    stacked = tdlrm.forward(td._params(want), _t(x["dense"]), JaggedBatch(
        _t(x["fwd_idx"]), _t(x["fwd_lens"])), cfg, td._ctx((n,)))
    if cfg.sharding != "row" or cfg.rw_backend == "onesided":
        assert torch.equal(got[0], stacked)
    else:
        np.testing.assert_allclose(_pctr(got[0]), _pctr(stacked), **PCTR_TOL)


@pytest.mark.parametrize("name", list(ENGINES))
def test_rank_engine_matches_jax(ranks, ref, name):
    """Padded requests, served in lockstep by the ranks' engines: the same
    scores on every rank, the reference's within tolerance, and the
    stacked engine's bitwise on the one-sided route."""
    x, want = ref
    got = [out[("engine", name)] for out in ranks]
    assert all(np.array_equal(g, got[0]) for g in got)
    np.testing.assert_allclose(got[0], want[f"engine_{name}"], **PCTR_TOL)
    cfg = dataclasses.replace(tcfg_mod.smoke(), rw_impl="a2a",
                              rw_backend=ENGINES[name])
    eng = make_dlrm_engine(td._params(want), cfg, td.ENGINE_BATCH,
                           td._ctx((E,)), device="cpu")
    for i in range(td.ENGINE_REQS):
        eng.submit(CTRRequest(rid=i, dense=x["req_dense"][i],
                              indices=x["req_idx"][i],
                              lengths=x["req_lens"][i]))
    scores = eng.run_to_completion()
    stacked = np.array([scores[i] for i in range(td.ENGINE_REQS)])
    if ENGINES[name] == "onesided":
        np.testing.assert_array_equal(got[0], stacked)
    else:
        np.testing.assert_allclose(got[0], stacked, **PCTR_TOL)


# ---------------------------------------------------------------------------
# refusals and failures: no silent fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what, match", [
    ("row", r"R \(66\) divisible by 4"),
    ("column", r"D \(18\) divisible by 4"),
    ("table", r"T \(6\) divisible by 4"),
    ("tp_size", r"tp_size 5 != the group's 4 ranks"),
    ("no_card", "RuntimeError: no CUDA device"),
    ("symmetric_cpu", "symmetric buffers live on a card"),
    ("cache", "NotImplementedError: .*ParallelContext is not supported"),
])
def test_rank_refusals(ranks, what, match):
    import re

    for out in ranks:
        msg = out["refusals"][what]
        if what == "no_card" and out["refusals"]["cuda"]:
            # a card is present: the default device is the card
            assert msg is None, msg
            continue
        assert msg is not None and re.search(match, msg), msg


def test_two_by_two_context_of_the_world(ranks):
    """make_process_context(2, dp_size=2) in the world of 4: global rank
    g is model rank g % 2 of data group g // 2, as the reference's
    ("data", "model") mesh of 4 devices lays them out."""
    for g, out in enumerate(ranks):
        d, m = divmod(g, 2)
        assert out["dp_context"] == (2, d, m, 2, ("data",), None,
                                     [2 * d, 2 * d + 1], [m, m + 2]), g


def test_nccl_two_ranks_on_one_device_raises():
    with pytest.raises(ValueError, match="gloo"):
        parallel.run_ranks(_rank_cases, 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="share 1 device.*use backend='gloo'"):
        parallel._check_nccl([torch.device("cuda:0")] * 2)
    with pytest.raises(ValueError, match="backend must be one of"):
        parallel.run_ranks(_rank_cases, 2, backend="mpi", device="cpu")


def test_run_ranks_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run_ranks would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.run_ranks(_rank_cases, 2, backend="gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.run_ranks(_rank_cases, 2, backend="gloo", device="cuda:0")


def _raises_on_rank_1(ctx):
    if ctx.rank == 1:
        raise ValueError("rank 1 fails")
    torch.distributed.barrier(group=ctx.group)    # waits for rank 1
    return "unreachable"


def _hangs_on_rank_1(ctx):
    if ctx.rank == 1:
        time.sleep(120)
    torch.distributed.barrier(group=ctx.group)
    return "unreachable"


def _returns_rank_info(ctx, scale):
    t = torch.full((3,), float(ctx.rank) * scale)
    return comm.all_reduce(t, ctx=ctx), ctx.rank, ctx.world, str(ctx.device)


def test_run_ranks_returns_rank_zeros_result():
    total, rank, world, dev = parallel.run_ranks(
        _returns_rank_info, 3, backend="gloo", device="cpu", args=(2.0,))
    assert (rank, world, dev) == (0, 3, "cpu")
    assert torch.equal(total, torch.full((3,), 6.0))


def test_a_rank_that_raises_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        parallel.run_ranks(_raises_on_rank_1, 2, backend="gloo",
                           device="cpu", timeout_s=60)
    assert time.monotonic() - t0 < 30


def test_a_rank_that_hangs_fails_the_run_within_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(Exception):
        parallel.run_ranks(_hangs_on_rank_1, 2, backend="gloo",
                           device="cpu", timeout_s=4)
    assert time.monotonic() - t0 < 30


def test_process_context_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="not initialised"):
        parallel.make_process_context(2, device="cpu")
