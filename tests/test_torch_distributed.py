"""The port's distributed embedding bag against the JAX package, on the CPU.

The reference shards its tables over a jax mesh, one device per rank, so
its side runs ONCE per module in a subprocess with ``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` and ``JAX_PLATFORMS=cpu`` set
before JAX is imported: this file run as a script, reading the numpy
inputs from one ``.npz`` and writing the reference's outputs to another.
Its one-sided collectives run the Pallas kernels in interpret mode
(``comm.set_onesided_mode("interpret")``), on a 1-D ``("model",)`` mesh:
interpret mode cannot run them on a 2-D mesh under the installed jax, so
the ``(2, 2)`` ``("data", "model")`` case is bulk only.  The port
simulates the same ranks in one process.

Tolerances:

  * the raw collectives (all-to-all, reduce-scatter, ring permute) move or
    add the same values in the same order: bitwise;
  * the column-, table-wise and replicated strategies pool each output
    element from the same rows in the same order as the port's own local
    lookup: bitwise against it, and against the reference within the
    local lookup's own parity tolerance (``rtol=1e-5, atol=1e-6``,
    ``tests/test_torch_kernels.py``: two frameworks' f32 pooling);
  * row-wise sums E partials, and the a2a path segment-sums, in another
    order than the reference: ``atol=1e-6`` (the pooled vectors are sums
    of at most 4 rows of N(0, 1/16) values; one f32 rounding of such a sum
    is below 3e-7); ``rs_dtype="bfloat16"`` rounds each partial to bf16
    on both sides, and the two round sums of different order: ``atol=2e-2``
    (a bf16 ulp near 1 is 2**-7 = 7.8e-3);
  * dropped lookups are a count of the same bucketing: exactly equal;
  * logits and pCTR go through two frameworks' MLPs: ``atol=1e-6`` (what
    the remote-tier engine check holds, ``tests/test_torch_remote.py``).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import dlrm as tcfg_mod
from repro_torch.core import comm
from repro_torch.core import embedding_bag as teb
from repro_torch.core.cache_config import CacheConfig
from repro_torch.core.jagged import JaggedBatch
from repro_torch.core.parallel import ParallelContext, make_context
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import onesided_a2a as oa
from repro_torch.models import dlrm as tdlrm
from repro_torch.serving.engine import CTRRequest, DLRMEngine, \
    make_dlrm_engine
from repro_torch.utils.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
E = 4                                   # ranks of the model axis
T, R, D, B, L = 4, 64, 16, 16, 4        # T = 8 for table-wise
ROW_ATOL = 1e-6
BF16_ATOL = 2e-2
LOCAL = dict(rtol=1e-5, atol=1e-6)
PCTR_ATOL = 1e-6
ENGINE_REQS, ENGINE_BATCH = 6, 8        # two all-padding rows per flush
BACKENDS = ("bulk", "onesided")

# name -> (EmbeddingBagConfig fields, pooled_lookup_sharded keywords)
CASES = {
    "row_allgather": (dict(sharding="row"), {}),
    "row_allgather_weighted": (dict(sharding="row"), {}),
    "row_allgather_scatter": (dict(sharding="row"),
                              dict(scatter_batch=True)),
    "row_allgather_rs_bf16": (dict(sharding="row", rs_dtype="bfloat16"),
                              {}),
    "row_a2a_bulk": (dict(sharding="row", rw_impl="a2a"), {}),
    "row_a2a_onesided": (dict(sharding="row", rw_impl="a2a",
                              rw_backend="onesided"), {}),
    "row_a2a_emulate_rs": (dict(sharding="row", rw_impl="a2a",
                                emulate_rs_with_a2a=True), {}),
    "row_a2a_mean": (dict(sharding="row", rw_impl="a2a", combiner="mean"),
                     {}),
    "row_a2a_weighted": (dict(sharding="row", rw_impl="a2a"), {}),
    "row_a2a_rs_bf16": (dict(sharding="row", rw_impl="a2a",
                             rs_dtype="bfloat16"), {}),
    "column": (dict(sharding="column"), {}),
    "column_keep_sharded": (dict(sharding="column"),
                            dict(keep_sharded=True)),
    "table": (dict(sharding="table"), {}),
    "replicated": (dict(sharding="replicated"), {}),
}
EXACT = ("column", "column_keep_sharded", "table", "replicated")
HOT_CASES = {"hot_row_allgather": dict(sharding="row", hot_rows=8),
             "hot_row_a2a_onesided_mean": dict(
                 sharding="row", rw_impl="a2a", rw_backend="onesided",
                 combiner="mean", hot_rows=8)}
DROP_CF = 0.5                           # a small capacity factor
# the DLRM engine cases: (mesh shape, rw_backend); 1-D meshes are (E,)
ENGINES = {"a2a_bulk": ((E,), "bulk"), "a2a_onesided": ((E,), "onesided"),
           "a2a_bulk_2x2": ((2, 2), "bulk")}


def _num_tables(name: str) -> int:
    return 8 if name.startswith("table") else T


def _inputs() -> dict:
    """Every input of both sides, numpy from one seed."""
    rng = np.random.default_rng(13)
    x = {}
    x["a2a_int32"] = rng.integers(-5, 10**6, (E, E, 6)).astype(np.int32)
    x["a2a_float32"] = rng.standard_normal((E, E, 5, 3)).astype(np.float32)
    # bf16 values, carried as the f32 numbers they are
    x["a2a_bfloat16"] = torch.randn(
        (E, E, 5, 3), generator=torch.Generator().manual_seed(3)).to(
        torch.bfloat16).float().numpy()
    x["rs_float32"] = rng.standard_normal((E, E, 5, 3)).astype(np.float32)
    x["ring_float32"] = rng.standard_normal((E, 7, 3)).astype(np.float32)
    x["tables"] = (rng.standard_normal((8, R, D)) * D ** -0.5).astype(
        np.float32)
    # ragged lengths (0 included) and -1 padding beyond them
    lens = rng.integers(0, L + 1, (8, B)).astype(np.int32)
    idx = rng.integers(0, R, (8, B, L)).astype(np.int32)
    idx[np.arange(L) >= lens[..., None]] = -1
    x["idx"], x["lens"] = idx, lens
    x["weights"] = rng.random((8, B, L)).astype(np.float32)
    cfg = tcfg_mod.smoke()
    tt, ll, ff = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    x["dense"] = rng.standard_normal((B, ff)).astype(np.float32)
    x["fwd_idx"] = rng.integers(0, cfg.rows_per_table, (tt, B, ll)).astype(
        np.int32)
    x["fwd_lens"] = rng.integers(0, ll + 1, (tt, B)).astype(np.int32)
    x["req_dense"] = rng.standard_normal((ENGINE_REQS, ff)).astype(
        np.float32)
    x["req_idx"] = rng.integers(0, cfg.rows_per_table,
                                (ENGINE_REQS, tt, ll)).astype(np.int32)
    x["req_lens"] = rng.integers(0, ll + 1, (ENGINE_REQS, tt)).astype(
        np.int32)
    # int32 partials over the whole range: their sums over 4 ranks overflow
    x["rs_int32"] = rng.integers(-2**31, 2**31, (E, E, 5, 3)).astype(
        np.int32)
    return x


def _batch_arrays(x: dict, name: str):
    """(indices, lengths, weights or None) numpy for case ``name``."""
    t = _num_tables(name)
    w = x["weights"][:t] if name.endswith("weighted") else None
    return x["idx"][:t], x["lens"][:t], w


def _jax_reference(inputs: Path, outputs: Path) -> None:
    """The reference's outputs on ``inputs``; runs in the subprocess, with
    four forced CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import dlrm as jcfg_mod
    from repro.core import comm as jcomm
    from repro.core import embedding_bag as jeb
    from repro.core.jagged import JaggedBatch as JJagged
    from repro.core.parallel import make_context as jmake_context
    from repro.kernels import onesided_a2a as joa
    from repro.models import dlrm as jdlrm
    from repro.serving.engine import CTRRequest as JRequest
    from repro.serving.engine import DLRMEngine as JEngine
    from repro.utils.compat import shard_map

    assert len(jax.devices()) == E, jax.devices()
    jcomm.set_onesided_mode("interpret")
    x = dict(np.load(inputs))
    mesh = jax.make_mesh((E,), ("model",))
    out = {}

    def per_rank(fn, *arrays):
        """fn on each rank's block of the stacked arrays, re-stacked."""
        return np.asarray(jax.jit(shard_map(
            lambda *a: fn(*(v[0] for v in a))[None], mesh=mesh,
            in_specs=(P("model"),) * len(arrays), out_specs=P("model"),
            check_vma=False))(*arrays))

    for dt in ("int32", "float32", "bfloat16"):                    # (a)
        a = x[f"a2a_{dt}"]
        a = jnp.asarray(a, jnp.bfloat16) if dt == "bfloat16" else a
        got = per_rank(lambda v: joa.onesided_all_to_all(
            v, "model", interpret=True), a)
        out[f"a2a_{dt}"] = got.astype(np.float32) if dt == "bfloat16" \
            else got
    for dt in ("float32", "int32"):
        out[f"rs_{dt}"] = per_rank(lambda v: joa.onesided_reduce_scatter(
            v, "model", interpret=True), x[f"rs_{dt}"])
    out["ar_int32"] = per_rank(lambda v: jcomm.all_reduce(v, "model"),
                               x["rs_int32"][:, 0])
    for shift in (1, 3):
        out[f"ring_{shift}"] = per_rank(
            lambda v, s=shift: joa.onesided_ring_permute(
                v[None], "model", shift=s, interpret=True)[0],
            x["ring_float32"])

    def sharded(cfg, name, fn, out_specs):
        idx, lens, w = _batch_arrays(x, name)
        tables = jnp.asarray(x["tables"][:cfg.num_tables])
        batch = JJagged(jnp.asarray(idx), jnp.asarray(lens),
                        None if w is None else jnp.asarray(w))
        return jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(jeb.table_pspec(cfg), P()),
            out_specs=out_specs, check_vma=False))(tables, batch)

    for name, (fields, kw) in CASES.items():                       # (b)
        cfg = jeb.EmbeddingBagConfig(num_tables=_num_tables(name),
                                     rows_per_table=R, dim=D, **fields)
        spec = P()
        if kw.get("scatter_batch"):
            spec = P("model")
        elif kw.get("keep_sharded"):
            spec = P(None, None, "model")
        with jcomm.instrument() as events:
            got = sharded(cfg, name, lambda t, b, c=cfg, k=kw:
                          jeb.pooled_lookup_sharded(t, b, c, **k), spec)
        out[name] = np.asarray(got, np.float32)
        out[f"events_{name}"] = np.array(
            [f"{e.op}:{e.bytes_in}:{e.axis_size}:{e.backend}"
             for e in events])
    for name, fields in HOT_CASES.items():
        cfg = jeb.EmbeddingBagConfig(num_tables=T, rows_per_table=R, dim=D,
                                     **fields)
        hot = jeb.extract_hot_table(jnp.asarray(x["tables"][:T]), cfg)
        out[name] = np.asarray(sharded(
            cfg, name, lambda t, b, c=cfg: jeb.pooled_lookup_hot(
                t, hot, b, c), P()))
    for be in BACKENDS:                                            # (c)
        cfg = jeb.EmbeddingBagConfig(
            num_tables=T, rows_per_table=R, dim=D, sharding="row",
            rw_impl="a2a", rw_backend=be, capacity_factor=DROP_CF)
        pooled, dropped = sharded(
            cfg, "drops", lambda t, b, c=cfg: (
                lambda r: (r[0], r[1][None]))(
                jeb.pooled_lookup_rw_a2a_with_stats(t, b, c)),
            (P(), P("model")))
        out[f"drops_pooled_{be}"] = np.asarray(pooled)
        out[f"drops_{be}"] = np.asarray(dropped)

    base = jcfg_mod.smoke()                                        # (d)
    params = jax.tree_util.tree_map(
        np.asarray, jdlrm.init_params(jax.random.key(0), base))
    out["p_tables"] = params["tables"]
    for part in ("bottom", "top"):
        for i, layer in enumerate(params[part]):
            out[f"p_{part}_{i}_w"] = layer["w"]
            out[f"p_{part}_{i}_b"] = layer["b"]
    for name, (shape, be) in ENGINES.items():
        names = ("model",) if len(shape) == 1 else ("data", "model")
        ctx = jmake_context(jax.make_mesh(shape, names))
        cfg = dataclasses.replace(base, rw_impl="a2a", rw_backend=be)
        out[f"forward_{name}"] = np.asarray(jdlrm.forward(
            params, jnp.asarray(x["dense"]), JJagged(
                jnp.asarray(x["fwd_idx"]), jnp.asarray(x["fwd_lens"])),
            cfg, ctx))
        eng = JEngine(params, cfg, ENGINE_BATCH, ctx)
        for i in range(ENGINE_REQS):
            eng.submit(JRequest(rid=i, dense=x["req_dense"][i],
                                indices=x["req_idx"][i],
                                lengths=x["req_lens"][i]))
        scores = eng.run_to_completion()
        out[f"engine_{name}"] = np.array(
            [scores[i] for i in range(ENGINE_REQS)])
    ctx2 = jmake_context(jax.make_mesh((2, 2), ("data", "model")))
    out["dp_for"] = np.array([len(ctx2.dp_for(8) or ()),
                              len(ctx2.dp_for(3) or ()), ctx2.dp_size,
                              ctx2.tp_size])
    np.savez(outputs, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, the JAX reference's outputs), computed once per module."""
    tmp = tmp_path_factory.mktemp("distributed_ref")
    x = _inputs()
    np.savez(tmp / "inputs.npz", **x)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={E}"}
    proc = subprocess.run(
        [sys.executable, __file__, str(tmp / "inputs.npz"),
         str(tmp / "outputs.npz")], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return x, dict(np.load(tmp / "outputs.npz"))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _ecfg(name_or_t, **fields):
    t = name_or_t if isinstance(name_or_t, int) else _num_tables(name_or_t)
    return teb.EmbeddingBagConfig(num_tables=t, rows_per_table=R, dim=D,
                                  **fields)


def _batch(x, name) -> JaggedBatch:
    idx, lens, w = _batch_arrays(x, name)
    return JaggedBatch(_t(idx), _t(lens), None if w is None else _t(w))


def _params(want):
    cfg = tcfg_mod.smoke()
    return params_from_numpy({
        "tables": want["p_tables"],
        **{part: [{"w": want[f"p_{part}_{i}_w"], "b": want[f"p_{part}_{i}_b"]}
                  for i in range(len(getattr(cfg, f"{part}_mlp")))]
           for part in ("bottom", "top")}}, device="cpu")


def _ctx(shape):
    return make_context(tp_size=shape[-1],
                        dp_size=1 if len(shape) == 1 else shape[0])


# ---------------------------------------------------------------------------
# (a) the raw collectives: the kernels' plain versions, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["int32", "float32", "bfloat16"])
def test_onesided_all_to_all_matches_jax(ref, dt):
    x, want = ref
    a = _t(x[f"a2a_{dt}"])
    if dt == "bfloat16":
        a = a.to(torch.bfloat16)
    got = oa.onesided_all_to_all(a)
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got.float().numpy() if dt == "bfloat16"
                                  else got.numpy(), want[f"a2a_{dt}"])
    # the bulk route moves the same chunks
    assert torch.equal(comm.all_to_all(a, backend="bulk"), got)
    assert torch.equal(comm.all_to_all(a, backend="onesided"), got)


def test_onesided_reduce_scatter_matches_jax(ref):
    x, want = ref
    a = _t(x["rs_float32"])
    got = oa.onesided_reduce_scatter(a)
    np.testing.assert_array_equal(got.numpy(), want["rs_float32"])
    for kw in (dict(backend="bulk"), dict(backend="onesided"),
               dict(backend="bulk", emulate_with_a2a=True)):
        assert torch.equal(comm.reduce_scatter(a, **kw), got), kw


RS_INT32_ROUTES = {
    "onesided": lambda a: oa.onesided_reduce_scatter(a),
    "plain": lambda a: oa.onesided_reduce_scatter_ref(a),
    "comm_onesided": lambda a: comm.reduce_scatter(a, backend="onesided"),
    "comm_bulk": lambda a: comm.reduce_scatter(a, backend="bulk"),
    "comm_bulk_emulate": lambda a: comm.reduce_scatter(
        a, backend="bulk", emulate_with_a2a=True),
}


@pytest.mark.parametrize("route", list(RS_INT32_ROUTES))
def test_int32_reduce_scatter_matches_jax(ref, route):
    """An int32 sum over ranks stays int32 and wraps modulo 2**32, as the
    reference's does: the partials' sums overflow."""
    x, want = ref
    a = _t(x["rs_int32"])
    assert not torch.equal(a.long().sum(0), a.long().sum(0).int().long())
    got = RS_INT32_ROUTES[route](a)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want["rs_int32"])


def test_int32_all_reduce_matches_jax(ref):
    x, want = ref
    got = comm.all_reduce(_t(x["rs_int32"][:, 0]))
    assert got.dtype == torch.int32
    for r in range(E):          # every rank holds the same sum
        np.testing.assert_array_equal(got.numpy(), want["ar_int32"][r])


@pytest.mark.parametrize("shift", [1, 3])
def test_onesided_ring_permute_matches_jax(ref, shift):
    x, want = ref
    a = _t(x["ring_float32"])
    got = oa.onesided_ring_permute(a, shift)
    np.testing.assert_array_equal(got.numpy(), want[f"ring_{shift}"])
    for be in BACKENDS:
        assert torch.equal(comm.permute_ring(a, shift=shift, backend=be),
                           got)


# ---------------------------------------------------------------------------
# (b) pooled_lookup_sharded, every strategy; pooled_lookup_hot
# ---------------------------------------------------------------------------

def _sharded_case(x, name):
    fields, kw = CASES[name]
    cfg = _ecfg(name, **fields)
    tables = _t(x["tables"][:cfg.num_tables])
    shards = teb.shard_tables(tables, cfg, E)
    with comm.instrument() as events:
        got = teb.pooled_lookup_sharded(shards, _batch(x, name), cfg, **kw)
    return cfg, tables, got, events


@pytest.mark.parametrize("name", list(CASES))
def test_pooled_lookup_sharded_matches_jax(ref, name):
    x, want = ref
    cfg, tables, got, _ = _sharded_case(x, name)
    kw = CASES[name][1]
    if kw.get("scatter_batch"):
        assert got.shape == (E, B // E, T, D)
        got = got.reshape(B, T, D)
    elif kw.get("keep_sharded"):
        assert got.shape == (E, B, T, D // E)
        got = got.permute(1, 2, 0, 3).reshape(B, T, D)
    assert got.dtype == torch.float32
    local = teb.pooled_lookup_local(tables, _batch(x, name), cfg)
    if name in EXACT:
        assert torch.equal(got, local)
        np.testing.assert_allclose(got.numpy(), want[name], **LOCAL)
    else:
        atol = BF16_ATOL if name.endswith("bf16") else ROW_ATOL
        np.testing.assert_allclose(got.numpy(), want[name], rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("name", ["row_allgather", "row_a2a_bulk",
                                  "row_a2a_onesided", "row_allgather_scatter",
                                  "column", "column_keep_sharded", "table"])
def test_collective_events_match_jax(ref, name):
    """One event per collective call, with the reference's op, one rank's
    payload bytes, axis size and backend, in the same order."""
    x, want = ref
    *_, events = _sharded_case(x, name)
    got = [f"{e.op}:{e.bytes_in}:{e.axis_size}:{e.backend}" for e in events]
    assert got == want[f"events_{name}"].tolist()
    assert all(e.t0 == e.t1 > 0 for e in events)


@pytest.mark.parametrize("name", list(HOT_CASES))
def test_pooled_lookup_hot_matches_jax(ref, name):
    x, want = ref
    cfg = _ecfg(T, **HOT_CASES[name])
    tables = _t(x["tables"][:T])
    hot = teb.extract_hot_table(tables, cfg)
    assert hot.shape == (T, 8, D) and hot.is_contiguous()
    got = teb.pooled_lookup_hot(teb.shard_tables(tables, cfg, E), hot,
                                _batch(x, name), cfg)
    np.testing.assert_allclose(got.numpy(), want[name], rtol=0,
                               atol=ROW_ATOL)
    if cfg.rw_impl == "allgather":        # exact; a2a drops padded traffic
        np.testing.assert_allclose(
            got.numpy(), teb.pooled_lookup_local(tables, _batch(x, name),
                                                 cfg).numpy(), rtol=0,
            atol=ROW_ATOL)


# ---------------------------------------------------------------------------
# (c) dropped lookups of the paper-faithful a2a pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_a2a_drops_match_jax(ref, backend):
    """Padded traffic at a small capacity factor: the same lookups dropped
    on every rank, and the same pooled vectors without them."""
    x, want = ref
    cfg = _ecfg(T, sharding="row", rw_impl="a2a", rw_backend=backend,
                capacity_factor=DROP_CF)
    tables = _t(x["tables"][:T])
    pooled, dropped = teb.pooled_lookup_rw_a2a_with_stats(
        teb.shard_tables(tables, cfg, E), _batch(x, "drops"), cfg)
    assert dropped.shape == (E,) and int(dropped.sum()) > 0
    np.testing.assert_array_equal(dropped.numpy(), want[f"drops_{backend}"])
    np.testing.assert_allclose(pooled.numpy(),
                               want[f"drops_pooled_{backend}"], rtol=0,
                               atol=ROW_ATOL)


def test_padding_fills_rank_zeros_bucket():
    """The reference's semantics, kept: padded slots (id -1) are owned by
    rank 0 and take its bucket's places, so live lookups that rank 0 owns
    are dropped although fewer than the capacity are live."""
    E_, C = 2, 3
    ids = torch.tensor([-1, -1, -1, 0, 5, 1], dtype=torch.int32)
    w = torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.float32)
    seg = torch.arange(6, dtype=torch.int32)
    send_i, send_w, send_s, dropped = teb._bucket_by_owner(
        ids, w, seg, E_, C, rows_per_shard=4)
    assert int(dropped) == 2                  # ids 0 and 1, past pos 3
    # the send buffers go to the chunk-put kernel, which takes contiguous
    # tensors
    assert all(b.is_contiguous() for b in (send_i, send_w, send_s))
    assert send_w.tolist() == [[0, 0, 0], [1, 0, 0]]
    assert send_i.tolist() == [[0, 0, 0], [5, 0, 0]]
    assert send_s.tolist() == [[-1, -1, -1], [4, -1, -1]]


# ---------------------------------------------------------------------------
# (d) the DLRM forward and the engine with a context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ENGINES))
def test_forward_with_context_matches_jax(ref, name):
    x, want = ref
    shape, be = ENGINES[name]
    cfg = dataclasses.replace(tcfg_mod.smoke(), rw_impl="a2a", rw_backend=be)
    params = _params(want)
    got = tdlrm.forward(params, _t(x["dense"]), JaggedBatch(
        _t(x["fwd_idx"]), _t(x["fwd_lens"])), cfg, _ctx(shape))
    np.testing.assert_allclose(got.numpy(), want[f"forward_{name}"],
                               rtol=0, atol=PCTR_ATOL)
    loss = tdlrm.bce_loss(params, _t(x["dense"]), JaggedBatch(
        _t(x["fwd_idx"]), _t(x["fwd_lens"])), torch.ones(B), cfg,
        _ctx(shape))
    assert torch.isfinite(loss)


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_with_context_matches_jax(ref, name):
    """Padded requests (6 in a batch of 8: the filler rows' slots count
    against rank 0's buckets), scored as the reference scores them."""
    x, want = ref
    shape, be = ENGINES[name]
    cfg = dataclasses.replace(tcfg_mod.smoke(), rw_impl="a2a", rw_backend=be)
    eng = make_dlrm_engine(_params(want), cfg, ENGINE_BATCH, _ctx(shape),
                           device="cpu")
    assert isinstance(eng.params["tables"], teb.ShardedTables)
    assert eng.params["tables"].num_shards == shape[-1]
    for i in range(ENGINE_REQS):
        eng.submit(CTRRequest(rid=i, dense=x["req_dense"][i],
                              indices=x["req_idx"][i],
                              lengths=x["req_lens"][i]))
    scores = eng.run_to_completion()
    got = np.array([scores[i] for i in range(ENGINE_REQS)])
    np.testing.assert_allclose(got, want[f"engine_{name}"], rtol=0,
                               atol=PCTR_ATOL)


def test_context_axes_match_jax(ref):
    _, want = ref
    ctx = make_context(tp_size=2, dp_size=2)
    assert [len(ctx.dp_for(8) or ()), len(ctx.dp_for(3) or ()),
            ctx.dp_size, ctx.tp_size] == want["dp_for"].tolist()
    assert (ctx.dp_groups(8), ctx.dp_groups(3)) == (2, 1)
    one = make_context(tp_size=4)
    assert one.dp_for(8) is None and one.dp_groups(8) == 1
    # the data axis follows dp_size, however the context is built
    direct = ParallelContext(tp_size=2, dp_size=2)
    assert direct == ctx and direct.dp_axes == ("data",)
    assert (direct.dp_groups(8), direct.dp_groups(3)) == (2, 1)


# ---------------------------------------------------------------------------
# (e) the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sharding, t, dim, match", [
    ("row", 4, 16, r"R \(64\) divisible by 3"),
    ("column", 4, 16, r"D \(16\) divisible by 3"),
    ("table", 4, 16, r"T \(4\) divisible by 3"),
])
def test_shard_counts_that_do_not_divide_raise(sharding, t, dim, match):
    cfg = teb.EmbeddingBagConfig(num_tables=t, rows_per_table=R, dim=dim,
                                 sharding=sharding)
    with pytest.raises(ValueError, match=match):
        teb.shard_tables(torch.zeros((t, R, dim)), cfg, 3)
    # replicated tables take any count
    teb.shard_tables(torch.zeros((t, R, dim)),
                     dataclasses.replace(cfg, sharding="replicated"), 3)


def test_shards_are_views_except_columns():
    tables = torch.randn((4, R, D))
    for sharding in ("row", "table", "replicated"):
        s = teb.shard_tables(tables, _ecfg(4, sharding=sharding), E)
        assert s.tables.data_ptr() == tables.data_ptr()
        assert s.shard(1).data_ptr() != tables.data_ptr() or \
            sharding == "replicated"
    s = teb.shard_tables(tables, _ecfg(4, sharding="row"), E)
    assert torch.equal(s.shard(2), tables[:, 32:48])
    c = teb.shard_tables(tables, _ecfg(4, sharding="column"), E)
    assert c.tables.shape == (E, 4, R, D // E)
    assert torch.equal(c.shard(3), tables[..., 12:16])


def test_bad_configs_and_batches_raise():
    with pytest.raises(ValueError, match="sharding"):
        teb.EmbeddingBagConfig(num_tables=4, rows_per_table=R, dim=D,
                               sharding="diagonal")
    with pytest.raises(ValueError, match="rw_backend"):
        teb.EmbeddingBagConfig(num_tables=4, rows_per_table=R, dim=D,
                               rw_backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        comm.all_to_all(torch.zeros((E, E, 2)), backend="nvshmem")
    cfg = _ecfg(4, sharding="row", rw_impl="a2a")
    shards = teb.shard_tables(torch.zeros((4, R, D)), cfg, E)
    odd = JaggedBatch(torch.zeros((4, 6, L), dtype=torch.int32),
                      torch.ones((4, 6), dtype=torch.int32))
    with pytest.raises(ValueError, match="divisible by 4 ranks"):
        teb.pooled_lookup_sharded(shards, odd, cfg)
    with pytest.raises(ValueError, match="sharded 'row', config 'column'"):
        teb.pooled_lookup_sharded(shards, odd,
                                  dataclasses.replace(cfg, sharding="column"))


def test_cache_with_context_raises():
    cfg = dataclasses.replace(tcfg_mod.smoke(), cache=CacheConfig(rows=8))
    params = tdlrm.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    with pytest.raises(NotImplementedError, match="ParallelContext"):
        DLRMEngine(params, cfg, 4, make_context(tp_size=E), device="cpu")


def test_cpu_path_launches_nothing():
    """Every strategy and collective on CPU tensors takes the plain
    versions: no kernel is launched."""
    oa.reset_launch_counts()
    eg.reset_launch_counts()
    rng = np.random.default_rng(0)
    tables = torch.randn((8, R, D))
    batch = JaggedBatch(_t(rng.integers(0, R, (8, B, L)).astype(np.int32)),
                        torch.full((8, B), L, dtype=torch.int32))
    for fields, _ in CASES.values():
        cfg = _ecfg(8, **{**fields, "rw_backend": "onesided"})
        teb.pooled_lookup_sharded(teb.shard_tables(tables, cfg, E), batch,
                                  cfg)
    a = torch.randn((E, E, 3))
    comm.permute_ring(a, backend="onesided")
    oa.onesided_reduce_scatter(a)
    assert set(oa.LAUNCH_COUNTS.values()) == {0}
    assert set(eg.LAUNCH_COUNTS.values()) == {0}


@pytest.mark.parametrize("fn", [
    oa.onesided_all_to_all, oa.onesided_reduce_scatter,
    lambda a: oa.onesided_ring_permute(a, 1)])
def test_chunk_kernels_refuse_other_devices(fn):
    """No silent fallback: a tensor neither on the CPU nor on a card is
    refused, never sent to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.empty((E, E, 4), device="meta"))


def test_plain_versions_are_the_library_calls():
    """The library yardsticks compute the same functions, bitwise:
    ``transpose(0, 1)`` for the all-to-all, a sum over sources for the
    reduce-scatter, ``torch.roll`` for the ring."""
    a = torch.randn((E, E, 5, 3))
    for dtype in (torch.float32, torch.bfloat16):
        ad = a.to(dtype)
        assert torch.equal(oa.onesided_all_to_all_ref(ad),
                           ad.transpose(0, 1).contiguous())
        assert torch.equal(oa.onesided_reduce_scatter_ref(ad), ad.sum(0))
    ids = torch.arange(E * E * 3, dtype=torch.int32).reshape(E, E, 3)
    assert torch.equal(oa.onesided_all_to_all_ref(ids),
                       ids.transpose(0, 1).contiguous())
    for shift in (1, 3, -1):
        assert torch.equal(oa.onesided_ring_permute_ref(a[0], shift),
                           torch.roll(a[0], shift, dims=0))


if __name__ == "__main__":
    _jax_reference(Path(sys.argv[1]), Path(sys.argv[2]))
