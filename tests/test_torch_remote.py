"""The port's remote cold tier against the JAX package, on the CPU.

The reference needs one jax device per simulated host, so its side runs
ONCE per test session in a subprocess with ``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` and ``JAX_PLATFORMS=cpu`` set
before JAX is imported (as ``tests/test_tiering.py`` runs
``tests/_tiering_checks.py``): this file run as a script, reading the
numpy inputs from one ``.npz`` and writing the reference's outputs to
another, which ``tests/test_torch_remote_ranks.py`` reads too.  Its
one-sided transport runs the Pallas kernel in interpret mode.

Tolerances: every comparison is bitwise (``np.testing.assert_array_equal``
/ ``torch.equal``) -- a fetched row is a copy, and the sum over owners adds
one value to zeros -- except the engine's pCTR, which goes through two
frameworks' MLPs and agrees to ``atol=1e-6`` (what the reference's own
remote-tier engine check holds against its direct forward).
"""
import dataclasses
import fcntl
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.cache import HostStore, RemoteStore
from repro_torch.cache.cached_bag import CachedEmbeddingBag, make_cold_store
from repro_torch.cache.tiers import _pad_pow2
from repro_torch.configs import dlrm as tcfg_mod
from repro_torch.core import comm
from repro_torch.core import embedding_bag as teb
from repro_torch.core.cache_config import CacheConfig
from repro_torch.core.jagged import JaggedBatch
from repro_torch.kernels import build
from repro_torch.kernels import onesided_a2a as oa
from repro_torch.serving.engine import CTRRequest, DLRMEngine
from repro_torch.utils.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
H = 4                                   # simulated hosts
T, R, D = 2, 64, 8                      # the bag's tables
BACKENDS = ("bulk", "onesided")
BAG = dict(batches=3, batch=4, pooling=3, cache_rows=32)
ENGINE_REQS, ENGINE_BATCH, ENGINE_ROWS = 6, 4, 64
PCTR_ATOL = 1e-6
RING_SHIFTS = (1, -1, 2)                # the ring permute's shifts
STATS = ("hits", "misses", "misses_host", "misses_remote", "evictions",
         "bytes_h2d", "bytes_remote", "fetch_host", "fetch_remote",
         "batches")


def _inputs() -> dict:
    """Every input of both sides, numpy from one seed.  Tables and shards
    are N(0, 1): about half their values are negative, so the non-owners'
    ``0 * row`` contributions hold ``-0.0``."""
    rng = np.random.default_rng(12)
    x = {}
    rows_local, m = 8, 10
    x["shards"] = rng.standard_normal((H, rows_local, D)).astype(np.float32)
    x["owner"] = rng.integers(0, H, m).astype(np.int32)
    x["addr"] = rng.integers(0, rows_local, m).astype(np.int32)
    # a real fetch's contributions: rank r holds the rows it owns of each
    # requester's request, 0 * row elsewhere
    rows = rng.standard_normal((H, H, 6, D)).astype(np.float32)
    own = rng.integers(0, H, (H, 6))
    x["contribs"] = rows * (own[None] == np.arange(H)[:, None, None]
                            )[..., None].astype(np.float32)
    x["tables"] = rng.standard_normal((T, R, D)).astype(np.float32)
    x["t_ids"] = rng.integers(0, T, 5)
    x["row_ids"] = np.array([3, 17, 40, 63, 0])       # hosts 0, 1, 2, 3, 0
    nb, b, lp = BAG["batches"], BAG["batch"], BAG["pooling"]
    x["bag_idx"] = np.minimum(rng.zipf(1.3, (nb, T, b, lp)) - 1,
                              R - 1).astype(np.int32)
    x["bag_lens"] = rng.integers(0, lp + 1, (nb, T, b)).astype(np.int32)
    cfg = tcfg_mod.smoke()
    tt, ll, ff = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    x["req_dense"] = rng.standard_normal((ENGINE_REQS, ff)).astype(
        np.float32)
    x["req_idx"] = rng.integers(0, cfg.rows_per_table,
                                (ENGINE_REQS, tt, ll)).astype(np.int32)
    x["req_lens"] = rng.integers(0, ll + 1, (ENGINE_REQS, tt)).astype(
        np.int32)
    # each host's own request (the per-rank fetch), and one block a host
    # for the ring permute
    x["rank_addr"] = rng.integers(0, rows_local, (H, m)).astype(np.int32)
    x["rank_owner"] = rng.integers(0, H, (H, m)).astype(np.int32)
    x["ring"] = rng.standard_normal((H, 6, D)).astype(np.float32)
    return x


def _events(events) -> np.ndarray:
    return np.array([f"{e.op}:{e.bytes_in}:{e.axis_size}:{e.backend}"
                     for e in events])


def _jax_reference(inputs: Path, outputs: Path) -> None:
    """The reference's outputs on ``inputs``; runs in the subprocess, with
    four forced CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.cache import CacheConfig as JCacheConfig
    from repro.cache import RemoteStore as JRemoteStore
    from repro.configs import dlrm as jcfg_mod
    from repro.core import comm as jcomm
    from repro.core.embedding_bag import EmbeddingBagConfig, make_cache
    from repro.core.jagged import JaggedBatch as JJagged
    from repro.kernels.onesided_a2a import onesided_fetch_rows
    from repro.models import dlrm as jdlrm
    from repro.serving.engine import CTRRequest as JRequest
    from repro.serving.engine import DLRMEngine as JEngine
    from repro.utils.compat import shard_map

    assert len(jax.devices()) == H, jax.devices()
    x = dict(np.load(inputs))
    mesh = Mesh(np.asarray(jax.devices()), ("hosts",))
    out = {}
    for be in BACKENDS:                                           # (a)
        fetch = shard_map(
            lambda s, a, o, be=be: jcomm.fetch_rows(
                s[0], a, o, "hosts", backend=be, onesided_mode="interpret"),
            mesh=mesh, in_specs=(P("hosts"), P(), P()), out_specs=P(),
            check_vma=False)
        with jcomm.instrument() as events:
            out[f"fetch_{be}"] = np.asarray(jax.jit(fetch)(
                x["shards"], x["addr"], x["owner"]))
        out[f"events_fetch_{be}"] = _events(events)
        # each host its own request: host h's rows at [h]
        fetch = shard_map(
            lambda s, a, o, be=be: jcomm.fetch_rows(
                s[0], a[0], o[0], "hosts", backend=be,
                onesided_mode="interpret")[None],
            mesh=mesh, in_specs=(P("hosts"),) * 3, out_specs=P("hosts"),
            check_vma=False)
        with jcomm.instrument() as events:
            out[f"fetch_ranks_{be}"] = np.asarray(jax.jit(fetch)(
                x["shards"], x["rank_addr"], x["rank_owner"]))
        out[f"events_fetch_ranks_{be}"] = _events(events)
        for shift in RING_SHIFTS:                                 # ppermute
            perm = shard_map(
                lambda b, be=be, shift=shift: jcomm.permute_ring(
                    b, "hosts", shift=shift, backend=be),
                mesh=mesh, in_specs=(P("hosts"),), out_specs=P("hosts"),
                check_vma=False)
            with jcomm.instrument() as events:
                out[f"permute_{shift}"] = np.asarray(jax.jit(perm)(
                    x["ring"]))
            out[f"events_permute_{be}_{shift}"] = _events(events)
    put = shard_map(                                              # (b)
        lambda c: onesided_fetch_rows(c[0], "hosts", interpret=True)[None],
        mesh=mesh, in_specs=(P("hosts"),), out_specs=P("hosts"),
        check_vma=False)
    out["onesided_fetch_rows"] = np.asarray(jax.jit(put)(x["contribs"]))
    for be in BACKENDS:
        store = JRemoteStore(x["tables"], hosts=H, backend=be)    # (c)
        out[f"store_{be}"] = store.fetch(x["t_ids"], x["row_ids"])
        out["store_shards"] = np.asarray(store.shards)
        cfg = EmbeddingBagConfig(                                 # (d)
            num_tables=T, rows_per_table=R, dim=D, kernel_mode="reference",
            cache=JCacheConfig(rows=BAG["cache_rows"], cold_tier="remote",
                               remote_hosts=H, remote_backend=be))
        cache = make_cache(jnp.asarray(x["tables"]), cfg)
        for idx, lens in zip(x["bag_idx"], x["bag_lens"]):
            cache.lookup(JJagged(jnp.asarray(idx), jnp.asarray(lens)))
        out[f"stats_{be}"] = np.array([getattr(cache.stats, k)
                                       for k in STATS])
    base = jcfg_mod.smoke()                                       # (e)
    params = jax.tree_util.tree_map(
        np.asarray, jdlrm.init_params(jax.random.key(0), base))
    out["tables"] = params["tables"]
    for part in ("bottom", "top"):
        for i, layer in enumerate(params[part]):
            out[f"{part}_{i}_w"], out[f"{part}_{i}_b"] = layer["w"], layer["b"]
    eng = JEngine(params, dataclasses.replace(base, cache=JCacheConfig(
        rows=ENGINE_ROWS, cold_tier="remote", remote_hosts=H)),
        batch_size=ENGINE_BATCH)
    for i in range(ENGINE_REQS):
        eng.submit(JRequest(rid=i, dense=x["req_dense"][i],
                            indices=x["req_idx"][i],
                            lengths=x["req_lens"][i]))
    scores = eng.run_to_completion()
    out["engine_scores"] = np.array([scores[i] for i in range(ENGINE_REQS)])
    np.savez(outputs, **out)


def reference_outputs(tmp_path_factory):
    """(inputs, the JAX reference's outputs), computed once per test
    session: the subprocess runs once, under a file lock, in the session's
    temporary directory (the one the xdist workers share), and every
    module that asks later -- this one, ``test_torch_remote_ranks.py`` --
    reads its outputs."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    tmp = base / "remote_ref"
    tmp.mkdir(exist_ok=True)
    x = _inputs()
    with open(base / "remote_ref.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (tmp / "outputs.npz").exists():
            np.savez(tmp / "inputs.npz", **x)
            env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
                   "JAX_PLATFORMS": "cpu",
                   "XLA_FLAGS":
                       f"--xla_force_host_platform_device_count={H}"}
            proc = subprocess.run(
                [sys.executable, __file__, str(tmp / "inputs.npz"),
                 str(tmp / "partial.npz")], env=env, capture_output=True,
                text=True, timeout=180)
            assert proc.returncode == 0, proc.stderr[-4000:]
            os.replace(tmp / "partial.npz", tmp / "outputs.npz")
    return x, dict(np.load(tmp / "outputs.npz"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, the JAX reference's outputs)."""
    return reference_outputs(tmp_path_factory)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _cache_cfg(backend, **kw):
    return CacheConfig(cold_tier="remote", remote_hosts=H,
                       remote_backend=backend, **kw)


# ---------------------------------------------------------------------------
# (a) comm.fetch_rows, (b) the kernel's plain version, (c) RemoteStore.fetch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_fetch_rows_matches_jax(ref, backend):
    x, want = ref
    got = comm.fetch_rows(_t(x["shards"]), _t(x["addr"]), _t(x["owner"]),
                          backend=backend)
    np.testing.assert_array_equal(got.numpy(), want[f"fetch_{backend}"])
    np.testing.assert_array_equal(got.numpy(),
                                  x["shards"][x["owner"], x["addr"]])


def test_onesided_fetch_rows_ref_matches_jax(ref):
    """Every requester's rows, bitwise, though the non-owners' zeros carry
    both signs."""
    x, want = ref
    c = x["contribs"]
    zeros = c[c == 0]
    assert np.signbit(zeros).any() and not np.signbit(zeros).all()
    got = oa.onesided_fetch_rows_ref(_t(c))
    np.testing.assert_array_equal(got.numpy(), want["onesided_fetch_rows"])
    np.testing.assert_array_equal(np.signbit(got.numpy()),
                                  np.signbit(want["onesided_fetch_rows"]))
    assert torch.equal(oa.onesided_fetch_rows(_t(c)), got)


@pytest.mark.parametrize("backend", BACKENDS)
def test_remote_store_fetch_matches_jax_and_host_store(ref, backend):
    x, want = ref
    tables = _t(x["tables"])
    store = RemoteStore(tables, hosts=H, backend=backend, device="cpu")
    got = store.fetch(x["t_ids"], x["row_ids"])
    assert got.device.type == "cpu" and got.shape == (5, D)
    np.testing.assert_array_equal(got.numpy(), want[f"store_{backend}"])
    assert torch.equal(got, HostStore(tables).fetch(x["t_ids"],
                                                    x["row_ids"]))
    np.testing.assert_array_equal(store.owner_of(x["row_ids"]),
                                  [0, 1, 2, 3, 0])
    assert (store.hosts, store.home, store.rows_per_host) == (H, 0, R // H)


# ---------------------------------------------------------------------------
# (d) the cached bag and (e) the engine over the remote tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_cached_bag_remote_tier_matches_jax(ref, backend):
    """Bitwise the uncached lookup, batch by batch, and the reference's
    counters exactly."""
    x, want = ref
    cfg = teb.EmbeddingBagConfig(
        num_tables=T, rows_per_table=R, dim=D,
        cache=_cache_cfg(backend, rows=BAG["cache_rows"]))
    tables = _t(x["tables"])
    cache = teb.make_cache(tables, cfg, device="cpu")
    assert isinstance(cache.cold, RemoteStore)
    assert cache.cold.backend == backend
    for idx, lens in zip(x["bag_idx"], x["bag_lens"]):
        batch = JaggedBatch(_t(idx), _t(lens))
        assert torch.equal(teb.pooled_lookup_cached(cache, batch),
                           teb.pooled_lookup_local(tables, batch, cfg))
    s = cache.stats
    assert s.hits > 0 and s.misses_host > 0 and s.misses_remote > 0
    assert s.bytes_remote == s.fetch_remote * cache.row_bytes
    assert [getattr(s, k) for k in STATS] == \
        want[f"stats_{backend}"].tolist()


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_remote_tier_matches_jax(ref, backend):
    x, want = ref
    params = {"tables": want["tables"],
              **{part: [{"w": want[f"{part}_{i}_w"],
                         "b": want[f"{part}_{i}_b"]}
                        for i in range(len(getattr(
                            tcfg_mod.smoke(), f"{part}_mlp")))]
                 for part in ("bottom", "top")}}
    params = params_from_numpy(params, device="cpu")
    cfg = dataclasses.replace(tcfg_mod.smoke(), cache=_cache_cfg(
        backend, rows=ENGINE_ROWS))
    eng = DLRMEngine(params, cfg, ENGINE_BATCH, device="cpu")
    assert eng.params["tables"] is None      # only the pool and the shards
    assert isinstance(eng.cache.cold, RemoteStore)
    for i in range(ENGINE_REQS):
        eng.submit(CTRRequest(rid=i, dense=x["req_dense"][i],
                              indices=x["req_idx"][i],
                              lengths=x["req_lens"][i]))
    scores = eng.run_to_completion()
    got = np.array([scores[i] for i in range(ENGINE_REQS)])
    np.testing.assert_allclose(got, want["engine_scores"], rtol=0,
                               atol=PCTR_ATOL)
    s = eng.cache_stats()
    assert s.misses_remote > 0 and s.bytes_remote > 0


# ---------------------------------------------------------------------------
# (f)-(h) checks, instrumentation, devices; the port's own invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw, match", [
    (dict(hosts=1), ">= 2 hosts"),
    (dict(hosts=None), ">= 2 hosts"),          # the CPU is one host
    (dict(hosts=3), "divide evenly"),
    (dict(hosts=4, backend="nccl"), "unknown remote backend"),
])
def test_remote_store_rejects_bad_layouts(kw, match):
    with pytest.raises(ValueError, match=match):
        RemoteStore(torch.zeros((2, 64, 4)), device="cpu", **kw)


def test_fetch_rows_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown remote backend"):
        comm.fetch_rows(torch.zeros((H, 4, 2)), torch.zeros(3),
                        torch.zeros(3), backend="nvshmem")


@pytest.mark.parametrize("backend", BACKENDS)
def test_record_runtime_reaches_the_sink(backend):
    """One timed fetch_rows event per fetch, on the sink and in
    instrument(), with the padded stacked payload bytes."""
    store = RemoteStore(torch.randn((T, R, D)), hosts=H, backend=backend,
                        device="cpu")
    seen = []
    prev = comm.set_event_sink(seen.append)
    try:
        with comm.instrument() as events:
            store.fetch([0, 1, 1, 0, 1], [3, 17, 40, 63, 0])   # M=5 -> 8
    finally:
        assert comm.set_event_sink(prev) == seen.append
    assert seen == events and len(seen) == 1
    ev = seen[0]
    assert (ev.op, ev.axis_size, ev.backend) == ("fetch_rows", H, backend)
    assert ev.bytes_in == H * 8 * D * 4 and ev.t1 > ev.t0
    comm.record_runtime("fetch_rows", 1, H, backend, 0.0, 1.0)
    assert len(seen) == 1                 # no sink, no log: nothing recorded


def test_remote_store_default_device_needs_a_card():
    tables = torch.zeros((2, 64, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        RemoteStore(tables, hosts=H)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_cold_store(tables, _cache_cfg("onesided", rows=8))
    store = make_cold_store(tables, _cache_cfg("onesided", rows=8),
                            device="cpu")
    assert isinstance(store, RemoteStore) and store.backend == "onesided"
    assert store.shards.shape == (H, 2 * 64 // H, 4)


def test_put_rows_ref_is_the_transpose():
    """The exchange moves rank r's block for q to q's buffer at [r]: the
    library yardstick ``transpose(0, 1)``, bitwise, in both dtypes."""
    c = torch.randn((H, H, 5, 3))
    for dtype in (torch.float32, torch.bfloat16):
        cd = c.to(dtype)
        assert torch.equal(oa.onesided_put_rows_ref(cd),
                           cd.transpose(0, 1).contiguous())
        assert torch.equal(oa.onesided_fetch_rows(cd),
                           oa.onesided_put_rows_ref(cd).sum(dim=1))


def test_cpu_path_launches_nothing():
    oa.reset_launch_counts()
    store = RemoteStore(torch.randn((T, R, D)), hosts=H, backend="onesided",
                        device="cpu")
    store.fetch([0, 1], [5, 50])
    oa.onesided_put_rows(torch.randn((H, H, 2, D)))
    assert oa.LAUNCH_COUNTS["onesided_put_rows"] == 0
    assert set(oa.LAUNCH_COUNTS.values()) == {0}


def test_put_rows_refuses_other_devices():
    """No silent fallback: a tensor neither on the CPU nor on a card is
    refused, never sent to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        oa.onesided_put_rows(torch.empty((H, H, 2, D), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        oa.onesided_fetch_rows(torch.empty((H, H, 2, D), device="meta"))


def test_put_rows_build_needs_nvcc(monkeypatch, tmp_path):
    # the row puts are the chunk-put kernel's
    path = build.library_path("onesided_a2a")
    assert path.name.startswith("onesided_a2a-")
    assert path != build.library_path("tbe_gather_pool")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["onesided_a2a"])


@pytest.mark.parametrize("m, want", [(1, [0]), (5, [0, 1, 2, 3, 4, 4, 4, 4]),
                                     (8, list(range(8)))])
def test_pad_pow2_repeats_the_last_request(m, want):
    a = np.arange(m)
    b = np.arange(m) * 10
    pa, pb = _pad_pow2([a, b])
    assert pa.tolist() == want and pb.tolist() == [10 * v for v in want]


def test_remote_bag_churns_and_stays_exact():
    """A pool smaller than the traffic's footprint evicts rows back to the
    remote tier and re-fetches them, and the lookup stays bitwise the
    uncached one (tests/_tiering_checks.py, churn, on the port)."""
    cfg = teb.EmbeddingBagConfig(
        num_tables=T, rows_per_table=256, dim=D,
        cache=_cache_cfg("onesided", rows=16, policy="lru"))
    tables = torch.randn((T, 256, D))
    cache = CachedEmbeddingBag(tables, cfg, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(6):
        lo = 32 + 32 * i
        batch = JaggedBatch(
            _t(rng.integers(lo, lo + 32, (T, 4, 4)).astype(np.int32)),
            torch.full((T, 4), 4, dtype=torch.int32))
        assert torch.equal(cache.lookup(batch),
                           teb.pooled_lookup_local(tables, batch, cfg))
    s = cache.stats
    assert s.evictions > 0 and s.fetch_host > 0 and s.fetch_remote > 0


if __name__ == "__main__":
    _jax_reference(Path(sys.argv[1]), Path(sys.argv[2]))
