"""The port's embedding-bag ops and TBE kernel wrappers against the JAX
reference, on the CPU (where every wrapper takes its plain version).

The same numpy inputs go through ``repro.kernels`` -- in Pallas interpret
mode and through its plain reference, as ``tests/test_tbe.py`` runs it --
and through ``repro_torch.kernels``.

Tolerances: fp32 pooling against the JAX einsum (``Precision.HIGHEST``, a
different summation order) agrees to ``rtol=1e-5, atol=1e-6``; bf16 outputs
are both rounded from f32 sums that may differ in the last f32 bits, so
they can land one bf16 ulp apart (``2**-8`` relative): ``2e-2``, as in
``tests/test_kernels.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding_bag as jeb
from repro.core.jagged import JaggedBatch as JJagged
from repro.kernels import embedding_gather as jgather
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import embedding_bag as teb
from repro_torch.core.jagged import JaggedBatch
from repro_torch.kernels import build, embedding_gather as tgather
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
JAX_MODES = ["interpret", "reference"]


def _mk(T, R=64, D=32, B=6, L=5, seed=0, weighted=False):
    """numpy (tables, idx, lens, w), as tests/test_tbe.py draws them."""
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((T, R, D)).astype(np.float32)
    idx = rng.integers(0, R, (T, B, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, (T, B)).astype(np.int32)
    w = (rng.standard_normal((T, B, L)).astype(np.float32)
         if weighted else None)
    return tables, idx, lens, w


def _j(a, dtype=None):
    return None if a is None else jnp.asarray(a, dtype)


def _t(a, dtype=None):
    return None if a is None else torch.as_tensor(a).to(
        dtype or torch.as_tensor(a).dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Table-batched (the cases of tests/test_tbe.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_mode", JAX_MODES)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("T", [1, 4, 16])
def test_tbe_matches_jax(T, weighted, jax_mode):
    tables, idx, lens, w = _mk(T, weighted=weighted)
    want = jops.embedding_bag_batched(_j(tables), _j(idx), _j(lens), _j(w),
                                      mode=jax_mode)
    got = tops.embedding_bag_batched(_t(tables), _t(idx), _t(lens), _t(w))
    assert got.shape == (T, 6, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("T", [1, 4])
def test_tbe_unfused_matches_fused(T):
    tables, idx, lens, _ = _mk(T, seed=T)
    want = jops.embedding_bag_batched(_j(tables), _j(idx), _j(lens),
                                      mode="interpret", fused=False)
    fused = tops.embedding_bag_batched(_t(tables), _t(idx), _t(lens))
    unfused = tops.embedding_bag_batched(_t(tables), _t(idx), _t(lens),
                                         fused=False)
    np.testing.assert_allclose(_np(unfused), _np(fused), **F32)
    np.testing.assert_allclose(_np(unfused), _np(want), **F32)


@pytest.mark.parametrize("jax_mode", JAX_MODES)
def test_tbe_mean_combiner(jax_mode):
    tables, idx, lens, w = _mk(4, weighted=True, seed=3)
    w = np.abs(w) + 0.1          # mean needs positive weights
    want = jops.embedding_bag_batched(_j(tables), _j(idx), _j(lens), _j(w),
                                      combiner="mean", mode=jax_mode)
    got = tops.embedding_bag_batched(_t(tables), _t(idx), _t(lens), _t(w),
                                     combiner="mean")
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("T", [1, 4, 16])
def test_tbe_rw_premasked_shards_reconstruct(T):
    """Per-shard partial pools match the reference's and sum to the full
    pool."""
    R, E = 64, 4
    tables, idx, lens, _ = _mk(T, R=R, seed=T + 10)
    full = tops.embedding_bag_batched(_t(tables), _t(idx), _t(lens))
    Rs = R // E
    acc = torch.zeros_like(full)
    for e in range(E):
        shard = tables[:, e * Rs:(e + 1) * Rs]
        part = tops.embedding_bag_rw_partial_batched(
            _t(shard), e * Rs, _t(idx), _t(lens))
        for mode in JAX_MODES:
            want = jops.embedding_bag_rw_partial_batched(
                _j(shard), e * Rs, _j(idx), _j(lens), mode=mode)
            np.testing.assert_allclose(_np(part), _np(want), **F32)
        unfused = tops.embedding_bag_rw_partial_batched(
            _t(shard), e * Rs, _t(idx), _t(lens), fused=False)
        np.testing.assert_allclose(_np(unfused), _np(part), **F32)
        # the shard as a strided view of the stacked tables, read in place
        view = _t(tables)[:, e * Rs:(e + 1) * Rs]
        assert not view.is_contiguous() or E == 1 or T == 1
        assert torch.equal(tops.embedding_bag_rw_partial_batched(
            view, e * Rs, _t(idx), _t(lens)), part)
        acc = acc + part
    np.testing.assert_allclose(_np(acc), _np(full), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_pooled_lookup_local_fused_switch(fused):
    """cfg.fused toggles the kernel layout, not the numbers."""
    rng = np.random.default_rng(5)
    tables = rng.standard_normal((4, 64, 32)).astype(np.float32)
    idx = rng.integers(0, 64, (4, 6, 5)).astype(np.int32)
    lens = rng.integers(0, 6, (4, 6)).astype(np.int32)
    jcfg = jeb.EmbeddingBagConfig(num_tables=4, rows_per_table=64, dim=32,
                                  kernel_mode="interpret", fused=fused)
    want = jeb.pooled_lookup_local(_j(tables), JJagged(_j(idx), _j(lens)),
                                   jcfg)
    tcfg = teb.EmbeddingBagConfig(num_tables=4, rows_per_table=64, dim=32,
                                  fused=fused)
    got = teb.pooled_lookup_local(_t(tables), JaggedBatch(_t(idx), _t(lens)),
                                  tcfg)
    assert tuple(got.shape) == want.shape == (6, 4, 32)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("R,D,B,L", [(100, 96, 5, 3), (64, 128, 4, 1),
                                     (50, 10, 7, 6)])
def test_tbe_nonaligned_dim_and_L1(R, D, B, L):
    """Non-128-multiple D (96, the vector path on the card; 10, its scalar
    path) and the L=1 degenerate."""
    tables, idx, lens, _ = _mk(3, R=R, D=D, B=B, L=L, seed=R)
    want = jops.embedding_bag_batched(_j(tables), _j(idx), _j(lens),
                                      mode="interpret")
    got = tops.embedding_bag_batched(_t(tables), _t(idx), _t(lens))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("jax_mode", JAX_MODES)
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_flat_ragged_offsets(combiner, jax_mode):
    """The slot-pool layout: ragged per-table row counts in one flat
    (N, D) row space, described only by the (T,) offsets."""
    rng = np.random.default_rng(21)
    rows = np.array([7, 30, 1, 12])
    off = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int32)
    flat = rng.standard_normal((int(rows.sum()), 16)).astype(np.float32)
    T, B, L = 4, 5, 6
    idx = (rng.random((T, B, L)) * rows[:, None, None]).astype(np.int32)
    lens = rng.integers(0, L + 1, (T, B)).astype(np.int32)
    w = rng.random((T, B, L)).astype(np.float32) + 0.1
    want = jops.embedding_bag_batched_flat(
        _j(flat), _j(off), _j(idx), _j(lens), _j(w), combiner=combiner,
        mode=jax_mode)
    got = tops.embedding_bag_batched_flat(
        _t(flat), _t(off), _t(idx), _t(lens), _t(w), combiner=combiner)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tbe_table_dtypes(dtype):
    tables, idx, lens, w = _mk(4, weighted=True, seed=31)
    want = jops.embedding_bag_batched(
        _j(tables, jnp.dtype(dtype)), _j(idx), _j(lens), _j(w),
        mode="interpret")
    got = tops.embedding_bag_batched(
        _t(tables, getattr(torch, dtype)), _t(idx), _t(lens), _t(w))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


def test_padding_ids_beyond_lengths_are_ignored():
    """Slots beyond ``lengths`` may hold -1 or any junk id (requests pad
    with sentinels): the ops mask them before the gather."""
    tables, idx, lens, w = _mk(4, weighted=True, seed=41)
    L = idx.shape[-1]
    pad = np.arange(L) >= lens[..., None]
    clean = np.where(pad, 0, idx)
    junk = np.where(pad, np.int32(-1), idx)
    junk[..., -1] = np.where(pad[..., -1], np.int32(10**6), junk[..., -1])
    want = jops.embedding_bag_batched(_j(tables), _j(clean), _j(lens),
                                      _j(w), mode="reference")
    for fused in (True, False):
        got = tops.embedding_bag_batched(_t(tables), _t(junk), _t(lens),
                                         _t(w), fused=fused)
        base = tops.embedding_bag_batched(_t(tables), _t(clean), _t(lens),
                                          _t(w), fused=fused)
        assert torch.equal(got, base)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    flat_got = tops.embedding_bag_batched_flat(
        _t(tables.reshape(-1, 32)), torch.arange(4, dtype=torch.int32) * 64,
        _t(junk), _t(lens), _t(w))
    np.testing.assert_allclose(_np(flat_got), _np(want), **F32)


# ---------------------------------------------------------------------------
# Single table (the embedding-bag cases of tests/test_kernels.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,D,B,L", [(32, 16, 8, 4), (64, 128, 4, 1),
                                     (128, 256, 16, 8), (100, 96, 5, 3),
                                     (40, 10, 6, 5)])
def test_gather_pool_sweep(R, D, B, L, dtype):
    rng = np.random.default_rng(R + D)
    table = rng.standard_normal((R, D)).astype(np.float32)
    idx = rng.integers(0, R, (B, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, (B,)).astype(np.int32)
    want = jops.embedding_bag(_j(table, jnp.dtype(dtype)), _j(idx), _j(lens),
                              mode="interpret")
    got = tops.embedding_bag(_t(table, getattr(torch, dtype)), _t(idx),
                             _t(lens))
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))
    # all-padding rows pool to exactly zero
    assert np.all(_np(got)[lens == 0] == 0.0)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_gather_pool_weighted_and_mean(combiner):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((40, 32)).astype(np.float32)
    idx = rng.integers(0, 40, (6, 5)).astype(np.int32)
    lens = rng.integers(1, 6, (6,)).astype(np.int32)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    for mode in JAX_MODES:
        want = jops.embedding_bag(_j(table), _j(idx), _j(lens), _j(w),
                                  combiner=combiner, mode=mode)
        got = tops.embedding_bag(_t(table), _t(idx), _t(lens), _t(w),
                                 combiner=combiner)
        np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_rw_partial_masking():
    """Out-of-shard ids contribute zero; shards sum to the full pool."""
    rng = np.random.default_rng(1)
    R, D, B, L, E = 64, 16, 8, 4, 4
    table = rng.standard_normal((R, D)).astype(np.float32)
    idx = rng.integers(0, R, (B, L)).astype(np.int32)
    full = tops.embedding_bag(_t(table), _t(idx))
    acc = torch.zeros_like(full)
    for e in range(E):
        shard = table[e * (R // E):(e + 1) * (R // E)]
        part = tops.embedding_bag_rw_partial(_t(shard), e * (R // E), _t(idx))
        for mode in JAX_MODES:
            want = jops.embedding_bag_rw_partial(_j(shard), e * (R // E),
                                                 _j(idx), mode=mode)
            np.testing.assert_allclose(_np(part), _np(want), **F32)
        np.testing.assert_allclose(
            _np(part), _np(tref.embedding_bag_masked_ref(
                _t(shard), e * (R // E), _t(idx))), **F32)
        acc = acc + part
    np.testing.assert_allclose(_np(acc), _np(full), rtol=1e-5, atol=1e-5)


def test_onehot_formulation_matches():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((16, 8)).astype(np.float32)
    idx = rng.integers(0, 16, (5, 3)).astype(np.int32)
    lens = rng.integers(0, 4, (5,)).astype(np.int32)
    a = tref.embedding_bag_ref(_t(table), _t(idx), _t(lens))
    b = tref.embedding_onehot_ref(_t(table), _t(idx), _t(lens))
    want = jref.embedding_onehot_ref(_j(table), _j(idx), _j(lens))
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)
    np.testing.assert_allclose(_np(b), _np(want), atol=1e-5)


# ---------------------------------------------------------------------------
# The kernel wrappers themselves, against the Pallas kernels they replace
# ---------------------------------------------------------------------------

def test_wrappers_match_pallas_kernels():
    tables, idx, lens, w = _mk(4, R=40, D=24, B=5, L=6, seed=51,
                               weighted=True)
    eff = (np.arange(6) < lens[..., None]) * w
    flat = tables.reshape(-1, 24)
    off = (np.arange(4) * 40).astype(np.int32)
    pairs = [
        (tgather.gather_pool_tbe_flat(_t(flat), _t(off), _t(idx), _t(eff)),
         jgather.gather_pool_tbe_flat_pallas(_j(flat), _j(off), _j(idx),
                                             _j(eff), interpret=True)),
        (tgather.gather_pool_tbe(_t(tables), _t(idx), _t(eff)),
         jgather.gather_pool_tbe_pallas(_j(tables), _j(idx), _j(eff),
                                        interpret=True)),
        (tgather.gather_pool(_t(tables[2]), _t(idx[2]), _t(eff[2])),
         jgather.gather_pool_pallas(_j(tables[2]), _j(idx[2]), _j(eff[2]),
                                    interpret=True)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_stacked_and_flat_pool_same_rows_bitwise():
    """The stacked wrapper and the flat wrapper over a compact copy of the
    referenced rows (a slot pool) pool bitwise-equal: one pooling program."""
    tables, idx, lens, w = _mk(3, R=50, D=8, B=4, L=5, seed=61,
                               weighted=True)
    eff = ((np.arange(5) < lens[..., None]) * w).astype(np.float32)
    rows, slot_idx, off = [], np.zeros_like(idx), [0]
    for t in range(3):
        uniq, inv = np.unique(idx[t], return_inverse=True)
        rows.append(tables[t, uniq])
        slot_idx[t] = inv.reshape(idx[t].shape)
        off.append(off[-1] + uniq.size)
    pool = np.concatenate(rows)
    stacked = tgather.gather_pool_tbe(_t(tables), _t(idx), _t(eff))
    pooled = tgather.gather_pool_tbe_flat(
        _t(pool), torch.tensor(off[:-1], dtype=torch.int32), _t(slot_idx),
        _t(eff))
    assert torch.equal(stacked, pooled)


def test_cpu_path_launches_nothing():
    """CPU tensors take the plain version: no kernel, no launch count."""
    tgather.reset_launch_counts()
    tables, idx, lens, _ = _mk(4)
    tops.embedding_bag_batched(_t(tables), _t(idx), _t(lens))
    tops.embedding_bag_batched(_t(tables), _t(idx), _t(lens), fused=False)
    assert set(tgather.LAUNCH_COUNTS.values()) == {0}


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor neither on the CPU nor on a card is
    refused, never sent to the plain version."""
    meta = dict(device="meta")
    flat = torch.empty((10, 4), **meta)
    idx = torch.empty((2, 3, 5), dtype=torch.int32, **meta)
    w = torch.empty((2, 3, 5), **meta)
    off = torch.empty((2,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        tgather.gather_pool_tbe_flat(flat, off, idx, w)
    with pytest.raises(ValueError, match="CUDA"):
        tgather.gather_pool_tbe(flat.view(2, 5, 4), idx, w)
    with pytest.raises(ValueError, match="CUDA"):
        tgather.gather_pool(flat, idx[0], w[0])


def test_unknown_combiner_rejected():
    tables, idx, lens, _ = _mk(2)
    with pytest.raises(ValueError, match="combiner"):
        tops.embedding_bag_batched(_t(tables), _t(idx), _t(lens),
                                   combiner="max")


def test_build_is_keyed_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    """The library name carries the source's hash; without nvcc the build
    raises instead of falling back."""
    path = build.library_path("tbe_gather_pool")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("tbe_gather_pool-") and path.suffix == ".so"
    assert build.library_path("tbe_gather_pool") == path
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["tbe_gather_pool"])


def test_config_dataclass_fields_mirror_reference():
    """The port's EmbeddingBagConfig keeps the reference's local-path
    fields with the same defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(
        jeb.EmbeddingBagConfig)}
    for f in dataclasses.fields(teb.EmbeddingBagConfig):
        if f.name != "cache":
            assert f.name in jf and jf[f.name] == f.default, f.name
