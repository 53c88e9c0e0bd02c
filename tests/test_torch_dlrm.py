"""The port's DLRM model, configs, jagged batches and data against the JAX
reference on the CPU.

Logits after the MLPs agree to ``rtol=1e-4, atol=1e-5``: the pooled
vectors already differ in summation order (see test_torch_kernels) and the
MLP products add their own.  Interaction features: ``rtol=1e-5,
atol=1e-5``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm as jcfg_mod
from repro.core import jagged as jjagged
from repro.core.cache_config import CacheConfig as JCacheConfig
from repro.data.synthetic import dlrm_batches as jax_dlrm_batches
from repro.models import dlrm as jdlrm
from repro_torch.configs import dlrm as tcfg_mod
from repro_torch.core import jagged as tjagged
from repro_torch.core.cache_config import CacheConfig
from repro_torch.data.synthetic import dlrm_batches
from repro_torch.models import dlrm as tdlrm
from repro_torch.utils.convert import batch_from_numpy, params_from_numpy

LOGITS = dict(rtol=1e-4, atol=1e-5)


def _jax_cfg(mode="reference"):
    return dataclasses.replace(jcfg_mod.smoke(), kernel_mode=mode)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("n", [2, 5, 9, 27])
def test_triu_pair_order_matches_jax(n):
    iu, ju = torch.triu_indices(n, n, 1)
    jiu, jju = jnp.triu_indices(n, k=1)
    np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
    np.testing.assert_array_equal(ju.numpy(), np.asarray(jju))


def test_dot_interaction_matches_jax():
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((5, 16)).astype(np.float32)
    pooled = rng.standard_normal((5, 8, 16)).astype(np.float32)
    want = jdlrm.dot_interaction(jnp.asarray(dense), jnp.asarray(pooled))
    got = tdlrm.dot_interaction(torch.as_tensor(dense),
                                torch.as_tensor(pooled))
    assert tuple(got.shape) == want.shape == (5, 16 + 9 * 8 // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("jax_mode", ["interpret", "reference"])
@pytest.mark.parametrize("fixed_pooling", [True, False])
def test_forward_matches_jax(jax_mode, fixed_pooling):
    jcfg = _jax_cfg(jax_mode)
    jparams = jdlrm.init_params(jax.random.key(3), jcfg)
    data = next(jax_dlrm_batches(jcfg, 6, seed=4, zipf_a=1.2,
                                 fixed_pooling=fixed_pooling))
    want = jdlrm.forward(jparams, jnp.asarray(data["dense"]), data["batch"],
                         jcfg)
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    dense, batch = batch_from_numpy(
        data["dense"], np.asarray(data["batch"].indices),
        np.asarray(data["batch"].lengths), device="cpu")
    got = tdlrm.forward(params, dense, batch, tcfg_mod.smoke())
    assert tuple(got.shape) == want.shape == (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_bce_loss_matches_jax():
    jcfg = _jax_cfg()
    jparams = jdlrm.init_params(jax.random.key(5), jcfg)
    data = next(jax_dlrm_batches(jcfg, 8, seed=6))
    want = jdlrm.bce_loss(jparams, jnp.asarray(data["dense"]), data["batch"],
                          jnp.asarray(data["labels"]), jcfg)
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    dense, batch = batch_from_numpy(
        data["dense"], np.asarray(data["batch"].indices),
        np.asarray(data["batch"].lengths), device="cpu")
    got = tdlrm.bce_loss(params, dense, batch,
                         torch.as_tensor(data["labels"]), tcfg_mod.smoke())
    np.testing.assert_allclose(float(got), float(want), **LOGITS)


def test_init_params_shapes_and_determinism():
    cfg = tcfg_mod.smoke()
    jparams = jdlrm.init_params(jax.random.key(0), _jax_cfg())
    a = tdlrm.init_params(torch.Generator().manual_seed(7), cfg,
                          device="cpu")
    b = tdlrm.init_params(torch.Generator().manual_seed(7), cfg,
                          device="cpu")
    jshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jparams)
    tshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), a)
    assert jshapes == tshapes
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)
    # truncated normal in [-2, 2] scaled by fan_in ** -0.5, zero biases
    w0 = a["bottom"][0]["w"]
    assert float(w0.abs().max()) <= 2 * cfg.num_dense_features ** -0.5
    assert float(a["top"][-1]["b"].abs().max()) == 0.0


def test_params_from_numpy_copies_each_dtype():
    """f32 and bf16 (ml_dtypes) arrays carry across value for value."""
    w = np.random.default_rng(8).standard_normal((3, 2)).astype(np.float32)
    layer = {"w": w, "b": np.zeros(2, np.float32)}
    for arr, dtype in ((w, torch.float32),
                       (np.asarray(jnp.asarray(w, jnp.bfloat16)),
                        torch.bfloat16)):
        p = params_from_numpy({"tables": arr[None], "bottom": [layer],
                               "top": [layer]}, device="cpu")
        assert p["tables"].dtype == dtype and p["tables"].shape == (1, 3, 2)
        np.testing.assert_array_equal(p["tables"][0].float().numpy(),
                                      np.asarray(arr, np.float32))
        assert torch.equal(p["bottom"][0]["w"], torch.as_tensor(w))


def test_entry_points_default_to_the_card():
    """device=None means CUDA: on a machine without a card it raises."""
    cfg = tcfg_mod.smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        tdlrm.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(dlrm_batches(cfg, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"tables": np.zeros((1, 1, 1)), "bottom": [],
                           "top": []})


@pytest.mark.parametrize("zipf_a", [None, 0.9, 1.2])
def test_dlrm_batches_match_jax(zipf_a):
    jcfg, tcfg = _jax_cfg(), tcfg_mod.smoke()
    jit_ = jax_dlrm_batches(jcfg, 5, seed=2, start_step=3, zipf_a=zipf_a,
                            fixed_pooling=False)
    tit = dlrm_batches(tcfg, 5, seed=2, start_step=3, zipf_a=zipf_a,
                       fixed_pooling=False, device="cpu")
    for _ in range(2):
        a, b = next(jit_), next(tit)
        np.testing.assert_array_equal(b["dense"].numpy(), a["dense"])
        np.testing.assert_array_equal(b["labels"].numpy(), a["labels"])
        np.testing.assert_array_equal(b["batch"].indices.numpy(),
                                      np.asarray(a["batch"].indices))
        np.testing.assert_array_equal(b["batch"].lengths.numpy(),
                                      np.asarray(a["batch"].lengths))


def test_jagged_helpers_match_jax():
    rng = np.random.default_rng(1)
    lengths = rng.integers(0, 5, 7)
    flat = rng.integers(0, 100, int(lengths.sum()))
    for mp in (None, 6):
        a = jjagged.csr_to_padded(flat, lengths, mp)
        b = tjagged.csr_to_padded(flat, lengths, mp)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        back = tjagged.padded_to_csr(*b)
        np.testing.assert_array_equal(back[0], flat)
    for a_ in (0.8, 1.0, 1.3):
        np.testing.assert_array_equal(
            tjagged.zipf_ranks(np.random.default_rng(2), a_, 50, (4, 6)),
            jjagged.zipf_ranks(np.random.default_rng(2), a_, 50, (4, 6)))
    jb = jjagged.random_jagged_batch(np.random.default_rng(3), 3, 4, 5, 20,
                                     fixed_pooling=False)
    w = np.random.default_rng(4).standard_normal((3, 4, 5)).astype(
        np.float32)
    tb = tjagged.JaggedBatch(torch.tensor(np.asarray(jb.indices)),
                             torch.tensor(np.asarray(jb.lengths)),
                             torch.as_tensor(w))
    jb = jjagged.JaggedBatch(jb.indices, jb.lengths, jnp.asarray(w))
    np.testing.assert_array_equal(tb.mask().numpy(), np.asarray(jb.mask()))
    np.testing.assert_array_equal(tb.effective_weights().numpy(),
                                  np.asarray(jb.effective_weights()))
    assert (tb.num_tables, tb.batch_size, tb.max_pooling) == (3, 4, 5)


def test_configs_mirror_reference():
    for jc, tc in [(jcfg_mod.CONFIG, tcfg_mod.CONFIG),
                   (jcfg_mod.smoke(), tcfg_mod.smoke())]:
        for f in dataclasses.fields(tc):
            if f.name != "cache":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.interaction_dim == jc.interaction_dim
        je, te = jc.embedding_config(), tc.embedding_config()
        assert (te.num_tables, te.rows_per_table, te.dim, te.fused) == \
            (je.num_tables, je.rows_per_table, je.dim, je.fused)
        assert te.table_bytes == je.table_bytes
    assert tcfg_mod.CONFIG.interaction_dim == 479
    with pytest.raises(ValueError, match="bottom_mlp"):
        tcfg_mod.DLRMConfig(bottom_mlp=(64, 32))


@pytest.mark.parametrize("kw", [dict(rows=5), dict(rows_per_table=[3, 9, 4]),
                                dict(rows=500)])
def test_cache_slot_geometry_matches_jax(kw):
    a, b = JCacheConfig(**kw), CacheConfig(**kw)
    assert a.enabled == b.enabled
    np.testing.assert_array_equal(a.slots_per_table(3, 100),
                                  b.slots_per_table(3, 100))
    np.testing.assert_array_equal(a.slot_offsets(3, 100),
                                  b.slot_offsets(3, 100))
    assert not CacheConfig().enabled
    with pytest.raises(ValueError):
        CacheConfig(rows=-1)
    with pytest.raises(ValueError):
        CacheConfig(pipeline_depth=0)
