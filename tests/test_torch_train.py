"""DLRM training in the port against the JAX reference, on the CPU.

* The gradients of ``sum(out**2)`` with respect to the tables and the
  weights through every public op (``embedding_bag``,
  ``embedding_bag_batched`` fused and unfused, ``embedding_bag_batched_flat``;
  combiners sum and mean; ids padded with -1 past ``lengths``) against
  ``jax.grad`` of the reference ops at ``mode="interpret"``, which runs
  the reference's ``custom_vjp``s: ``rtol=1e-5, atol=1e-5`` (two f32
  summation orders of a few terms; the reference's own gradient tests
  hold 1e-4).
* Row-wise Adagrad against the reference's: ``rtol=1e-6, atol=1e-7``
  (the same f32 arithmetic; ``sqrt`` and division may round apart by an
  ulp), rows with a zero gradient bitwise unchanged.
* The 20-step flow of ``tests/test_dlrm.py::test_training_reduces_bce``
  (row-wise Adagrad on the tables, SGD on the MLPs, lr 0.05) through both
  packages from one numpy batch and converted params: the loss at every
  step within ``rtol=1e-4, atol=1e-6`` and the final params within
  ``rtol=1e-4, atol=1e-5`` (the pooled vectors' and the MLP products'
  f32 orders, carried through 20 updates); the port's last loss under
  its first.
* Serving is untouched: with nothing requiring grad each op returns the
  wrapper's output bitwise, after the same wrapper calls.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm as jcfg_mod
from repro.core.jagged import JaggedBatch as JJagged
from repro.core.jagged import zipf_ranks
from repro.kernels import ops as jops
from repro.models import dlrm as jdlrm
from repro.optim import rowwise_adagrad_init as j_init
from repro.optim import rowwise_adagrad_update as j_update
from repro_torch.configs import dlrm as tcfg_mod
from repro_torch.kernels import embedding_gather as tgather
from repro_torch.kernels import ops as tops
from repro_torch.models import dlrm as tdlrm
from repro_torch.optim import rowwise_adagrad_init, rowwise_adagrad_update
from repro_torch.utils.convert import batch_from_numpy, params_from_numpy

GRAD = dict(rtol=1e-5, atol=1e-5)
ADAGRAD = dict(rtol=1e-6, atol=1e-7)
LOSS = dict(rtol=1e-4, atol=1e-6)
PARAMS = dict(rtol=1e-4, atol=1e-5)


def _batch(rng, lead, R, L):
    """Ids in [0, R), lengths in [0, L], -1 past each length."""
    idx = rng.integers(0, R, lead + (L,)).astype(np.int32)
    lens = rng.integers(0, L + 1, lead).astype(np.int32)
    idx[np.arange(L) >= lens[..., None]] = -1
    return idx, lens


def _inputs(seed, T, R=32, D=16, B=5, L=4):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((T, R, D)).astype(np.float32)
    idx, lens = _batch(rng, (T, B), R, L)
    w = rng.standard_normal((T, B, L)).astype(np.float32)
    return tables, idx, lens, w


def _ragged(tables, idx, lens, seed):
    """The same lookups over a flat ragged row space: table t keeps its
    first ``rows[t]`` rows (ids folded into them) at ``off[t]``."""
    T, R, D = tables.shape
    rows = np.random.default_rng(seed).integers(R // 2, R + 1, T)
    off = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int32)
    flat = np.concatenate([tables[t, :rows[t]] for t in range(T)])
    idx = np.where(idx >= 0, idx % rows[:, None, None], -1).astype(np.int32)
    return flat, off, idx


def _torch_grads(op, table, w, *rest, **kw):
    t = torch.tensor(table, requires_grad=True)
    ww = torch.tensor(w, requires_grad=True)
    out = op(t, *[torch.as_tensor(a) for a in rest[:-1]],
             torch.as_tensor(rest[-1]), ww, **kw)
    return [g.numpy() for g in torch.autograd.grad((out ** 2).sum(),
                                                   (t, ww))]


def _jax_grads(op, table, w, *rest, **kw):
    def f(t, ww):
        return jnp.sum(op(t, *[jnp.asarray(a) for a in rest], ww,
                          mode="interpret", **kw) ** 2)
    return [np.asarray(g) for g in
            jax.grad(f, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(w))]


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_grads_match_reference(combiner):
    tables, idx, lens, w = _inputs(1, 1)
    args = (tables[0], w[0], idx[0], lens[0])
    _close(_torch_grads(tops.embedding_bag, *args, combiner=combiner),
           _jax_grads(jops.embedding_bag, *args, combiner=combiner), GRAD)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("T", [1, 3])
def test_embedding_bag_batched_grads_match_reference(T, combiner, fused):
    tables, idx, lens, w = _inputs(10 + T, T)
    args = (tables, w, idx, lens)
    _close(_torch_grads(tops.embedding_bag_batched, *args,
                        combiner=combiner, fused=fused),
           _jax_grads(jops.embedding_bag_batched, *args, combiner=combiner,
                      fused=fused), GRAD)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_batched_flat_grads_match_reference(combiner):
    tables, idx, lens, w = _inputs(21, 3)
    flat, off, ridx = _ragged(tables, idx, lens, 22)

    def t_op(p, o, i, ln, ww, **kw):
        return tops.embedding_bag_batched_flat(p, o, i, ln, ww, **kw)

    def j_op(p, o, i, ln, ww, **kw):
        return jops.embedding_bag_batched_flat(p, o, i, ln, ww, **kw)

    _close(_torch_grads(t_op, flat, w, off, ridx, lens, combiner=combiner),
           _jax_grads(j_op, flat, w, off, ridx, lens, combiner=combiner),
           GRAD)


def test_grads_of_the_three_paths_agree():
    """Fused, unfused and flat over the same rows: one gradient."""
    tables, idx, lens, w = _inputs(31, 4)
    T, R, D = tables.shape
    fused = _torch_grads(tops.embedding_bag_batched, tables, w, idx, lens)
    unfused = _torch_grads(tops.embedding_bag_batched, tables, w, idx, lens,
                           fused=False)
    flat = _torch_grads(
        lambda p, o, i, ln, ww: tops.embedding_bag_batched_flat(p, o, i, ln,
                                                                ww),
        tables.reshape(T * R, D), w, np.arange(T, dtype=np.int32) * R, idx,
        lens)
    _close(unfused, fused, GRAD)
    _close([flat[0].reshape(T, R, D), flat[1]], fused, GRAD)


def test_untouched_rows_get_exactly_zero_gradient():
    """Rows no live (table, id) pair names get +0.0 exactly; masked slots
    (id 0 at weight 0 in the port) add only +-0.0 to row 0."""
    tables, idx, lens, w = _inputs(41, 3, R=64)
    d_tables, _ = _torch_grads(tops.embedding_bag_batched, tables, w, idx,
                               lens)
    live = np.zeros(tables.shape[:2], bool)
    t, b, l = np.nonzero(np.arange(idx.shape[-1]) < lens[..., None])
    live[t, idx[t, b, l]] = True
    assert np.all(d_tables[~live] == 0.0)
    assert np.all(np.abs(d_tables[live]).sum(-1) > 0)


def test_weights_grad_only_when_asked():
    """Without ``requires_grad`` on the weights the backward computes no
    weight gradient (the (T, B, L, D) gather it would cost)."""
    tables, idx, lens, w = _inputs(51, 2)
    t = torch.tensor(tables, requires_grad=True)
    out = tops.embedding_bag_batched(t, torch.as_tensor(idx),
                                     torch.as_tensor(lens),
                                     torch.as_tensor(w))
    calls = []
    orig = tops._weights_grad
    tops._weights_grad = lambda *a: calls.append(1) or orig(*a)
    try:
        (g,) = torch.autograd.grad((out ** 2).sum(), (t,))
    finally:
        tops._weights_grad = orig
    assert calls == [] and g.shape == t.shape


@pytest.mark.parametrize("fused", [True, False])
def test_serving_output_is_the_wrappers_bitwise(fused):
    """With nothing requiring grad, the op's output is the wrapper's,
    bitwise, after the same wrapper calls; with the tables requiring grad
    the forward is bitwise the same."""
    tables, idx, lens, w = _inputs(61, 3)
    t, i, ln, ww = (torch.as_tensor(a) for a in (tables, idx, lens, w))
    eff = tops._effective_weights(i, ln, ww)
    safe = tops._safe_ids(i, ln)
    want = (tgather.gather_pool_tbe(t, safe, eff) if fused else
            torch.stack([tgather.gather_pool(t[k], safe[k], eff[k])
                         for k in range(3)]))
    tgather.reset_call_counts()
    with torch.no_grad():
        got = tops.embedding_bag_batched(t, i, ln, ww, fused=fused)
    calls = dict(tgather.CALL_COUNTS)
    assert torch.equal(got, want)
    assert calls == ({"gather_pool": 0, "gather_pool_tbe": 1,
                      "gather_pool_tbe_flat": 0} if fused else
                     {"gather_pool": 3, "gather_pool_tbe": 0,
                      "gather_pool_tbe_flat": 0})
    tgather.reset_call_counts()
    trained = tops.embedding_bag_batched(t.clone().requires_grad_(), i, ln,
                                         ww, fused=fused)
    assert trained.requires_grad and torch.equal(trained.detach(), want)
    assert dict(tgather.CALL_COUNTS) == calls
    flat = tops.embedding_bag_batched_flat(
        t.reshape(-1, t.shape[-1]), torch.arange(3, dtype=torch.int32)
        * t.shape[1], i, ln, ww)
    assert torch.equal(flat, tgather.gather_pool_tbe_flat(
        t.reshape(-1, t.shape[-1]), torch.arange(3, dtype=torch.int32)
        * t.shape[1], safe, eff))
    single = tops.embedding_bag(t[1], i[1], ln[1], ww[1])
    assert torch.equal(single, tgather.gather_pool(t[1], safe[1], eff[1]))


# ---------------------------------------------------------------------------
# Row-wise Adagrad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rowwise_adagrad_matches_reference(dtype):
    rng = np.random.default_rng(7)
    T, R, D = 3, 16, 8
    tables = rng.standard_normal((T, R, D)).astype(np.float32)
    grads = rng.standard_normal((T, R, D)).astype(np.float32)
    zero = rng.random((T, R)) < 0.4
    grads[zero] = 0.0
    accum = np.abs(rng.standard_normal((T, R))).astype(np.float32)
    accum[zero[:, ::-1]] = 0.0              # some untouched rows start at 0
    jt = jnp.asarray(tables, jnp.dtype(dtype))
    tt = torch.as_tensor(tables).to(getattr(torch, dtype))
    assert torch.equal(rowwise_adagrad_init(tt),
                       torch.tensor(np.asarray(j_init(jt))))
    want_t, want_a = j_update(jt, jnp.asarray(accum), jnp.asarray(grads),
                              lr=0.05)
    got_t, got_a = rowwise_adagrad_update(tt, torch.as_tensor(accum),
                                          torch.as_tensor(grads), lr=0.05)
    assert got_t.dtype == tt.dtype and got_a.dtype == torch.float32
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **ADAGRAD)
    np.testing.assert_allclose(
        got_t.float().numpy(), np.asarray(want_t, np.float32),
        **(ADAGRAD if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)))
    # zero-gradient rows: bitwise unchanged, accumulators too
    assert torch.equal(got_t[torch.as_tensor(zero)],
                       tt[torch.as_tensor(zero)])
    assert torch.equal(got_a[torch.as_tensor(zero)],
                       torch.as_tensor(accum)[torch.as_tensor(zero)])


# ---------------------------------------------------------------------------
# The training flow of tests/test_dlrm.py
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flow_inputs(B=16):
    jcfg = dataclasses.replace(jcfg_mod.smoke(), kernel_mode="interpret")
    jparams = jdlrm.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(0)
    idx, lens = _batch(rng, (jcfg.num_sparse_features, B),
                       jcfg.rows_per_table, jcfg.pooling)
    dense = rng.standard_normal((B, jcfg.num_dense_features)).astype(
        np.float32)
    labels = (np.random.default_rng(2).random(B) < 0.3).astype(np.float32)
    return jcfg, jparams, idx, lens, dense, labels


def _jax_flow(jcfg, params, idx, lens, dense, labels, steps):
    batch = JJagged(indices=jnp.asarray(idx), lengths=jnp.asarray(lens))
    loss_fn = jax.jit(lambda p: jdlrm.bce_loss(
        p, jnp.asarray(dense), batch, jnp.asarray(labels), jcfg))
    grad_fn = jax.jit(jax.grad(lambda p: jdlrm.bce_loss(
        p, jnp.asarray(dense), batch, jnp.asarray(labels), jcfg)))
    accum = j_init(params["tables"])
    losses = []
    for _ in range(steps):
        losses.append(float(loss_fn(params)))
        g = grad_fn(params)
        params["tables"], accum = j_update(params["tables"], accum,
                                           g["tables"], lr=0.05)
        for group in ("bottom", "top"):
            params[group] = jax.tree.map(lambda p, gg: p - 0.05 * gg,
                                         params[group], g[group])
    losses.append(float(loss_fn(params)))
    return losses, params, accum


def _mlp_leaves(params):
    return [layer[k] for group in ("bottom", "top")
            for layer in params[group] for k in ("w", "b")]


def _torch_flow(cfg, params, idx, lens, dense, labels, steps):
    dense_t, batch = batch_from_numpy(dense, idx, lens, device="cpu")
    labels_t = torch.as_tensor(labels)
    accum = rowwise_adagrad_init(params["tables"])
    losses = []
    for _ in range(steps):
        leaves = [params["tables"]] + _mlp_leaves(params)
        for p in leaves:
            p.requires_grad_()
        loss = tdlrm.bce_loss(params, dense_t, batch, labels_t, cfg)
        losses.append(float(loss.detach()))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            params["tables"], accum = rowwise_adagrad_update(
                params["tables"].detach(), accum, grads[0], lr=0.05)
            k = 1
            for group in ("bottom", "top"):
                for layer in params[group]:
                    for name in ("w", "b"):
                        layer[name] = layer[name].detach() - 0.05 * grads[k]
                        k += 1
    with torch.no_grad():
        losses.append(float(tdlrm.bce_loss(params, dense_t, batch, labels_t,
                                           cfg)))
    return losses, params, accum


def test_training_flow_matches_reference():
    steps = 20
    jcfg, jparams, idx, lens, dense, labels = _flow_inputs()
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    want_l, want_p, want_a = _jax_flow(jcfg, jparams, idx, lens, dense,
                                       labels, steps)
    got_l, got_p, got_a = _torch_flow(tcfg_mod.smoke(), params, idx, lens,
                                      dense, labels, steps)
    np.testing.assert_allclose(got_l, want_l, **LOSS)
    assert got_l[-1] < got_l[0], got_l
    np.testing.assert_allclose(got_p["tables"].numpy(),
                               np.asarray(want_p["tables"]), **PARAMS)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                               rtol=1e-4, atol=1e-7)
    for got, want in zip(_mlp_leaves(got_p), _mlp_leaves(
            _np_tree(want_p))):
        np.testing.assert_allclose(got.numpy(), want, **PARAMS)
    # rows no live lookup names were never touched: bitwise the start
    live = np.zeros(params["tables"].shape[:2], bool)
    t, b, l = np.nonzero(np.arange(idx.shape[-1]) < lens[..., None])
    live[t, idx[t, b, l]] = True
    start = torch.tensor(np.asarray(jdlrm.init_params(
        jax.random.key(0), jcfg)["tables"]))
    assert torch.equal(got_p["tables"][torch.as_tensor(~live)],
                       start[torch.as_tensor(~live)])
    assert torch.all(got_a[torch.as_tensor(~live)] == 0)


def test_training_flow_at_config_width_matches_reference():
    """The same flow at CONFIG's widths (26 tables of D=128, the MLPs
    13-512-256-128 and 479-1024-1024-512-256-1), cut to 1000 rows a table
    and a batch of 64 Zipf(1.05) requests: at lr 0.05 the loss first
    rises in both packages (the first row-wise Adagrad step moves every
    touched element by about lr, against N(0, 1/128) entries) and falls
    under its start by test_dlrm's 20 steps.  The reference runs its XLA
    oracle (``kernel_mode="reference"``; interpret mode at this width is
    the emulator's time, not the test's); step by step within
    ``rtol=5e-4``: the rises amplify the f32 order differences."""
    R, B, steps = 1000, 64, 20
    jcfg = dataclasses.replace(jcfg_mod.CONFIG, rows_per_table=R,
                               kernel_mode="reference")
    cfg = dataclasses.replace(tcfg_mod.CONFIG, rows_per_table=R)
    jparams = jdlrm.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(0)
    T, L = jcfg.num_sparse_features, jcfg.pooling
    idx = zipf_ranks(rng, 1.05, R, (T, B, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, (T, B)).astype(np.int32)
    idx[np.arange(L) >= lens[..., None]] = -1
    dense = rng.standard_normal((B, jcfg.num_dense_features)).astype(
        np.float32)
    labels = (rng.random(B) < 0.25).astype(np.float32)
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    want, _, _ = _jax_flow(jcfg, jparams, idx, lens, dense, labels, steps)
    got, _, _ = _torch_flow(cfg, params, idx, lens, dense, labels, steps)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-5)
    assert got[1] > got[0] and want[1] > want[0]
    assert got[-1] < got[0] and want[-1] < want[0]
