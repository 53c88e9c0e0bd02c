"""The port's MoE pieces against the JAX reference, on the CPU.

The same numpy inputs, from ``np.random.default_rng(seed)``, go through
``repro`` and ``repro_torch``.

Tolerances:
  * routing (``core/routing.py``): integer slots, drop counts and bucket
    contents BITWISE the reference's;
  * ``router_topk``: expert ids equal; weights within ``1e-6`` (the
    softmax of f32 logits from two GEMM orders); the load statistics and
    ``aux_loss`` within ``1e-6``;
  * ``moe_ffn`` in f32: outputs within ``1e-5`` (the same f32 arithmetic,
    per-expert products over gathered rows), ``moe_dropped`` 0;
  * ``moe_ffn`` in bf16: BITWISE a torch transcription of the reference's
    scan over all experts (the combine order: ascending expert id, the
    sum carried in ``x.dtype``), and within 4 bf16 ulps (``2**-6``) of
    the largest output of the reference's bf16 run, whose XLA CPU
    backend rounds the elementwise chain at other points.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import routing as jrouting
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.core import routing as trouting
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

SMOKE = tconfigs.get_smoke_config("moonshot-v1-16b-a3b")
# one wider case: d 256, 16 experts, top-4, 2 shared
WIDE = dataclasses.replace(SMOKE, name="moe-wide", d_model=256,
                           num_experts=16, experts_per_token=4,
                           num_shared_experts=2, moe_d_ff=96)
CONFIGS = {"smoke": SMOKE, "wide": WIDE}
OUT_F32 = dict(rtol=1e-5, atol=1e-5)
STATS = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# routing: bitwise
# ---------------------------------------------------------------------------

# (num_buckets, capacity, N, seed): no drops, drops in some buckets, every
# bucket overflowing, one bucket, capacity 1, one element, capacity 0
ROUTING_CASES = [(4, 8, 20, 0), (4, 3, 20, 1), (3, 1, 12, 2), (1, 5, 9, 3),
                 (6, 2, 40, 4), (5, 4, 1, 5), (8, 16, 64, 6), (3, 0, 5, 7)]


def _dest(nb, n, seed):
    return np.random.default_rng(seed).integers(0, nb, n).astype(np.int32)


@pytest.mark.parametrize("nb,cap,n,seed", ROUTING_CASES)
def test_bucket_positions_bitwise(nb, cap, n, seed):
    dest = _dest(nb, n, seed)
    want = jrouting.bucket_positions(jnp.asarray(dest), nb, cap)
    got = trouting.bucket_positions(torch.as_tensor(dest), nb, cap)
    for g, w, dt in zip(got, want, (torch.int32, torch.bool, torch.int32)):
        assert g.dtype == dt
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # dropped elements take the one-past-end slot nb * cap
    assert (got[0][~got[1]] == nb * cap).all()


@pytest.mark.parametrize("nb,cap,n,seed", ROUTING_CASES)
@pytest.mark.parametrize("fill", [0, 7])
def test_scatter_and_gather_bitwise(nb, cap, n, seed, fill):
    dest = _dest(nb, n, seed)
    rng = np.random.default_rng(seed + 100)
    payload = rng.standard_normal((n, 3)).astype(np.float32)
    jslot, _, _ = jrouting.bucket_positions(jnp.asarray(dest), nb, cap)
    tslot, _, _ = trouting.bucket_positions(torch.as_tensor(dest), nb, cap)
    want = jrouting.scatter_to_buckets(jslot, jnp.asarray(payload), nb, cap,
                                       fill)
    got = trouting.scatter_to_buckets(tslot, torch.as_tensor(payload), nb,
                                      cap, fill)
    assert tuple(got.shape) == (nb, cap, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        trouting.gather_from_buckets(tslot, got).numpy(),
        np.asarray(jrouting.gather_from_buckets(jslot, want)))


@pytest.mark.parametrize("nb,cap,n,seed", ROUTING_CASES)
def test_fixed_capacity_bucket_bitwise(nb, cap, n, seed):
    """Two parallel payloads, an int one with a fill past the buckets'
    ids (the EP path's discard tag) and a float one at the default."""
    dest = _dest(nb, n, seed)
    ids = np.arange(n, dtype=np.int32) % 5
    rows = np.random.default_rng(seed).standard_normal((n, 2)).astype(
        np.float32)
    (jb_i, jb_r), jslot, jdrop = jrouting.fixed_capacity_bucket(
        jnp.asarray(dest), nb, cap, [jnp.asarray(ids), jnp.asarray(rows)],
        fills=[nb, 0])
    (tb_i, tb_r), tslot, tdrop = trouting.fixed_capacity_bucket(
        torch.as_tensor(dest), nb, cap,
        [torch.as_tensor(ids), torch.as_tensor(rows)], fills=[nb, 0])
    assert tb_i.dtype == torch.int32 and tdrop.dtype == torch.int32
    for g, w in ((tb_i, jb_i), (tb_r, jb_r), (tslot, jslot),
                 (tdrop, jdrop)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    counts = np.bincount(dest, minlength=nb)
    assert int(tdrop) == int(np.maximum(counts - cap, 0).sum())


def test_positions_stable_order():
    """``tests/test_routing.py``'s case: positions in input order."""
    slot, keep, dropped = trouting.bucket_positions(
        torch.tensor([1, 0, 1, 1, 0]), 2, 3)
    assert slot.tolist() == [3, 0, 4, 5, 1]
    assert keep.all() and int(dropped) == 0


# ---------------------------------------------------------------------------
# MoE pieces
# ---------------------------------------------------------------------------

def _moe_params(cfg, seed):
    """Numpy MoE params of one layer, the reference's layout."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)

    p = {"router": w(d, E), "gate": w(E, d, f), "up": w(E, d, f),
         "down": w(E, f, d)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"gate": w(d, fs), "up": w(d, fs), "down": w(fs, d)}
    return p


def _pair(p, x, dtype):
    """The same params and rows on both sides, in ``dtype`` but for the
    router, which stays f32 as in the reference."""
    jt = getattr(jnp, dtype)
    tt = getattr(torch, dtype)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jt), p)
    tp = jax.tree_util.tree_map(lambda a: torch.as_tensor(a).to(tt), p)
    jp["router"] = jnp.asarray(p["router"])
    tp["router"] = torch.as_tensor(p["router"])
    return jp, tp, jnp.asarray(x).astype(jt), torch.as_tensor(x).to(tt)


def _inputs(cfg, seed, n=64):
    p = _moe_params(cfg, seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (n, cfg.d_model)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_router_topk_and_aux_loss_match_jax(name):
    cfg = CONFIGS[name]
    jp, tp, jx, tx = _pair(*_inputs(cfg, 1), "float32")
    jw, ji, js = jmoe.router_topk(jx, jp["router"], cfg.experts_per_token)
    tw, ti, ts = tmoe.router_topk(tx, tp["router"], cfg.experts_per_token)
    assert ti.dtype == torch.int32 and tw.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **STATS)
    for g, w in zip(ts, js):
        np.testing.assert_allclose(_np(g), _np(w), **STATS)
    np.testing.assert_allclose(float(tmoe.aux_loss(ts)),
                               float(jmoe.aux_loss(js)), **STATS)


def test_router_topk_breaks_ties_to_the_lower_expert():
    """Equal logits (duplicated router columns) go to the lower expert id
    first, as ``jax.lax.top_k`` takes them."""
    cfg = WIDE
    p, x = _inputs(cfg, 2)
    r = p["router"]
    r[:, 9] = r[:, 3]
    r[:, 12] = r[:, 5]
    r[:, 14] = r[:, 3]
    jp, tp, jx, tx = _pair(p, x, "float32")
    logits = (tx @ tp["router"]).numpy()
    assert (logits[:, 3] == logits[:, 9]).all()
    for k in (1, 4, 7):
        _, ji, _ = jmoe.router_topk(jx, jp["router"], k)
        _, ti, _ = tmoe.router_topk(tx, tp["router"], k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_ffn_matches_jax_f32(name):
    cfg = CONFIGS[name]
    jp, tp, jx, tx = _pair(*_inputs(cfg, 3), "float32")
    want, jaux = jmoe.moe_ffn(jp, jx, cfg)
    got, taux = tmoe.moe_ffn(tp, tx, cfg)
    assert got.dtype == torch.float32 and got.shape == tx.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_F32)
    np.testing.assert_allclose(float(taux["moe_aux"]),
                               float(jaux["moe_aux"]), **STATS)
    assert taux["moe_dropped"].dtype == torch.int32
    assert int(taux["moe_dropped"]) == int(jaux["moe_dropped"]) == 0


def _scan_in_reference_order(p, x, cfg):
    """A torch transcription of the reference's ``moe_ffn``: every
    expert on every row, ``out`` carried in ``x.dtype``, ``y_e * w_e``
    (the weight cast to ``x.dtype``) added for e = 0 ... E-1."""
    w, topi, _ = tmoe.router_topk(x, p["router"], cfg.experts_per_token)
    act = tlayers.activation_fn(cfg.activation)
    out = torch.zeros_like(x)
    for e in range(cfg.num_experts):
        y = (act(x @ p["gate"][e]) * (x @ p["up"][e])) @ p["down"][e]
        sel = (topi == e).float() * w
        out = out + y * sel.sum(-1, keepdim=True).to(y.dtype)
    return out + tmoe._shared_out(p, x, cfg.activation)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_combines_in_the_reference_order(name, dtype):
    """The routed form equals the reference's scan over all experts
    bitwise: each token's k experts summed in ascending id, in x.dtype."""
    cfg = CONFIGS[name]
    _, tp, _, tx = _pair(*_inputs(cfg, 4), dtype)
    got, _ = tmoe.moe_ffn(tp, tx, cfg)
    assert got.dtype == tx.dtype
    assert torch.equal(got, _scan_in_reference_order(tp, tx, cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_dispatches_in_chunks_per_token(monkeypatch, dtype):
    """Over CHUNK_ROWS tokens the dispatch runs chunk by chunk (one
    capacity each; 50 rows in chunks of 16, the last one short): every
    token's output is bitwise the reference order's, as in one chunk,
    and the load statistics stay the whole call's."""
    cfg = WIDE
    jp, tp, jx, tx = _pair(*_inputs(cfg, 7, n=50), dtype)
    whole, whole_aux = tmoe.moe_ffn(tp, tx, cfg)
    calls = []
    real = trouting.fixed_capacity_bucket
    monkeypatch.setattr(trouting, "fixed_capacity_bucket",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(tmoe, "CHUNK_ROWS", 16)
    got, aux = tmoe.moe_ffn(tp, tx, cfg)
    assert len(calls) == 4
    assert torch.equal(got, whole)
    assert torch.equal(got, _scan_in_reference_order(tp, tx, cfg))
    assert torch.equal(aux["moe_aux"], whole_aux["moe_aux"])
    assert int(aux["moe_dropped"]) == 0
    if dtype == "float32":
        want, jaux = jmoe.moe_ffn(jp, jx, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_F32)
        np.testing.assert_allclose(float(aux["moe_aux"]),
                                   float(jaux["moe_aux"]), **STATS)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_ffn_matches_jax_bf16(name):
    cfg = CONFIGS[name]
    jp, tp, jx, tx = _pair(*_inputs(cfg, 5), "bfloat16")
    want, _ = jmoe.moe_ffn(jp, jx, cfg)
    got, _ = tmoe.moe_ffn(tp, tx, cfg)
    assert got.dtype == torch.bfloat16
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=2 ** -6 * np.abs(want).max())


def test_moe_ffn_without_shared_experts_and_dropping_nothing():
    """No shared experts, and every token on the same top-k (one expert
    takes all N rows: the capacity grows to the load, nothing drops)."""
    cfg = dataclasses.replace(WIDE, num_shared_experts=0)
    p, x = _inputs(cfg, 6, n=24)
    assert "shared" not in p
    p["router"][:] = 0.0
    p["router"][0, :] = np.arange(cfg.num_experts, dtype=np.float32)
    x[:, 0] = np.abs(x[:, 0]) + 1.0
    jp, tp, jx, tx = _pair(p, x, "float32")
    want, _ = jmoe.moe_ffn(jp, jx, cfg)
    got, aux = tmoe.moe_ffn(tp, tx, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_F32)
    assert int(aux["moe_dropped"]) == 0


def test_init_moe_params_layout():
    cfg = SMOKE
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), 3, cfg,
                             torch.bfloat16, "cpu")
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    fs = f * cfg.num_shared_experts
    want = {"router": (3, d, E), "gate": (3, E, d, f), "up": (3, E, d, f),
            "down": (3, E, f, d)}
    for k, shape in want.items():
        assert tuple(p[k].shape) == shape, k
    assert p["router"].dtype == torch.float32
    # drawn in the working dtype first, as the reference rounds it
    assert torch.equal(p["router"], p["router"].bfloat16().float())
    assert p["gate"].dtype == torch.bfloat16
    assert {k: tuple(v.shape) for k, v in p["shared"].items()} == {
        "gate": (3, d, fs), "up": (3, d, fs), "down": (3, fs, d)}
    # truncated normal at fan-in scale: |w| <= 2 / sqrt(fan_in)
    assert float(p["down"].float().abs().max()) <= 2 * f ** -0.5 * 1.01


def test_moe_ffn_ep_waits_for_item_13_6():
    with pytest.raises(NotImplementedError, match="Queue 1 item 13.6"):
        tmoe.moe_ffn_ep({}, torch.zeros((2, 4)), SMOKE, "model")
