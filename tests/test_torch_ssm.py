"""The port's state-space mixers (``repro_torch.models.ssm``: Mamba for the
hybrid family, RWKV-6 for the ssm family) against the JAX reference
(``repro.models.ssm``), on the CPU, in f32 at the smoke configs.

The same numpy inputs and parameters (the reference's ``init_*_params``
drawn once, then every leaf moved by a seeded perturbation so that no
bias, skip or decay sits at its init constant) go through both packages.

Tolerances (f32):
  * ``_causal_conv``, ``rwkv_channel_mix``, the mix inputs and one
    decode step: ``1e-5`` (the same f32 arithmetic, other summation
    orders in the products);
  * ``mamba_forward`` and its ``h_final``: ``1e-5`` (the reference's
    ``associative_scan`` and the port's doubling scan combine the same
    steps in other trees);
  * the doubling scan against a float64 loop of the recurrence: ``1e-5``
    relative (f32 products of at most 300 factors);
  * the RWKV scan: ``1e-5``; the chunked form against the reference's
    chunked form and against the scan: ``1e-4``, the reference's own
    bound for chunked against scan (``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

TOL = dict(rtol=1e-5, atol=1e-5)
CHUNKED = dict(rtol=1e-4, atol=1e-4)
HYBRID, SSM = "hymba-1.5b", "rwkv6-1.6b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _params(init, arch, seed):
    """Layer 0 of the reference's stacked init for the smoke config, every
    leaf moved by N(0, 0.1 |leaf| + 0.02): (jax cfg, port cfg, jax params,
    port params)."""
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a[0], np.float32),
        init(jax.random.key(seed), 1, jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    p = {k: (v + rng.standard_normal(v.shape).astype(np.float32)
             * (0.1 * np.abs(v) + 0.02)) for k, v in p.items()}
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(v) for k, v in p.items()})


def _x(rng, *shape, scale=0.5):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    _, _, jp, tp = _params(jssm.init_mamba_params, HYBRID, 0)
    rng = np.random.default_rng(1)
    K, di = jp["conv_w"].shape
    jx, tx = _x(rng, 2, 9, di)
    js, ts = _x(rng, 2, K - 1, di) if with_state else (None, None)
    jy, jst = jssm._causal_conv(jx, jp["conv_w"], jp["conv_b"], js)
    ty, tst = tssm._causal_conv(tx, tp["conv_w"], tp["conv_b"], ts)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_array_equal(_np(tst), _np(jst))


def _jax_decode_steps(jp, jx, jcfg):
    """The reference's mamba_decode_step over every token of jx from zero
    states: (y (B, S, d), h_final)."""
    B, S, d = jx.shape
    di, N = jp["A_log"].shape
    h = jnp.zeros((B, di, N), jnp.float32)
    conv = jnp.zeros((B, jcfg.ssm_conv - 1, di), jnp.float32)
    ys = []
    for t in range(S):
        y, h, conv = jssm.mamba_decode_step(jp, jx[:, t:t + 1], jcfg, h,
                                            conv)
        ys.append(y)
    return jnp.concatenate(ys, axis=1), h


@pytest.mark.parametrize("S", [1, 37, 128, 300])
def test_mamba_forward_matches_jax(S):
    """S below the chunk (1, 37), one full chunk (128), and 300: two full
    chunks and a ragged 44-step one, carrying h across them.  Under K-1
    tokens (S = 1) the reference's forward raises (its conv pads S rows,
    not K-1), so the port's is held to the reference's decode steps from
    zero states; from S = 37 on to both."""
    jcfg, tcfg, jp, tp = _params(jssm.init_mamba_params, HYBRID, 2)
    jx, tx = _x(np.random.default_rng(S), 2, S, jcfg.d_model)
    if S < jcfg.ssm_conv - 1:
        with pytest.raises(TypeError):
            jssm.mamba_forward(jp, jx, jcfg)
        jy, jh = _jax_decode_steps(jp, jx, jcfg)
    else:
        jy, jh = jssm.mamba_forward(jp, jx, jcfg)
        sy, _ = _jax_decode_steps(jp, jx[:, :37], jcfg)
        np.testing.assert_allclose(_np(jy[:, :37]), _np(sy), **TOL)
    ty, th = tssm.mamba_forward(tp, tx, tcfg)
    assert th.dtype == torch.float32 and tuple(th.shape) == jh.shape
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)


def test_mamba_decode_step_matches_jax():
    jcfg, tcfg, jp, tp = _params(jssm.init_mamba_params, HYBRID, 3)
    rng = np.random.default_rng(4)
    di, N = jp["A_log"].shape
    K = jcfg.ssm_conv
    jx, tx = _x(rng, 3, 1, jcfg.d_model)
    jh, th = _x(rng, 3, di, N)
    jc, tc = _x(rng, 3, K - 1, di)
    jy, jh2, jc2 = jssm.mamba_decode_step(jp, jx, jcfg, jh, jc)
    ty, th2, tc2 = tssm.mamba_decode_step(tp, tx, tcfg, th, tc)
    for got, want in ((ty, jy), (th2, jh2), (tc2, jc2)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("S", [2, 4, 50])
def test_mamba_conv_state_is_the_last_pre_conv_inputs(S):
    """The conv state prefill hands to decode: the reference's
    ``(x @ in_proj)[:, -(K-1):]`` first half for S >= K-1, and what
    ``_causal_conv`` carries (zeros in front) for any S."""
    jcfg, tcfg, jp, tp = _params(jssm.init_mamba_params, HYBRID, 5)
    jx, tx = _x(np.random.default_rng(6), 2, S, jcfg.d_model)
    got = tssm.mamba_conv_state(tp, tx, tcfg)
    K = tcfg.ssm_conv
    assert tuple(got.shape) == (2, K - 1, jp["conv_w"].shape[1])
    xs, _ = jssm._mamba_gates(jp, jx, jcfg)
    _, want = jssm._causal_conv(xs, jp["conv_w"], jp["conv_b"])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    if S >= K - 1:
        ref, _ = jnp.split(jx @ jp["in_proj"], 2, axis=-1)
        np.testing.assert_allclose(_np(got), _np(ref[:, -(K - 1):]), **TOL)


@pytest.mark.parametrize("n", [1, 2, 7, 128, 300])
def test_doubling_scan_matches_a_float64_loop(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.2, 1.0, (2, n, 3, 4))
    b = rng.standard_normal((2, n, 3, 4))
    aa, bb = tssm._doubling_scan(torch.as_tensor(a, dtype=torch.float32),
                                 torch.as_tensor(b, dtype=torch.float32))
    h, p = np.zeros((2, 3, 4)), np.ones((2, 3, 4))
    hs, ps = [], []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        p = p * a[:, t]
        hs.append(h)
        ps.append(p)
    np.testing.assert_allclose(bb.double().numpy(), np.stack(hs, 1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aa.double().numpy(), np.stack(ps, 1),
                               rtol=1e-5, atol=1e-30)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_time_mix_matches_jax(carried):
    jcfg, tcfg, jp, tp = _params(jssm.init_rwkv_params, SSM, 7)
    rng = np.random.default_rng(8)
    d, hs = jcfg.d_model, jcfg.rwkv_head_size
    jx, tx = _x(rng, 2, 11, d)
    kw_j, kw_t = {}, {}
    if carried:
        (js, ts), (jl, tl) = _x(rng, 2, d // hs, hs, hs), _x(rng, 2, d)
        kw_j, kw_t = dict(state=js, x_last=jl), dict(state=ts, x_last=tl)
    jy, (jS, jlast) = jssm.rwkv_time_mix(jp, jx, jcfg, **kw_j)
    ty, (tS, tlast) = tssm.rwkv_time_mix(tp, tx, tcfg, **kw_t)
    assert tS.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(_np(tS), _np(jS), **TOL)
    np.testing.assert_array_equal(_np(tlast), _np(jlast))


@pytest.mark.parametrize("B,S,chunk", [(2, 37, 8), (1, 64, 64), (3, 16, 4)])
def test_rwkv_time_mix_chunked_matches_jax_and_the_scan(B, S, chunk):
    """The reference's (B, S, chunk) cases (``tests/test_models.py``): a
    ragged last chunk, one chunk, four; from zeros and from a carried
    state."""
    jcfg, tcfg, jp, tp = _params(jssm.init_rwkv_params, SSM, 9)
    rng = np.random.default_rng(S)
    d, hs = jcfg.d_model, jcfg.rwkv_head_size
    jx, tx = _x(rng, B, S, d)
    (js, ts), (jl, tl) = _x(rng, B, d // hs, hs, hs), _x(rng, B, d)
    for kw_j, kw_t in (({}, {}), (dict(state=js, x_last=jl),
                                  dict(state=ts, x_last=tl))):
        jy, (jS, _) = jssm.rwkv_time_mix_chunked(jp, jx, jcfg, chunk=chunk,
                                                 **kw_j)
        ty, (tS, tlast) = tssm.rwkv_time_mix_chunked(tp, tx, tcfg,
                                                     chunk=chunk, **kw_t)
        sy, (sS, _) = tssm.rwkv_time_mix(tp, tx, tcfg, **kw_t)
        for got, want in ((ty, jy), (tS, jS), (ty, sy), (tS, sS)):
            np.testing.assert_allclose(_np(got), _np(want), **CHUNKED)
        np.testing.assert_array_equal(_np(tlast), _np(tx[:, -1]))


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_channel_mix_matches_jax(carried):
    jcfg, tcfg, jp, tp = _params(jssm.init_rwkv_params, SSM, 10)
    rng = np.random.default_rng(11)
    jx, tx = _x(rng, 2, 6, jcfg.d_model)
    jl, tl = _x(rng, 2, jcfg.d_model) if carried else (None, None)
    jy, jlast = jssm.rwkv_channel_mix(jp, jx, jcfg, x_last=jl)
    ty, tlast = tssm.rwkv_channel_mix(tp, tx, tcfg, x_last=tl)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_array_equal(_np(tlast), _np(jlast))


# ---------------------------------------------------------------------------
# the hybrid family's per-layer windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("replace", [{}, dict(window=None),
                                     dict(global_attn_layers=(1,))])
@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_hymba_windows_match_reference(get, replace):
    jcfg = dataclasses.replace(getattr(jconfigs, get)(HYBRID), **replace)
    tcfg = dataclasses.replace(getattr(tconfigs, get)(HYBRID), **replace)
    want = np.asarray(jlm._hymba_windows(jcfg)).tolist()
    assert list(tlm._hymba_windows(tcfg)) == want
    (name, n, windows), = tlm.block_stacks(tcfg)
    assert (name, n, windows) == ("blocks", tcfg.num_layers, tuple(want))
    if get == "get_config" and not replace:
        assert [i for i, w in enumerate(windows) if w != 1024] == [0, 15, 31]
