"""The port's LM serving path (the dense family, the GQA MoE moonshot, the
MLA MoE deepseek-v3, the hybrid hymba, the ssm rwkv6, the audio whisper
and the vlm internvl2) against the JAX reference, on the CPU (where the
flash-attention wrapper takes its plain version;
``tests/test_torch_mla.py`` holds MLA's own functions and its bf16 path,
``tests/test_torch_ssm.py`` the Mamba and RWKV mixers,
``tests/test_torch_audio_vlm.py`` the encoder, cross attention, the
projector and whisper's generate).  The audio family's forward and
prefill take ``frames``, the vlm forward ``patches`` (:func:`_inputs`).

The same numpy inputs, from ``np.random.default_rng(seed)``, go through
``repro`` and through ``repro_torch``; parameters come from the
reference's ``lm.init_params(..., dtype=float32)`` through
``lm_params_from_numpy``.

Tolerances:
  * flash attention, as ``tests/test_kernels.py`` holds the Pallas kernel:
    ``2e-5`` in f32 (two f32 softmax orders), ``3e-2`` in bf16 (outputs
    rounded to bf16 from f32 results that may differ in the last bits);
  * layers: ``1e-5`` (the same f32 arithmetic, other summation orders);
  * hidden states after 2 layers: ``1e-4`` (f32 matmuls of width <= 256
    in other orders, carried through the residual stream);
  * the MoE's ``moe_aux``: ``1e-6``; ``moe_dropped``, greedy tokens and
    integer cache lengths: equal;
  * the cache after prefill and a decode step: ``1e-4``, K/V rows and the
    carried states (Mamba's ``ssm_h``/``conv``, RWKV's ``S``/``x_tm``/
    ``x_cm``) alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import decode as jdec
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tflash
from repro_torch.launch import serve as tserve
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.serving import engine as tengine
from repro_torch.utils.convert import lm_params_from_numpy

LAYER = dict(rtol=1e-5, atol=1e-5)
HIDDEN = dict(rtol=1e-4, atol=1e-4)
DENSE = ["granite-8b", "starcoder2-15b", "yi-34b", "nemotron-4-340b"]
MOE = "moonshot-v1-16b-a3b"
MLA = "deepseek-v3-671b"
HYBRID = "hymba-1.5b"
SSM = "rwkv6-1.6b"
AUDIO = "whisper-base"
VLM = "internvl2-2b"
PORTED = DENSE + [MOE, MLA, HYBRID, SSM, AUDIO, VLM]
FLASH_SHAPES = [
    (2, 128, 4, 2, 32, True, None),
    (1, 256, 4, 4, 64, True, 64),
    (2, 96, 2, 1, 16, False, None),    # non-block-multiple S
    (1, 64, 8, 2, 128, True, None),
]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(a, dtype="float32"):
    """The same numpy array as a JAX array and a torch tensor of dtype."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _inputs(cfg, B, seed):
    """The family's extra forward inputs as numpy, N(0, 1) from ``seed``
    (as ``repro.data.synthetic`` draws them): ``frames`` (B,
    encoder_seq_len, d) for audio, ``patches`` (B, vision_tokens,
    vision_dim) for vlm, none for the rest."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)}
    return {}


def _jax_kw(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _torch_kw(kw):
    return {k: torch.as_tensor(v) for k, v in kw.items()}


_PARAMS = {}


def _setup(arch, **replace):
    """(jax cfg, port cfg, jax params, port params) of the smoke config,
    f32, the same weights on both sides."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **replace)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **replace)
    if arch not in _PARAMS:
        jp = jlm.init_params(jax.random.key(0), jcfg, dtype=jnp.float32)
        _PARAMS[arch] = (jp, lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return (jcfg, tcfg) + _PARAMS[arch]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_configs_mirror_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()


def test_non_dense_archs_raise():
    """Every arch of the reference is ported (the audio whisper and the
    vlm internvl2 last), in the registry and in the model code; an
    unknown arch raises ``KeyError``, and a family / attention pair the
    reference does not run raises in the model code."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert sorted(tconfigs.PORTED_ARCH_IDS) == sorted(PORTED) \
        == sorted(jconfigs.ARCH_IDS)
    assert {tconfigs.get_config(a).family for a in PORTED} == {
        "dense", "moe", "hybrid", "ssm", "audio", "vlm"}
    for arch in PORTED:
        cfg = tconfigs.get_smoke_config(arch)
        assert (cfg.family, cfg.attention) in tlm.PORTED
    for bad in ("gpt-2", "whisper-large"):
        with pytest.raises(KeyError):
            tconfigs.get_config(bad)
        with pytest.raises(KeyError):
            tconfigs.get_smoke_config(bad)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(AUDIO),
                              attention="mla")
    with pytest.raises(NotImplementedError, match="no pair the reference"):
        tlm.init_params(torch.Generator(), cfg, device="cpu")
    assert tconfigs.get_config(MOE).param_count() == 28_325_838_848
    assert tconfigs.get_config(MLA).param_count() == \
        jconfigs.get_config(MLA).param_count()


# ---------------------------------------------------------------------------
# the flash kernel's wrapper (its plain version, here)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,KH,hd,causal,window", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(B, S, H, KH, hd, causal, window,
                                     dtype):
    rng = np.random.default_rng(S + hd)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((B, S, h, hd)).astype(np.float32), dtype)
        for h in (H, KH, KH))
    tol = 2e-5 if dtype == "float32" else 3e-2
    tflash.reset_launch_counts()
    got = tflash.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, S, H, hd)
    assert tflash.LAUNCH_COUNTS["flash_attention"] == 0   # plain version
    want = jflash(jq, jk, jv, causal=causal, window=window, q_block=32,
                  kv_block=32, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    for oracle in (jlayers.chunked_attention, jlayers.full_attention):
        np.testing.assert_allclose(
            _np(got), _np(oracle(jq, jk, jv, causal=causal, window=window)),
            rtol=tol, atol=tol)


@pytest.mark.parametrize("q_block,kv_block", [(32, 32), (40, 24)])
def test_chunked_attention_blocks_match_jax(q_block, kv_block):
    """Block sizes that do not divide S, and that differ from each other:
    the port's plain version against the reference's oracle."""
    rng = np.random.default_rng(7)
    jq, tq = _pair(rng.standard_normal((2, 100, 4, 16)).astype(np.float32))
    jk, tk = _pair(rng.standard_normal((2, 100, 2, 16)).astype(np.float32))
    jv, tv = _pair(rng.standard_normal((2, 100, 2, 16)).astype(np.float32))
    for causal, window in ((True, None), (True, 17), (False, 33)):
        got = tflash.chunked_attention(tq, tk, tv, causal=causal,
                                       window=window, q_block=q_block,
                                       kv_block=kv_block)
        want = jlayers.chunked_attention(jq, jk, jv, causal=causal,
                                         window=window, q_block=q_block,
                                         kv_block=kv_block)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=2e-5)


def test_flash_kernel_path_refuses_cpu_tensors_and_needs_nvcc(monkeypatch,
                                                              tmp_path):
    """The launch path takes CUDA tensors only, and its source builds with
    nvcc or raises (no fallback)."""
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash._launch(q, q, q, True, None)
    assert "flash_attention" in build.SOURCES
    path = build.library_path("flash_attention")
    assert path.name.startswith("flash_attention-")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["flash_attention"])


def test_attention_dispatch_follows_the_threshold(monkeypatch):
    """Above the threshold attention() goes through the flash wrapper, at
    or below it (or with S_q != S_k) it stays full attention; both agree
    with the reference's dispatch."""
    calls = []
    real = tlayers.flash_attention
    monkeypatch.setattr(tlayers, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng.standard_normal((1, 24, 4, 16)).astype(np.float32))
    jk, tk = _pair(rng.standard_normal((1, 24, 2, 16)).astype(np.float32))
    for thr, n in ((24, 0), (23, 1)):
        got = tlayers.attention(tq, tk, tk, window=5, chunk_threshold=thr)
        want = jlayers.attention(jq, jk, jk, window=5, chunk_threshold=thr)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=2e-5)
        assert len(calls) == n
    # a scale other than hd ** -0.5, or hd_v != hd (MLA's shapes), goes to
    # chunked_attention by shape, never to the flash wrapper
    jv, tv = _pair(rng.standard_normal((1, 24, 2, 8)).astype(np.float32))
    for scale, (jvv, tvv) in ((0.1, (jk, tk)), (None, (jv, tv))):
        tlayers.reset_call_counts()
        got = tlayers.attention(tq, tk, tvv, scale=scale, chunk_threshold=8)
        want = jlayers.attention(jq, jk, jvv, scale=scale, chunk_threshold=8)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=2e-5)
        assert tlayers.CALL_COUNTS["chunked_attention"] == 1
        assert len(calls) == 1


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_rope_and_activations_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _pair(x), _pair(w), _pair(b)
    np.testing.assert_allclose(_np(tlayers.rms_norm(tx, tw)),
                               _np(jlayers.rms_norm(jx, jw)), **LAYER)
    np.testing.assert_allclose(_np(tlayers.layer_norm(tx, tw, tb)),
                               _np(jlayers.layer_norm(jx, jw, jb)), **LAYER)
    for act in ("silu", "gelu", "relu", "relu2"):
        np.testing.assert_allclose(
            _np(tlayers.activation_fn(act)(tx)),
            _np(jlayers.activation_fn(act)(jx)), **LAYER, err_msg=act)
    heads = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 5))
    for theta in (10000.0, 1e7):
        np.testing.assert_allclose(
            _np(tlayers.apply_rope(torch.as_tensor(heads),
                                   torch.as_tensor(pos), theta=theta)),
            _np(jlayers.apply_rope(jnp.asarray(heads), jnp.asarray(pos),
                                   theta=theta)),
            rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"),
                                       (False, "relu2")])
def test_ffn_matches_jax(gated, act):
    rng = np.random.default_rng(1)
    p = {"up": rng.standard_normal((16, 40)).astype(np.float32) / 4,
         "down": rng.standard_normal((40, 16)).astype(np.float32) / 6}
    if gated:
        p["gate"] = rng.standard_normal((16, 40)).astype(np.float32) / 4
    x = rng.standard_normal((3, 4, 16)).astype(np.float32)
    got = tlayers.apply_ffn({k: torch.as_tensor(v) for k, v in p.items()},
                            torch.as_tensor(x), act)
    want = jlayers.apply_ffn({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), act)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER)


@pytest.mark.parametrize("window,kv_offset", [(None, 0), (6, 0), (None, 8)])
def test_decode_attention_partial_and_combine_match_jax(window, kv_offset):
    rng = np.random.default_rng(2)
    B, Sc, H, KH, hd = 3, 20, 8, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, Sc, KH, hd)).astype(np.float32)
    vc = rng.standard_normal((B, Sc, KH, hd)).astype(np.float32)
    length = np.array([[5], [20 + kv_offset], [13]], np.int32)
    got = tlayers.decode_attention_partial(
        torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
        torch.as_tensor(length), window=window, kv_offset=kv_offset)
    want = jlayers.decode_attention_partial(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(length), window=window, kv_offset=kv_offset)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **LAYER)
    np.testing.assert_allclose(
        _np(tlayers.combine_decode_partials(*got)),
        _np(jlayers.combine_decode_partials(*want)), **LAYER)
    with pytest.raises(NotImplementedError):
        tlayers.combine_decode_partials(*got, axis_name="model")


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("threshold,S", [(None, 16), (16, 40)])
def test_forward_matches_jax(arch, threshold, S):
    """At the default threshold (full attention) and at a lowered one with
    S = 40, where every layer's attention takes the flash wrapper (the
    hybrid family's with its layer's window; the ssm family has no
    attention; the audio encoder's 32 frames, non-causal, too; the vlm's
    8 + 40 prefixed positions; cross attention never)."""
    rep = {} if threshold is None else dict(attn_chunk_threshold=threshold)
    jcfg, tcfg, jp, tp = _setup(arch, **rep)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, S))
    kw = _inputs(jcfg, 2, 14)
    tflash.reset_launch_counts()
    tlayers.reset_call_counts()
    calls = []
    real = tlayers.flash_attention
    tlayers.flash_attention = lambda *a, **kw: calls.append(1) or real(
        *a, **kw)
    try:
        got, aux = tlm.forward(tp, torch.as_tensor(tokens), tcfg,
                               **_torch_kw(kw))
    finally:
        tlayers.flash_attention = real
    want, jaux = jlm.forward(jp, jnp.asarray(tokens), jcfg, **_jax_kw(kw))
    assert sorted(aux) == sorted(jaux)
    if "moe_aux" in aux:
        np.testing.assert_allclose(float(aux["moe_aux"]),
                                   float(jaux["moe_aux"]), rtol=1e-6,
                                   atol=1e-6)
        assert int(aux["moe_dropped"]) == int(jaux["moe_dropped"]) == 0
    if "encoder_out" in aux:
        np.testing.assert_allclose(_np(aux["encoder_out"]),
                                   _np(jaux["encoder_out"]), **HIDDEN)
    assert tuple(got.shape) == want.shape
    # over the threshold every layer takes the flash wrapper (GQA) or
    # chunked_attention (MLA's hd_v != hd); the audio encoder's layers too
    long = 0 if threshold is None or jcfg.family == "ssm" \
        else jcfg.num_layers + jcfg.encoder_layers
    mla = jcfg.attention == "mla"
    assert len(calls) == (0 if mla else long)
    assert tlayers.CALL_COUNTS["chunked_attention"] == (long if mla else 0)
    np.testing.assert_allclose(_np(got), _np(want), **HIDDEN)
    np.testing.assert_allclose(
        _np(tlm.lm_logits(tp, got, tcfg)), _np(jlm.lm_logits(jp, want, jcfg,
                                                             None)),
        **HIDDEN)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_step_match_jax(arch):
    """Prefill then one decode step: hidden states and every cache entry,
    the audio family's ``enc`` (batch first, no layer stack) too; the
    vlm family text only, as the reference's prefill takes it."""
    jcfg, tcfg, jp, tp = _setup(arch, attn_chunk_threshold=8)
    B, S = 2, 16
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, S))
    kw = {k: v for k, v in _inputs(jcfg, B, 15).items() if k == "frames"}
    jcache, jh = jdec.prefill(jp, jnp.asarray(tokens[:, :-1]), jcfg,
                              max_len=S + 4, **_jax_kw(kw))
    tcache, th = tdec.prefill(tp, torch.as_tensor(tokens[:, :-1]), tcfg,
                              max_len=S + 4, **_torch_kw(kw))
    np.testing.assert_allclose(_np(th), _np(jh), **HIDDEN)
    jcache, jh = jdec.decode_step(jp, jcache, jnp.asarray(tokens[:, -1]),
                                  jcfg)
    tcache, th = tdec.decode_step(tp, tcache, torch.as_tensor(tokens[:, -1]),
                                  tcfg)
    np.testing.assert_allclose(_np(th), _np(jh), **HIDDEN)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["length"]))
    stacks = tdec.kv_stacks(tcache)
    top = sorted(k for k in jcache if not isinstance(jcache[k], dict))
    assert top == sorted(k for k in tcache if k not in stacks)
    assert top == (["enc", "length"] if arch == AUDIO else ["length"])
    if arch == AUDIO:
        want = jcache["enc"]
        assert tuple(tcache["enc"].shape) == want.shape == (
            B, jcfg.encoder_seq_len, jcfg.d_model)
        np.testing.assert_allclose(_np(tcache["enc"]), _np(want), **HIDDEN)
    assert sorted(stacks) == sorted(k for k in jcache if k not in top)
    for name in stacks:
        assert sorted(stacks[name]) == sorted(jcache[name])
        for key, got in stacks[name].items():
            want = jcache[name][key]
            assert tuple(got.shape) == want.shape, (name, key)
            assert got.dtype == _torch_dtype(want.dtype), (name, key)
            # positional rows: the S written ones; states: whole
            rows = slice(None) if key in tdec.STATE_KEYS else slice(S)
            np.testing.assert_allclose(_np(got[:, :, rows]),
                                       _np(want[:, :, rows]), **HIDDEN,
                                       err_msg=f"{name}/{key}")


@pytest.mark.parametrize("arch", PORTED)
def test_port_decode_matches_forward(arch):
    """The port's own prefill + decode_step reproduce its forward's last
    hidden state (``tests/test_models.py``'s check, same bound; the audio
    family's with its frames).  The vlm forward needs patches, which
    prefill refuses (as the reference's does, whose test leaves
    internvl2 out): there decode is held to prefill over the whole text
    instead."""
    _, tcfg, _, tp = _setup(arch)
    tokens = torch.as_tensor(
        np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 16)))
    kw = _torch_kw(_inputs(tcfg, 2, 16))
    if arch == VLM:
        _, h = tdec.prefill(tp, tokens, tcfg)
        kw = {}
    else:
        h, _ = tlm.forward(tp, tokens, tcfg, **kw)
    cache, _ = tdec.prefill(tp, tokens[:, :-1], tcfg, max_len=20, **kw)
    cache, h_dec = tdec.decode_step(tp, cache, tokens[:, -1], tcfg)
    assert float((h_dec - h[:, -1]).abs().max()) < 2e-3
    assert cache["length"].tolist() == [16, 16]


def test_write_kv_drops_positions_past_the_cache():
    """As the reference's scatter: a slot whose length ran past the cache
    (an empty slot keeps decoding) writes nothing; K/V rows and MLA's
    latent rows alike."""
    ck = torch.zeros((2, 4, 1, 2))
    cv = torch.zeros((2, 4, 1, 2))
    new = torch.ones((2, 1, 1, 2))
    tdec._write_rows({"k": ck, "v": cv}, {"k": new, "v": 2 * new},
                     torch.tensor([1, 4]))
    assert ck[0, 1].eq(1).all() and cv[0, 1].eq(2).all()
    assert ck.sum() == 2 and cv.sum() == 4
    c_kv = torch.zeros((2, 4, 3))
    tdec._write_rows({"c_kv": c_kv}, {"c_kv": torch.ones((2, 1, 3))},
                     torch.tensor([4, 2]))
    assert c_kv[1, 2].eq(1).all() and c_kv.sum() == 3


def test_init_cache_holds_rows_and_states():
    """Positional rows (layers, B, max_len, ...) in the model dtype beside
    whole states (layers, B, ...): Mamba's ``ssm_h`` and RWKV's ``S`` in
    f32 whatever the dtype; ``_write_rows`` refuses a state."""
    for arch, want in (
            (HYBRID, {"k": ((2, 3, 10, 2, 16), torch.bfloat16),
                      "v": ((2, 3, 10, 2, 16), torch.bfloat16),
                      "ssm_h": ((2, 3, 128, 4), torch.float32),
                      "conv": ((2, 3, 3, 128), torch.bfloat16)}),
            (SSM, {"S": ((2, 3, 4, 16, 16), torch.float32),
                   "x_tm": ((2, 3, 64), torch.bfloat16),
                   "x_cm": ((2, 3, 64), torch.bfloat16)})):
        cache = tdec.init_cache(tconfigs.get_smoke_config(arch), 3, 10,
                                device="cpu")
        got = {k: (tuple(t.shape), t.dtype)
               for k, t in tdec.kv_stacks(cache)["blocks"].items()}
        assert got == want, arch
    lc = tlm.layer(cache["blocks"], 0)
    with pytest.raises(ValueError, match="whole states"):
        tdec._write_rows(lc, {"x_tm": torch.ones((3, 1, 64))},
                         torch.tensor([0, 1, 2]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_generate_matches_jax():
    jcfg, tcfg, jp, tp = _setup("granite-8b")
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 6))
    want = jengine.generate(jp, jcfg, jnp.asarray(prompts), max_new=5)
    got = tengine.generate(tp, tcfg, prompts, max_new=5, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_samples_from_its_generator():
    """Temperature sampling draws from the seeded generator: the same seed
    gives the same ids, all inside the vocabulary (the reference's draws
    come from jax.random, so only greedy tokens are compared with it)."""
    _, tcfg, _, tp = _setup("granite-8b")
    prompts = np.random.default_rng(2).integers(0, tcfg.vocab_size, (3, 5))
    runs = [tengine.generate(tp, tcfg, prompts, max_new=6, temperature=1.5,
                             seed=s, device="cpu") for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < tcfg.vocab_size


def _requests(module, prompts, max_new):
    return [module.Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("arch", ["granite-8b", MOE, MLA, HYBRID, SSM, VLM])
def test_continuous_batcher_matches_jax_and_generate(arch):
    """3 requests on 2 slots (slot reuse), the middle prompt over the
    lowered threshold (its prefill takes the flash wrapper, or MLA's
    chunked_attention; the ssm family neither): the same tokens as the
    reference's batcher and as the port's generate (the vlm family's
    text-only path)."""
    jcfg, tcfg, jp, tp = _setup(arch, attn_chunk_threshold=16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (6, 24, 9)]
    max_new = 4
    jeng = jengine.ContinuousBatcher(jp, jcfg, num_slots=2, max_len=32,
                                     eos_id=-1)
    teng = tengine.ContinuousBatcher(tp, tcfg, num_slots=2, max_len=32,
                                     eos_id=-1, device="cpu")
    for r in _requests(jengine, prompts, max_new):
        jeng.submit(r)
    for r in _requests(tengine, prompts, max_new):
        teng.submit(r)
    calls = []
    real = tlayers.flash_attention
    tlayers.flash_attention = lambda *a, **kw: calls.append(1) or real(
        *a, **kw)
    tlayers.reset_call_counts()
    try:
        tdone = teng.run_to_completion()
    finally:
        tlayers.flash_attention = real
    jdone = jeng.run_to_completion()
    assert sorted(tdone) == sorted(jdone) == [0, 1, 2]
    # the 24-token prefill: every layer over the threshold, through the
    # flash wrapper (GQA, hybrid) or chunked_attention (MLA), never the
    # other; the ssm family through neither
    L = tcfg.num_layers
    want = {"mla": (0, L), "none": (0, 0)}.get(tcfg.attention, (L, 0))
    assert (len(calls), tlayers.CALL_COUNTS["chunked_attention"]) == want
    assert [n for n, _ in teng.timings["prefill"]] == [6, 24, 9]
    for rid, p in enumerate(prompts):
        assert tdone[rid].generated == jdone[rid].generated
        alone = tengine.generate(tp, tcfg, p[None], max_new, device="cpu")
        assert tdone[rid].generated == alone[0].tolist()


def test_batcher_slot_reuse_and_eviction():
    _, tcfg, _, tp = _setup("granite-8b")
    rng = np.random.default_rng(1)
    eng = tengine.ContinuousBatcher(tp, tcfg, num_slots=1, max_len=24,
                                    eos_id=-1, device="cpu")
    for rid in range(3):
        eng.submit(tengine.Request(
            rid=rid, prompt=rng.integers(0, tcfg.vocab_size, 4).astype(
                np.int32), max_new=3))
    done = eng.run_to_completion()
    assert len(done) == 3
    assert all(len(r.generated) == 3 for r in done.values())
    assert eng.cache["length"].tolist() == [0]
    with pytest.raises(ValueError, match="prompt of 25 tokens"):
        eng.submit(tengine.Request(rid=9, prompt=np.zeros(25, np.int32),
                                   max_new=1))


def test_serve_cli_on_cpu(capsys):
    assert tserve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "2",
                        "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out and "tokens/s" in out


def test_serve_cli_moe_on_cpu(capsys):
    assert tserve.main(["--arch", MOE, "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "2",
                        "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "moonshot-smoke on cpu: served 3 requests, 9 tokens" in out


@pytest.mark.parametrize("arch,name", [(HYBRID, "hymba-smoke"),
                                       (SSM, "rwkv6-smoke")])
def test_serve_cli_hybrid_and_ssm_on_cpu(capsys, arch, name):
    assert tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "2",
                        "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert f"{name} on cpu: served 3 requests, 9 tokens" in out


# ---------------------------------------------------------------------------
# the carried states: slot reuse, a planted fault, bf16 tokens
# ---------------------------------------------------------------------------

def _states(stacks):
    return {(name, key): t for name, st in stacks.items()
            for key, t in st.items() if key in tdec.STATE_KEYS}


@pytest.mark.parametrize("arch", [HYBRID, SSM])
def test_slot_reuse_leaks_no_state(arch):
    """Serve A in the one slot and evict it (its states stay: eviction
    zeroes the length only), then admit B into the same slot: B's
    admission writes every state whole, equal to B's own prefill, and B's
    tokens equal B served alone."""
    _, tcfg, _, tp = _setup(arch)
    rng = np.random.default_rng(21)
    a, b = (rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
            for n in (11, 7))
    eng = tengine.ContinuousBatcher(tp, tcfg, num_slots=1, max_len=24,
                                    eos_id=-1, device="cpu")
    eng.submit(tengine.Request(rid=0, prompt=a, max_new=5))
    eng.run_to_completion()
    assert eng.cache["length"].tolist() == [0]
    left = _states(tdec.kv_stacks(eng.cache))
    assert left and all(bool(t.abs().sum() > 0) for t in left.values())
    eng.submit(tengine.Request(rid=1, prompt=b, max_new=5))
    eng._admit()
    fresh, _ = tdec.prefill(tp, torch.as_tensor(b[None]), tcfg, max_len=24)
    want = _states(tdec.kv_stacks(fresh))
    got = _states(tdec.kv_stacks(eng.cache))
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert torch.equal(t, want[key]), key
    done = eng.run_to_completion()
    for rid, p in enumerate((a, b)):
        alone = tengine.generate(tp, tcfg, p[None], 5, device="cpu")
        assert done[rid].generated == alone[0].tolist()


def test_planted_conv_state_off_by_one_leaves_the_forward(monkeypatch):
    """Hymba's prefill hands decode the last K-1 pre-conv inputs: decode
    then meets the forward (``test_port_decode_matches_forward``'s bound),
    and the same state one token late leaves it by far."""
    _, tcfg, _, tp = _setup(HYBRID)
    tokens = torch.as_tensor(
        np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 16)))
    h, _ = tlm.forward(tp, tokens, tcfg)

    def decode_err():
        cache, _ = tdec.prefill(tp, tokens[:, :-1], tcfg, max_len=20)
        cache, h_dec = tdec.decode_step(tp, cache, tokens[:, -1], tcfg)
        return float((h_dec - h[:, -1]).abs().max())

    assert decode_err() < 2e-3
    real = tssm.mamba_conv_state
    monkeypatch.setattr(tssm, "mamba_conv_state",
                        lambda p, x, cfg: real(p, x[:, :-1], cfg))
    assert decode_err() > 10 * 2e-3


@pytest.mark.parametrize("arch", [HYBRID, SSM])
def test_bf16_greedy_tokens_match_jax(arch):
    """bf16 weights on both sides (the serving dtype): the same greedy
    tokens from ``generate``, a prompt over the lowered threshold (the
    hybrid family's prefill through the flash wrapper's plain version)."""
    rep = dict(attn_chunk_threshold=8)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **rep)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **rep)
    jp = jlm.init_params(jax.random.key(3), jcfg, dtype=jnp.bfloat16)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    prompts = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 12))
    want = jengine.generate(jp, jcfg, jnp.asarray(prompts), max_new=6)
    got = tengine.generate(tp, tcfg, prompts, max_new=6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# weights and devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip_exactly(dtype):
    jcfg = jconfigs.get_smoke_config("starcoder2-15b")
    jp = jlm.init_params(jax.random.key(1), jcfg, dtype=getattr(jnp, dtype))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree_util.tree_leaves(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for path, leaf in jl:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == getattr(torch, dtype) and t.shape == leaf.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_round_trip_exactly(dtype):
    """A moonshot tree (dense_blocks, moe_blocks with the expert stacks,
    the shared experts) converts leaf for leaf; the router stays f32."""
    jcfg = jconfigs.get_smoke_config(MOE)
    jp = jlm.init_params(jax.random.key(2), jcfg, dtype=getattr(jnp, dtype))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree_util.tree_leaves(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert tp["moe_blocks"]["moe"]["router"].dtype == torch.float32
    for path, leaf in jl:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == _torch_dtype(leaf.dtype), path
        assert t.shape == leaf.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


@pytest.mark.parametrize("arch", [HYBRID, SSM])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_and_ssm_params_round_trip_exactly(arch, dtype):
    """A hymba tree (attention, the Mamba stacks and the two output norms
    beside the FFN) and an rwkv6 tree (``ln1``, ``ln2``, ``rwkv``)
    convert leaf for leaf."""
    jcfg = jconfigs.get_smoke_config(arch)
    jp = jlm.init_params(jax.random.key(4), jcfg, dtype=getattr(jnp, dtype))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree_util.tree_leaves(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    want = {HYBRID: "mamba", SSM: "rwkv"}[arch]
    assert want in tp["blocks"]
    for path, leaf in jl:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == _torch_dtype(leaf.dtype), path
        assert t.shape == leaf.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


def _torch_dtype(jax_dtype):
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[np.dtype(jax_dtype).name]


@pytest.mark.parametrize("arch", PORTED)
def test_init_params_layout_matches_reference(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    want = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), jcfg))
    got = tlm.init_params(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat) == len(jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for path, leaf in flat.items():
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert t.dtype == _torch_dtype(leaf.dtype), path
        assert torch.isfinite(t.float()).all()


def test_lm_entry_points_need_a_card(monkeypatch):
    """device=None means the card: without one every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg, jp, tp = _setup("granite-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_params(torch.Generator(), tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdec.init_cache(tcfg, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.ContinuousBatcher(tp, tcfg, num_slots=2, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.generate(tp, tcfg, np.zeros((1, 4), np.int32), 2)
    with pytest.raises(NotImplementedError, match="ParallelContext"):
        tlm.forward(tp, torch.zeros((1, 4), dtype=torch.int64), tcfg,
                    ctx=object())
