"""The port's audio family (whisper: the encoder over frame embeddings,
cross attention, ``generate(frames=)``) and vlm family (internvl2: the
patch projector) against the JAX reference, on the CPU.

The forward, prefill and decode of both families are in
``tests/test_torch_lm.py``'s arch parametrisations; this file holds what
is theirs alone.  The same numpy inputs, from ``np.random.default_rng``,
go through ``repro`` and ``repro_torch``; parameters come from the
reference's ``lm.init_params`` through ``lm_params_from_numpy``.

Tolerances (as ``tests/test_torch_lm.py``'s):
  * cross attention and the projector: ``1e-4`` (f32 matmuls in other
    orders); the projector's two planted faults, the exact erf GELU and
    the unbiased variance, each move its output by more;
  * greedy tokens: equal, in f32 and in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode as jdec
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import decode as tdec
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as tengine
from repro_torch.utils.convert import lm_params_from_numpy

HIDDEN = dict(rtol=1e-4, atol=1e-4)
AUDIO = "whisper-base"
VLM = "internvl2-2b"
# every parameter of the reference's init_params tree at CONFIG
# (param_count() leaves out cross attention, enc_pos, the norms and the
# projector)
TREE_PARAMS = {AUDIO: 97_950_720, VLM: 1_895_440_384}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _setup(arch, dtype="float32", seed=0, **replace):
    """(jax cfg, port cfg, jax params, port params) of the smoke config,
    the same weights on both sides."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **replace)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **replace)
    jp = jlm.init_params(jax.random.key(seed), jcfg,
                         dtype=getattr(jnp, dtype))
    return jcfg, tcfg, jp, lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


def _patches(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_param_trees_count_the_reference(arch):
    """At CONFIG the port's tree holds every parameter of the reference's
    (counted on the meta device, nothing allocated); ``param_count`` is
    the reference's own, which counts less."""
    cfg = tconfigs.get_config(arch)
    want = jax.eval_shape(lambda: jlm.init_params(
        jax.random.key(0), jconfigs.get_config(arch)))
    n_ref = sum(int(np.prod(leaf.shape))
                for leaf in jax.tree_util.tree_leaves(want))
    got = tlm.init_params(None, cfg, device="meta")
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(got))
    assert n == n_ref == TREE_PARAMS[arch]
    assert cfg.param_count() == jconfigs.get_config(arch).param_count() < n


@pytest.mark.parametrize("arch", [AUDIO, VLM])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_exactly(arch, dtype):
    """The reference's tree (whisper's ``enc_blocks``, ``enc_pos``,
    ``enc_norm`` and the decoder's ``cross``/``ln_cross``; internvl2's
    ``projector``) converts leaf for leaf."""
    _, _, jp, tp = _setup(arch, dtype, seed=5)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree_util.tree_leaves(tp))
    new = {AUDIO: ("enc_blocks", "enc_pos", "enc_norm"),
           VLM: ("projector",)}[arch]
    assert set(new) <= set(tp)
    if arch == AUDIO:
        assert {"cross", "ln_cross"} <= set(tp["blocks"])
        assert "cross" not in tp["enc_blocks"]
    for path, leaf in jl:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == getattr(torch, dtype), path
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


# ---------------------------------------------------------------------------
# the vlm projector
# ---------------------------------------------------------------------------

class _Prefix(Exception):
    """Carries the reference's first layer input out of its forward."""


def _reference_projection(monkeypatch, jp, jcfg, patches):
    """The reference's projector output: the first ``vision_tokens`` rows
    of the sequence its forward hands to the layer stack (its projector
    is inline in ``lm.forward``)."""
    def stop(stack, h, body, **kw):
        raise _Prefix(h)

    tokens = jnp.zeros((patches.shape[0], 3), jnp.int32)
    with monkeypatch.context() as m:
        m.setattr(jlm, "_scan_stack", stop)
        with pytest.raises(_Prefix) as got:
            jlm.forward(jp, tokens, jcfg, patches=jnp.asarray(patches))
    return np.asarray(got.value.args[0][:, :jcfg.vision_tokens])


@pytest.mark.parametrize("fault", [None, "exact_gelu", "unbiased_var"])
def test_projector_matches_jax_and_catches_planted_faults(monkeypatch,
                                                          fault):
    """The projector alone against the reference's formula within
    ``1e-4``; with the exact erf GELU (torch's default) or the unbiased
    variance (``torch.var``'s default) planted in its place, the output
    leaves the tolerance."""
    jcfg, tcfg, jp, tp = _setup(VLM)
    patches = _patches(jcfg, 2, 3)
    want = _reference_projection(monkeypatch, jp, jcfg, patches)
    if fault == "exact_gelu":
        gelu = torch.nn.functional.gelu
        monkeypatch.setattr(tlm.F, "gelu", lambda x, approximate: gelu(x))
    elif fault == "unbiased_var":
        var = torch.Tensor.var
        monkeypatch.setattr(torch.Tensor, "var",
                            lambda x, *a, correction=0, **kw: var(
                                x, *a, correction=1, **kw))
    got = _np(tlm.project_patches(tp["projector"], torch.as_tensor(patches),
                                  torch.float32))
    assert got.shape == (2, jcfg.vision_tokens, jcfg.d_model)
    if fault is None:
        np.testing.assert_allclose(got, want, **HIDDEN)
    else:
        assert not np.allclose(got, want, **HIDDEN), fault


def test_forward_needs_its_inputs_and_vlm_prefill_refuses_patches():
    """The vlm forward without patches and the audio forward without
    frames raise; prefill with patches raises ``NotImplementedError`` in
    the port as in the reference (image-prefixed decode is in neither),
    and the text-only vlm prefill runs."""
    jcfg, tcfg, jp, tp = _setup(VLM)
    tokens = np.zeros((1, 4), np.int64)
    patches = _patches(jcfg, 1, 1)
    with pytest.raises(ValueError, match="patches="):
        tlm.forward(tp, torch.as_tensor(tokens), tcfg)
    with pytest.raises(NotImplementedError):
        jdec.prefill(jp, jnp.asarray(tokens), jcfg,
                     patches=jnp.asarray(patches))
    with pytest.raises(NotImplementedError, match="patches"):
        tdec.prefill(tp, torch.as_tensor(tokens), tcfg,
                     patches=torch.as_tensor(patches))
    cache, h = tdec.prefill(tp, torch.as_tensor(tokens), tcfg)
    assert tuple(h.shape) == (1, 4, tcfg.d_model)
    assert "enc" not in cache
    _, acfg, _, ap = _setup(AUDIO)
    with pytest.raises(ValueError, match="frames="):
        tlm.forward(ap, torch.as_tensor(tokens), acfg)
    with pytest.raises(ValueError, match="frames="):
        tdec.prefill(ap, torch.as_tensor(tokens), acfg)


# ---------------------------------------------------------------------------
# the audio family
# ---------------------------------------------------------------------------

def test_cross_attention_matches_jax():
    """q of S rows against S_enc keys, no mask, no rotation."""
    jcfg, tcfg, jp, tp = _setup(AUDIO)
    rng = np.random.default_rng(8)
    h = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["cross"])
    got = tlm.cross_attention(tlm.layer(tp["blocks"], 0)["cross"],
                              torch.as_tensor(h), torch.as_tensor(enc), tcfg)
    want = jlm.cross_attention(jl, jnp.asarray(h), jnp.asarray(enc), jcfg)
    np.testing.assert_allclose(_np(got), _np(want), **HIDDEN)


def test_init_cache_holds_enc_batch_first():
    """The audio cache adds ``enc`` (B, encoder_seq_len, d) in the cache's
    dtype beside the layer stacks, and ``kv_stacks`` leaves it out."""
    cfg = tconfigs.get_smoke_config(AUDIO)
    cache = tdec.init_cache(cfg, 3, 10, device="cpu")
    assert sorted(cache) == ["blocks", "enc", "length"]
    assert tuple(cache["enc"].shape) == (3, cfg.encoder_seq_len,
                                         cfg.d_model)
    assert cache["enc"].dtype == torch.bfloat16
    assert sorted(tdec.kv_stacks(cache)) == ["blocks"]
    assert tuple(cache["blocks"]["k"].shape) == (
        cfg.num_layers, 3, 10, cfg.num_kv_heads, cfg.head_dim)


def test_planted_rope_in_audio_decode_leaves_the_reference(monkeypatch):
    """Audio rotates nothing: decode matches the reference, and the same
    decode step with rotary positions planted in its self attention
    leaves it by far (a shape test would not see it)."""
    jcfg, tcfg, jp, tp = _setup(AUDIO)
    tokens = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 12))
    frames = _frames(jcfg, 2, 10)
    jcache, _ = jdec.prefill(jp, jnp.asarray(tokens[:, :-1]), jcfg,
                             max_len=16, frames=jnp.asarray(frames))
    _, want = jdec.decode_step(jp, jcache, jnp.asarray(tokens[:, -1]), jcfg)

    def decoded():
        cache, _ = tdec.prefill(tp, torch.as_tensor(tokens[:, :-1]), tcfg,
                                max_len=16, frames=torch.as_tensor(frames))
        _, h = tdec.decode_step(tp, cache, torch.as_tensor(tokens[:, -1]),
                                tcfg)
        return _np(h)

    np.testing.assert_allclose(decoded(), _np(want), **HIDDEN)
    real = tdec._gqa_qkv
    monkeypatch.setattr(tdec, "_gqa_qkv", lambda p, x, pos, cfg, rope=True:
                        real(p, x, pos, cfg, rope=True))
    assert np.abs(decoded() - _np(want)).max() > 100 * HIDDEN["atol"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("threshold", [None, 16])
def test_generate_with_frames_matches_jax(dtype, threshold):
    """``generate(frames=)``: the same greedy tokens as the reference's,
    in f32 and in the serving dtype bf16, at the default threshold and at
    16, where the 32-frame encoder takes the flash wrapper's plain
    version (the reference's ``chunked_attention``)."""
    rep = {} if threshold is None else dict(attn_chunk_threshold=threshold)
    jcfg, tcfg, jp, tp = _setup(AUDIO, dtype, seed=3, **rep)
    prompts = np.random.default_rng(11).integers(0, jcfg.vocab_size, (3, 4))
    frames = _frames(jcfg, 3, 12)
    want = jengine.generate(jp, jcfg, jnp.asarray(prompts), max_new=6,
                            frames=jnp.asarray(frames))
    got = tengine.generate(tp, tcfg, prompts, max_new=6, frames=frames,
                           device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batcher_refuses_audio():
    """The reference's batcher admits without frames and fails inside
    prefill; the port's refuses the audio family up front, naming the
    entry point that serves it."""
    _, tcfg, _, tp = _setup(AUDIO)
    with pytest.raises(ValueError, match=r"generate\(frames=\)"):
        tengine.ContinuousBatcher(tp, tcfg, num_slots=2, max_len=16,
                                  device="cpu")


@pytest.mark.parametrize("arch,what", [(AUDIO, "frame inputs"),
                                       (VLM, "patch inputs")])
def test_serve_cli_refuses_audio_and_vlm(arch, what):
    with pytest.raises(SystemExit, match=what):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
