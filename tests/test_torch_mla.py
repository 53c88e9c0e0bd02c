"""The port's MLA (deepseek-v3) serving path against the JAX reference,
on the CPU, on the deepseek ``smoke()`` config (2 layers: 1 dense, 1 MoE
of 8 experts top-2; 4 heads, q_lora 32, kv_lora 16, nope 16 + rope 8, v
16).

The same numpy inputs, from ``np.random.default_rng(seed)``, go through
``repro`` and ``repro_torch``; parameters come from the reference's
``lm.init_params`` (in the case's dtype) through
``lm_params_from_numpy``.

Tolerances, as relative L2 (``|got - want| / |want|``):
  * float32: ``1e-5`` everywhere (the same f32 arithmetic in other
    summation orders, through at most 2 layers of width <= 128);
  * bfloat16: ``2e-2`` (every product and sum of both packages rounds to
    bf16, about 2**-9 relative each, in other orders; a few dozen of them
    compound to about 1e-2 through 2 layers).  Through the MoE layer the
    two packages' hidden states differ by that much, so a token whose
    router logits tie within ``NEAR_TIE`` (the k-th largest minus the
    next, read from the port's router) may choose other experts on the
    two sides and is exempt; every other token is held to the bound, and
    every token past the bound must be such a near-tie;
  * integers (greedy tokens, cache lengths, ``moe_dropped``): equal.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode as jdec
from repro.models import lm as jlm
from repro.models import mla as jmla
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.serving import engine as tengine
from repro_torch.utils.convert import lm_params_from_numpy

ARCH = "deepseek-v3-671b"
REL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]
# router logits of N(0, 1) scale; the packages' bf16 hidden states differ
# by ~1e-2 relative, so their logits by about as much
NEAR_TIE = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= REL[dtype], f"{what}: relative L2 {rel:.3e} > {REL[dtype]}"


@contextlib.contextmanager
def _router_gaps():
    """Record, per call of the port's router, each row's k-th largest
    logit minus the (k+1)-th."""
    gaps = []
    real = tmoe.router_topk

    def recording(x, router_w, k):
        top = torch.topk(x.float() @ router_w, k + 1, dim=-1).values
        gaps.append(top[:, k - 1] - top[:, k])
        return real(x, router_w, k)
    tmoe.router_topk = recording
    try:
        yield gaps
    finally:
        tmoe.router_topk = real


def _close_tokens(got, want, dtype, gap, what=""):
    """Per-token rows (..., d) after the MoE layer, ``gap`` its router's
    per-token gap: in f32 all held to the bound; in bf16 (module
    docstring) the tokens off a near-tie held to it, and every token past
    it a near-tie."""
    if dtype == "float32":
        return _close(got, want, dtype, what)
    got, want = _np(got), _np(want)
    d = got.shape[-1]
    got, want = got.reshape(-1, d), want.reshape(-1, d)
    tie = _np(gap) < NEAR_TIE
    assert tie.shape == (got.shape[0],) and tie.mean() < 0.1, what
    per = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert tie[per > REL[dtype]].all(), f"{what}: {per[~tie].max():.3e}"
    _close(got[~tie], want[~tie], dtype, what)


def _pair(a, dtype):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


_PARAMS = {}


def _setup(dtype="float32", **replace):
    """(jax cfg, port cfg, jax params, port params): the deepseek smoke
    config in ``dtype``, the same weights on both sides."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=dtype,
                               **replace)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=dtype,
                               **replace)
    if dtype not in _PARAMS:
        jp = jlm.init_params(jax.random.key(0), jcfg,
                             dtype=getattr(jnp, dtype))
        _PARAMS[dtype] = (jp, lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return (jcfg, tcfg) + _PARAMS[dtype]


def _layer0(jp, tp, stack="dense_blocks"):
    return (jax.tree_util.tree_map(lambda a: a[0], jp[stack]["attn"]),
            tlm.layer(tp[stack], 0)["attn"])


def _hidden(jcfg, dtype, B, S, seed):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return _pair(x, dtype)


# ---------------------------------------------------------------------------
# the module's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_project_q_and_latent_kv_match_jax(dtype):
    jcfg, tcfg, jp, tp = _setup(dtype)
    ja, ta = _layer0(jp, tp)
    jx, tx = _hidden(jcfg, dtype, 2, 7, 1)
    pos = np.random.default_rng(2).integers(0, 3000, (2, 7))
    jpos, tpos = jnp.asarray(pos), torch.as_tensor(pos)
    for name, jf, tf in (("_project_q", jmla._project_q, tmla._project_q),
                         ("latent_kv", jmla.latent_kv, tmla.latent_kv)):
        want = jf(ja, jx, jcfg, jpos)
        got = tf(ta, tx, tcfg, tpos)
        for g, w, part in zip(got, want, ("first", "second")):
            assert g.dtype == tx.dtype
            _close(g, w, dtype, f"{name} {part}")
    c_kv, k_rope = tmla.latent_kv(ta, tx, tcfg, tpos)
    m = tcfg.mla
    assert tuple(c_kv.shape) == (2, 7, m.kv_lora_rank)
    assert tuple(k_rope.shape) == (2, 7, m.qk_rope_head_dim)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("threshold,S", [(8192, 12), (16, 40)])
def test_mla_attention_matches_jax(dtype, causal, threshold, S):
    """Both branches: the two f32 einsums at or under the threshold, and
    over it the concatenated q/k at hd 24 against v at hd 16, which the
    port's dispatch sends to chunked_attention by shape (never to the
    flash wrapper)."""
    jcfg, tcfg, jp, tp = _setup(dtype, attn_chunk_threshold=threshold)
    ja, ta = _layer0(jp, tp)
    jx, tx = _hidden(jcfg, dtype, 2, S, 3)
    pos = np.tile(np.arange(S), (2, 1))
    flash = []
    real = tlayers.flash_attention
    tlayers.flash_attention = lambda *a, **kw: flash.append(1) or real(
        *a, **kw)
    tlayers.reset_call_counts()
    try:
        out, (c_kv, k_rope) = tmla.mla_attention(
            ta, tx, torch.as_tensor(pos), tcfg, causal=causal)
    finally:
        tlayers.flash_attention = real
    wout, (wc, wk) = jmla.mla_attention(ja, jx, jnp.asarray(pos), jcfg,
                                        causal=causal)
    assert out.dtype == tx.dtype
    _close(out, wout, dtype, "out")
    _close(c_kv, wc, dtype, "c_kv")
    _close(k_rope, wk, dtype, "k_rope")
    assert flash == []
    assert tlayers.CALL_COUNTS["chunked_attention"] == int(S > threshold)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_offset", [0, 8])
def test_mla_decode_partial_and_output_match_jax(dtype, kv_offset):
    """The absorbed decode: the latent flash triple, its combine and the
    output projection, per-sample lengths (one slot at the cache's end,
    one shorter), the query roped at length - 1."""
    jcfg, tcfg, jp, tp = _setup(dtype)
    ja, ta = _layer0(jp, tp)
    m = jcfg.mla
    rng = np.random.default_rng(4)
    B, Sc = 2, 20
    jx, tx = _hidden(jcfg, dtype, B, 1, 5)
    (jc, tc), (jr, tr) = (_pair(rng.standard_normal((B, Sc, w)).astype(
        np.float32), dtype) for w in (m.kv_lora_rank, m.qk_rope_head_dim))
    length = np.array([[Sc + kv_offset], [11]], np.int32)
    want = jmla.mla_decode_partial(ja, jx, jcfg, jc, jr, jnp.asarray(length),
                                   kv_offset=kv_offset)
    got = tmla.mla_decode_partial(ta, tx, tcfg, tc, tr,
                                  torch.as_tensor(length),
                                  kv_offset=kv_offset)
    for g, w, name in zip(got, want, ("ctx", "m", "l")):
        assert g.dtype == torch.float32
        _close(g, w, dtype, name)
    jctx = jlm.layers.combine_decode_partials(*want)
    tctx = tlayers.combine_decode_partials(*got)
    _close(tctx, jctx, dtype, "combined")
    out = tmla.mla_decode_output(ta, tctx, tx.dtype)
    assert out.dtype == tx.dtype and tuple(out.shape) == (B, 1, tcfg.d_model)
    _close(out, jmla.mla_decode_output(ja, jctx, jx.dtype), dtype, "output")


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("threshold,S", [(8192, 16), (16, 40)])
def test_forward_matches_jax(dtype, threshold, S):
    jcfg, tcfg, jp, tp = _setup(dtype, attn_chunk_threshold=threshold)
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, S))
    tlayers.reset_call_counts()
    with _router_gaps() as gaps:
        got, aux = tlm.forward(tp, torch.as_tensor(tokens), tcfg)
    want, jaux = jlm.forward(jp, jnp.asarray(tokens), jcfg)
    assert got.dtype == getattr(torch, dtype) and len(gaps) == 1
    _close_tokens(got, want, dtype, gaps[0], "hidden")
    _close_tokens(tlm.lm_logits(tp, got, tcfg),
                  jlm.lm_logits(jp, want, jcfg, None), dtype, gaps[0],
                  "logits")
    assert sorted(aux) == sorted(jaux)
    np.testing.assert_allclose(float(aux["moe_aux"]), float(jaux["moe_aux"]),
                               rtol=1e-6 if dtype == "float32" else 1e-2)
    assert int(aux["moe_dropped"]) == int(jaux["moe_dropped"]) == 0
    assert tlayers.CALL_COUNTS["chunked_attention"] == (
        jcfg.num_layers if S > threshold else 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("threshold", [8192, 8])
def test_prefill_and_decode_step_match_jax(dtype, threshold):
    """Prefill into a longer cache, then two decode steps at per-sample
    lengths: the hidden states and every stack of the latent cache."""
    jcfg, tcfg, jp, tp = _setup(dtype, attn_chunk_threshold=threshold)
    B, S = 2, 14
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                               (B, S + 2))
    jcache, jh = jdec.prefill(jp, jnp.asarray(tokens[:, :S]), jcfg,
                              max_len=S + 4)
    with _router_gaps() as gaps:
        tcache, th = tdec.prefill(tp, torch.as_tensor(tokens[:, :S]), tcfg,
                                  max_len=S + 4)
    _close_tokens(th, jh, dtype, gaps[0], "prefill hidden")
    for step in range(2):
        tok = tokens[:, S + step]
        jcache, jh = jdec.decode_step(jp, jcache, jnp.asarray(tok), jcfg)
        with _router_gaps() as gaps:
            tcache, th = tdec.decode_step(tp, tcache, torch.as_tensor(tok),
                                          tcfg)
        _close_tokens(th, jh, dtype, gaps[0], f"decode step {step} hidden")
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["length"]))
    stacks = tdec.kv_stacks(tcache)
    assert sorted(stacks) == sorted(k for k in jcache if k != "length")
    for name, st in stacks.items():
        assert sorted(st) == sorted(jcache[name]) == ["c_kv", "k_rope"]
        for key, t in st.items():
            assert t.dtype == getattr(torch, dtype)
            assert tuple(t.shape) == jcache[name][key].shape
            _close(t, jcache[name][key], dtype, f"{name}.{key}")


def test_init_cache_holds_the_latent_rows():
    """The latent cache's shapes, dtype and bytes: at deepseek's full
    width with 5 layers, 2 slots x 16,416 positions x 5 layers x (512 +
    64) x 2 bytes = 189,112,320 B (allocated on the meta device)."""
    cfg = dataclasses.replace(tconfigs.get_config(ARCH), num_layers=5)
    cache = tdec.init_cache(cfg, 2, 16_416, device="meta")
    stacks = tdec.kv_stacks(cache)
    assert sorted(stacks) == ["dense_blocks", "moe_blocks"]
    assert tuple(stacks["dense_blocks"]["c_kv"].shape) == (3, 2, 16_416, 512)
    assert tuple(stacks["moe_blocks"]["k_rope"].shape) == (2, 2, 16_416, 64)
    nbytes = sum(t.numel() * t.element_size()
                 for st in stacks.values() for t in st.values())
    assert nbytes == 189_112_320
    assert all(t.dtype == torch.bfloat16
               for st in stacks.values() for t in st.values())


@pytest.mark.parametrize("threshold", [8192, 16])
def test_port_decode_matches_forward(threshold):
    """The port's own prefill + decode_step reproduce its forward's last
    hidden state (``tests/test_models.py``'s check), with the query and
    the new key at the right positions: a rope off by one moves the
    result far past the bound."""
    _, tcfg, _, tp = _setup("float32", attn_chunk_threshold=threshold)
    S = 40
    tokens = torch.as_tensor(
        np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, S)))
    h, _ = tlm.forward(tp, tokens, tcfg)
    cache, _ = tdec.prefill(tp, tokens[:, :-1], tcfg, max_len=S + 4)
    cache, h_dec = tdec.decode_step(tp, cache, tokens[:, -1], tcfg)
    assert float((h_dec - h[:, -1]).abs().max()) < 2e-5
    assert cache["length"].tolist() == [S, S]


def test_decode_rope_positions_are_the_references():
    """Shifting the decode step's query position by one (the prefill left
    as it is) breaks decode against forward: the check above can see an
    off-by-one."""
    _, tcfg, _, tp = _setup("float32")
    tokens = torch.as_tensor(
        np.random.default_rng(9).integers(0, tcfg.vocab_size, (1, 12)))
    h, _ = tlm.forward(tp, tokens, tcfg)
    cache, _ = tdec.prefill(tp, tokens[:, :-1], tcfg, max_len=12)
    real = tmla._project_q
    tmla._project_q = lambda p, x, cfg, pos: real(p, x, cfg, pos + 1)
    try:
        cache, h_dec = tdec.decode_step(tp, cache, tokens[:, -1], tcfg)
    finally:
        tmla._project_q = real
    assert float((h_dec - h[:, -1]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_generate_matches_jax():
    jcfg, tcfg, jp, tp = _setup("float32")
    prompts = np.random.default_rng(10).integers(0, jcfg.vocab_size, (2, 7))
    want = jengine.generate(jp, jcfg, jnp.asarray(prompts), max_new=5)
    got = tengine.generate(tp, tcfg, prompts, max_new=5, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_continuous_batcher_matches_jax_and_generate():
    """3 requests on 2 slots (slot reuse), the middle prompt over the
    lowered threshold (its prefill takes chunked_attention in both
    layers): the same greedy tokens as the reference's batcher and as the
    port's generate, the latent cache written through the slot views."""
    jcfg, tcfg, jp, tp = _setup("float32", attn_chunk_threshold=16)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (6, 24, 9)]
    max_new = 4
    jeng = jengine.ContinuousBatcher(jp, jcfg, num_slots=2, max_len=32,
                                     eos_id=-1)
    teng = tengine.ContinuousBatcher(tp, tcfg, num_slots=2, max_len=32,
                                     eos_id=-1, device="cpu")
    assert sorted(teng.cache["moe_blocks"]) == ["c_kv", "k_rope"]
    for i, p in enumerate(prompts):
        jeng.submit(jengine.Request(rid=i, prompt=p, max_new=max_new))
        teng.submit(tengine.Request(rid=i, prompt=p, max_new=max_new))
    tlayers.reset_call_counts()
    tdone = teng.run_to_completion()
    jdone = jeng.run_to_completion()
    assert sorted(tdone) == sorted(jdone) == [0, 1, 2]
    assert tlayers.CALL_COUNTS["chunked_attention"] == tcfg.num_layers
    for rid, p in enumerate(prompts):
        assert tdone[rid].generated == jdone[rid].generated
        alone = tengine.generate(tp, tcfg, p[None], max_new, device="cpu")
        assert tdone[rid].generated == alone[0].tolist()


def test_serve_cli_on_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "2",
                        "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "deepseek-smoke on cpu: served 3 requests, 9 tokens" in out


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_params_round_trip_exactly(dtype):
    """The MLA tree converts leaf for leaf: the 4-D ``w_uk``/``w_uv``,
    the f32 router, the ``mtp`` subtree."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    jp = jlm.init_params(jax.random.key(3), jcfg, dtype=getattr(jnp, dtype))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree_util.tree_leaves(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    m = jcfg.mla
    assert tuple(tp["moe_blocks"]["attn"]["w_uk"].shape) == (
        1, m.kv_lora_rank, jcfg.num_heads, m.qk_nope_head_dim)
    assert tp["moe_blocks"]["moe"]["router"].dtype == torch.float32
    assert sorted(tp["mtp"]) == ["block", "norm_e", "norm_h", "proj"]
    for path, leaf in jl:
        t = tp
        for key in path:
            t = t[key.key]
        want = torch.float32 if np.dtype(leaf.dtype).name == "float32" \
            else torch.bfloat16
        assert t.dtype == want and t.shape == leaf.shape, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_init_params_layout_and_count():
    """The port's own draw has the reference's tree (the MTP head
    included), and its parameters minus norms and MTP are
    ``param_count()``."""
    cfg = tconfigs.get_smoke_config(ARCH)
    want = jax.eval_shape(lambda: jlm.init_params(
        jax.random.key(0), jconfigs.get_smoke_config(ARCH)))
    got = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, leaf in flat.items():
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
    def leaves(tree):
        return [t for v in tree.values()
                for t in (leaves(v) if isinstance(v, dict) else [v])]
    # the stacks' 2-D leaves are their norms (ln1, ln2, q_norm, kv_norm)
    norms = sum(t.numel() for name in ("dense_blocks", "moe_blocks")
                for t in leaves(got[name]) if t.dim() == 2)
    norms += got["final_norm"]["w"].numel()
    mtp = sum(t.numel() for t in leaves(got["mtp"]))
    total = sum(t.numel() for t in leaves(got))
    assert total - norms - mtp == cfg.param_count()
