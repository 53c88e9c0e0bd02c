"""The LM zoo's dense, MoE, hybrid and ssm families: the counterpart of
``repro.models.lm``.

Llama-style GQA stacks (granite, starcoder2, yi, nemotron); the
mixture-of-experts family (``first_k_dense`` dense layers, then layers
whose FFN is ``models/moe.moe_ffn``) with GQA attention (moonshot) or
MLA (deepseek-v3, ``models/mla.py``); the hybrid family (hymba: GQA
attention and Mamba heads in parallel on the same normed input, a
sliding window on every layer but ``global_attn_layers``) and the ssm
family (rwkv6: RWKV-6 time and channel mix, no attention), both through
``models/ssm.py``: init, embedding, the full-sequence forward and the
logits head, with the reference's parameter layout -- per-layer tensors
STACKED on a leading layer axis (``blocks`` for the dense, hybrid and
ssm families; ``dense_blocks`` and ``moe_blocks`` for MoE; deepseek's
MTP head under ``mtp``), ``(in, out)`` weights applied as ``x @ w`` --
so a numpy copy of the reference's ``init_params`` converts without a
transpose (``utils/convert.lm_params_from_numpy``).  The layers run in a
Python loop (the reference scans them).

Single device only: ``ctx`` (the vocabulary through the row-wise sharded
embedding bag, GSPMD constraints, expert parallelism) must be None.  The
audio and vlm families (ROADMAP Queue 1 items 13.4-13.5) raise
``NotImplementedError``.  Serving ignores the MTP head, as the
reference does; its loss belongs to LM training (item 13.7).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import waiting_item
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, mla, ssm
from repro_torch.models import moe as moe_mod
from repro_torch.utils.device import resolve_device


def padded_vocab(cfg: ModelConfig, tp_size: int) -> int:
    """Rows of the embedding table: the vocabulary rounded up to a
    multiple of ``tp_size`` (row-wise sharding needs rows % tp == 0)."""
    V = cfg.vocab_size
    return -(-V // tp_size) * tp_size


# the (family, attention) pairs the port runs
PORTED = {("dense", "gqa"), ("moe", "gqa"), ("moe", "mla"),
          ("hybrid", "hybrid_parallel"), ("ssm", "none")}
# a window wider than any sequence: the global layers' (the reference's)
GLOBAL_WINDOW = 1 << 30


def _require_ported(cfg: ModelConfig) -> None:
    if (cfg.family, cfg.attention) not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / attention "
            f"{cfg.attention!r} waits for ROADMAP Queue 1 item "
            f"{waiting_item(cfg.family)}; the port runs the dense "
            f"family, the MoE family with GQA or MLA attention, the "
            f"hybrid family and the ssm family")


def _hymba_windows(cfg: ModelConfig) -> tuple:
    """Per-layer window of the hybrid family: ``cfg.window`` (or
    :data:`GLOBAL_WINDOW`), and :data:`GLOBAL_WINDOW` on
    ``global_attn_layers``."""
    return tuple(GLOBAL_WINDOW if i in cfg.global_attn_layers
                 else cfg.window or GLOBAL_WINDOW
                 for i in range(cfg.num_layers))


def block_stacks(cfg: ModelConfig):
    """The layer stacks in order, as ``(name, layers, windows)``, one
    window per layer: the dense family's ``blocks`` (``cfg.window``);
    the hybrid family's ``blocks`` (:func:`_hymba_windows`); the ssm
    family's ``blocks`` (no attention); MoE's ``dense_blocks`` (if
    ``first_k_dense``) then ``moe_blocks``, both without a window, as in
    the reference."""
    n = cfg.num_layers
    if cfg.family == "dense":
        return [("blocks", n, (cfg.window,) * n)]
    if cfg.family == "hybrid":
        return [("blocks", n, _hymba_windows(cfg))]
    if cfg.family == "ssm":
        return [("blocks", n, (None,) * n)]
    nk = cfg.first_k_dense
    return ([("dense_blocks", nk, (None,) * nk)] if nk else []) + [
        ("moe_blocks", n - nk, (None,) * (n - nk))]


def _require_local(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError(
            "the LM with a ParallelContext (vocabulary through the "
            "row-wise sharded embedding bag) is not ported yet (ROADMAP "
            "Queue 1 item 13); pass ctx=None")


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# ===========================================================================
# Init
# ===========================================================================

def _init_norm(n, d, cfg, dtype, device):
    p = {"w": torch.ones((n, d), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros((n, d), dtype=dtype, device=device)
    return p


def _init_gqa(gen, n, cfg: ModelConfig, dtype, device):
    d, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    init = layers.stacked_dense_init
    return {"wq": init(gen, n, d, H * hd, dtype=dtype, device=device),
            "wk": init(gen, n, d, KH * hd, dtype=dtype, device=device),
            "wv": init(gen, n, d, KH * hd, dtype=dtype, device=device),
            "wo": init(gen, n, H * hd, d, dtype=dtype, device=device)}


def _init_block_stack(gen, n, cfg: ModelConfig, dtype, device, *,
                      with_moe=False, with_mamba=False):
    """One stack of ``n`` layers: norms, attention (GQA or MLA), with
    ``with_mamba`` the Mamba heads and their output norms, then the FFN
    or (with ``with_moe``) the MoE block."""
    init_attn = mla.init_mla_params if cfg.attention == "mla" else _init_gqa
    d = cfg.d_model
    p: Dict[str, Any] = {
        "ln1": _init_norm(n, d, cfg, dtype, device),
        "ln2": _init_norm(n, d, cfg, dtype, device),
        "attn": init_attn(gen, n, cfg, dtype, device),
    }
    if with_mamba:
        p["mamba"] = ssm.init_mamba_params(gen, n, cfg, dtype, device)
        p["ln_attn_out"] = _init_norm(n, d, cfg, dtype, device)
        p["ln_mamba_out"] = _init_norm(n, d, cfg, dtype, device)
    if with_moe:
        p["moe"] = moe_mod.init_moe_params(gen, n, cfg, dtype, device)
    else:
        p["ffn"] = layers.init_ffn(gen, n, cfg.d_model, cfg.d_ff,
                                   gated=cfg.gated_ffn, dtype=dtype,
                                   device=device)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, *, tp_size: int = 1,
                dtype: Optional[torch.dtype] = None,
                device=None) -> Dict[str, Any]:
    """Random parameters on ``device`` (None: the card), drawn from
    ``gen`` (a generator on that device) one layer at a time:
    ``{"embed" (1, Vp, d), "final_norm", "head" (d, Vp) unless tied}``
    and the layer stacks of :func:`block_stacks`, each ``{"ln1", "ln2",
    "attn": {wq, wk, wv, wo}, "ffn": {up, down, gate}}`` with a leading
    layer axis (``"attn"`` from ``models/mla.init_mla_params`` for MLA;
    ``"moe"``, ``models/moe.init_moe_params``, in place of ``"ffn"`` in
    ``moe_blocks``; the hybrid family's ``blocks`` add ``"mamba"``
    (``models/ssm.init_mamba_params``), ``"ln_attn_out"`` and
    ``"ln_mamba_out"``; the ssm family's are ``{"ln1", "ln2", "rwkv"}``,
    ``models/ssm.init_rwkv_params``); with ``cfg.mtp_depth``, ``"mtp": {"proj" (2d, d),
    "norm_h", "norm_e", "block"}``, one dense layer, as the reference
    builds it.  The draws are ``torch.Generator``'s, not
    ``jax.random``'s: tests convert the reference's parameters
    instead."""
    _require_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    Vp, d = padded_vocab(cfg, tp_size), cfg.d_model
    embed = torch.empty((1, Vp, d), dtype=dtype, device=device)
    tmp = torch.empty((Vp, d), dtype=torch.float32, device=device)
    embed[0] = tmp.normal_(generator=gen).mul_(d ** -0.5)
    del tmp
    params: Dict[str, Any] = {"embed": embed,
                              "final_norm": _init_norm(1, d, cfg, dtype,
                                                       device)}
    if not cfg.tie_embeddings:
        params["head"] = layers.stacked_dense_init(
            gen, 1, d, Vp, dtype=dtype, device=device)[0]
    for name, n, _ in block_stacks(cfg):
        if cfg.family == "ssm":
            params[name] = {
                "ln1": _init_norm(n, d, cfg, dtype, device),
                "ln2": _init_norm(n, d, cfg, dtype, device),
                "rwkv": ssm.init_rwkv_params(gen, n, cfg, dtype, device)}
        else:
            params[name] = _init_block_stack(
                gen, n, cfg, dtype, device, with_moe=name == "moe_blocks",
                with_mamba=cfg.family == "hybrid")
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": layers.stacked_dense_init(gen, 1, 2 * d, d, dtype=dtype,
                                              device=device)[0],
            "norm_h": _init_norm(1, d, cfg, dtype, device),
            "norm_e": _init_norm(1, d, cfg, dtype, device),
            "block": _init_block_stack(gen, 1, cfg, dtype, device)}
    return params


def layer(stack: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked parameter (or cache) tree: views."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


# ===========================================================================
# Norms / attention blocks
# ===========================================================================

def _norm(h, p, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layers.layer_norm(h, p["w"], p["b"], cfg.norm_eps)
    return layers.rms_norm(h, p["w"], cfg.norm_eps)


def _gqa_qkv(p, h, positions, cfg: ModelConfig, *, rope=True):
    B, S, _ = h.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (h @ p["wk"]).reshape(B, S, KH, hd)
    v = (h @ p["wv"]).reshape(B, S, KH, hd)
    if rope:
        q = layers.apply_rope(q, positions, theta=cfg.rope_theta)
        k = layers.apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def gqa_attention(p, h, positions, cfg: ModelConfig, *, causal=True,
                  window=None, rope=True):
    """Full-sequence GQA.  Returns (out (B, S, d), (k, v) cache entries)."""
    B, S, _ = h.shape
    q, k, v = _gqa_qkv(p, h, positions, cfg, rope=rope)
    o = layers.attention(q, k, v, causal=causal, window=window,
                         chunk_threshold=cfg.attn_chunk_threshold)
    return o.reshape(B, S, -1) @ p["wo"], (k, v)


def _attention(p, x, positions, cfg: ModelConfig, *, window=None,
               causal=True):
    """The layer's attention, GQA or MLA.  Returns (out (B, S, d), the
    layer's cache entry): ``{"k", "v"}`` for GQA, ``{"c_kv", "k_rope"}``
    for MLA."""
    if cfg.attention == "mla":
        out, (c_kv, k_rope) = mla.mla_attention(p, x, positions, cfg,
                                                causal=causal)
        return out, {"c_kv": c_kv, "k_rope": k_rope}
    out, (k, v) = gqa_attention(p, x, positions, cfg, causal=causal,
                                window=window)
    return out, {"k": k, "v": v}


# ===========================================================================
# Embedding and head
# ===========================================================================

def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 ctx=None) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, d): rows of the (1, Vp, d) table."""
    _require_local(ctx)
    return params["embed"][0][tokens.long()]


def lm_logits(params, hidden: torch.Tensor, cfg: ModelConfig,
              ctx=None) -> torch.Tensor:
    """hidden (..., d) -> logits (..., Vp)."""
    _require_local(ctx)
    head = params["embed"][0].T if cfg.tie_embeddings else params["head"]
    return hidden @ head


# ===========================================================================
# Full-sequence forward
# ===========================================================================

def _dense_block(pl, h, positions, cfg, *, window=None, causal=True):
    """One pre-norm block.  Returns (h, entry): the block's cache entry
    (:func:`_attention`) is what prefill writes into the cache."""
    x = _norm(h, pl["ln1"], cfg)
    attn_out, entry = _attention(pl["attn"], x, positions, cfg,
                                 causal=causal, window=window)
    h = h + attn_out
    return h + layers.apply_ffn(pl["ffn"], _norm(h, pl["ln2"], cfg),
                                cfg.activation), entry


def _moe_apply(p_moe, h, cfg: ModelConfig):
    """h (B, S, d) -> (out (B, S, d), aux): ``moe_ffn`` over the B * S
    rows (``ctx=None``; expert parallelism is item 13.6)."""
    B, S, d = h.shape
    out, aux = moe_mod.moe_ffn(p_moe, h.reshape(-1, d), cfg)
    return out.reshape(B, S, d), aux


def _hybrid_block(pl, h, positions, cfg, *, window):
    """Hymba: attention and Mamba heads in parallel on the same normed
    input, their normed outputs averaged, then the FFN.  Returns (h,
    entry): K/V rows and the Mamba states ``ssm_h`` (the scan's last
    state, f32) and ``conv`` (the last K-1 pre-conv inputs)."""
    x = _norm(h, pl["ln1"], cfg)
    attn_out, (k, v) = gqa_attention(pl["attn"], x, positions, cfg,
                                     window=window)
    mamba_out, h_final = ssm.mamba_forward(pl["mamba"], x, cfg)
    fused = 0.5 * (_norm(attn_out, pl["ln_attn_out"], cfg) +
                   _norm(mamba_out, pl["ln_mamba_out"], cfg))
    h = h + fused
    h = h + layers.apply_ffn(pl["ffn"], _norm(h, pl["ln2"], cfg),
                             cfg.activation)
    return h, {"k": k, "v": v, "ssm_h": h_final,
               "conv": ssm.mamba_conv_state(pl["mamba"], x, cfg)}


def _rwkv_block(pl, h, cfg, state=None):
    """RWKV-6: time mix (the chunk-parallel form at ``cfg.rwkv_chunk``,
    the per-step scan at 0 or with a carried ``state``), then channel
    mix.  ``state`` is decode's ``{"S", "x_tm", "x_cm"}`` (None for a
    fresh sequence).  Returns (h, the new state)."""
    p, st = pl["rwkv"], state or {}
    x = _norm(h, pl["ln1"], cfg)
    if cfg.rwkv_chunk and state is None:
        tm, (S, x_tm) = ssm.rwkv_time_mix_chunked(p, x, cfg,
                                                  chunk=cfg.rwkv_chunk)
    else:
        tm, (S, x_tm) = ssm.rwkv_time_mix(p, x, cfg, state=st.get("S"),
                                          x_last=st.get("x_tm"))
    h = h + tm
    cm, x_cm = ssm.rwkv_channel_mix(p, _norm(h, pl["ln2"], cfg), cfg,
                                    x_last=st.get("x_cm"))
    return h + cm, {"S": S, "x_tm": x_tm, "x_cm": x_cm}


def _block(pl, h, positions, cfg, *, window=None):
    """One pre-norm layer of any stack.  Returns (h, entry, aux): the
    layer's cache entry (:func:`_attention`'s rows; the hybrid layer's
    rows and Mamba states, :func:`_hybrid_block`; the RWKV layer's
    states, :func:`_rwkv_block`) and the MoE's ``{"moe_aux",
    "moe_dropped"}``, {} for any other layer."""
    if "rwkv" in pl:
        h, entry = _rwkv_block(pl, h, cfg)
        return h, entry, {}
    if "mamba" in pl:
        h, entry = _hybrid_block(pl, h, positions, cfg, window=window)
        return h, entry, {}
    if "moe" not in pl:
        h, entry = _dense_block(pl, h, positions, cfg, window=window)
        return h, entry, {}
    attn_out, entry = _attention(pl["attn"], _norm(h, pl["ln1"], cfg),
                                 positions, cfg, window=window)
    h = h + attn_out
    out, aux = _moe_apply(pl["moe"], _norm(h, pl["ln2"], cfg), cfg)
    return h + out, entry, aux


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, ctx=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, S) -> hidden (B, S, d) after the final norm, aux: {} for
    the dense, hybrid and ssm families; for MoE ``moe_aux``, the mean
    over the MoE layers, and ``moe_dropped``, their sum."""
    _require_ported(cfg)
    B, S = tokens.shape
    h = embed_tokens(params, tokens, cfg, ctx)
    positions = torch.arange(S, device=h.device).expand(B, S)
    auxes = []
    for name, n, windows in block_stacks(cfg):
        for i in range(n):
            h, _, a = _block(layer(params[name], i), h, positions, cfg,
                             window=windows[i])
            if a:
                auxes.append(a)
    aux = {}
    if auxes:
        aux = {"moe_aux": torch.stack([a["moe_aux"] for a in auxes]).mean(),
               "moe_dropped": torch.stack(
                   [a["moe_dropped"] for a in auxes]).sum(dtype=torch.int32)}
    return _norm(h, layer(params["final_norm"], 0), cfg), aux
