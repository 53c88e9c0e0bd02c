"""The LM zoo's dense family: the counterpart of ``repro.models.lm``.

Llama-style GQA stacks (granite, starcoder2, yi, nemotron): init,
embedding, the full-sequence forward and the logits head, with the
reference's parameter layout -- per-layer tensors STACKED on a leading
``num_layers`` axis, ``(in, out)`` weights applied as ``x @ w`` -- so a
numpy copy of the reference's ``init_params`` converts without a
transpose (``utils/convert.lm_params_from_numpy``).  The layers run in a
Python loop (the reference scans them).

Single device only: ``ctx`` (the vocabulary through the row-wise sharded
embedding bag, GSPMD constraints) must be None, and a family other than
dense raises ``NotImplementedError`` (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.utils.device import resolve_device


def padded_vocab(cfg: ModelConfig, tp_size: int) -> int:
    """Rows of the embedding table: the vocabulary rounded up to a
    multiple of ``tp_size`` (row-wise sharding needs rows % tp == 0)."""
    V = cfg.vocab_size
    return -(-V // tp_size) * tp_size


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attention != "gqa" or cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / attention "
            f"{cfg.attention!r}: the port runs the dense GQA family only "
            f"(ROADMAP Queue 1 item 13)")


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


def init_params(gen: torch.Generator, cfg: ModelConfig, *, tp_size: int = 1,
                dtype: Optional[torch.dtype] = None,
                device=None) -> Dict[str, Any]:
    """Random dense-family parameters on ``device`` (None: the card), drawn
    from ``gen`` (a generator on that device) one layer at a time:
    ``{"embed" (1, Vp, d), "final_norm", "head" (d, Vp) unless tied,
    "blocks": {"ln1", "ln2", "attn": {wq, wk, wv, wo}, "ffn": {up, down,
    gate}}}`` with ``(num_layers, ...)`` blocks.  The draws are
    ``torch.Generator``'s, not ``jax.random``'s: tests convert the
    reference's parameters instead."""
    _require_dense(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    Vp, d, n = padded_vocab(cfg, tp_size), cfg.d_model, cfg.num_layers
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
    params["blocks"] = {
        "ln1": _init_norm(n, d, cfg, dtype, device),
        "ln2": _init_norm(n, d, cfg, dtype, device),
        "attn": _init_gqa(gen, n, cfg, dtype, device),
        "ffn": layers.init_ffn(gen, n, d, cfg.d_ff, gated=cfg.gated_ffn,
                               dtype=dtype, device=device),
    }
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
    """One pre-norm block.  Returns (h, (k, v)): the block's K/V are what
    prefill writes into the cache."""
    x = _norm(h, pl["ln1"], cfg)
    attn_out, kv = gqa_attention(pl["attn"], x, positions, cfg,
                                 causal=causal, window=window)
    h = h + attn_out
    return h + layers.apply_ffn(pl["ffn"], _norm(h, pl["ln2"], cfg),
                                cfg.activation), kv


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, ctx=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, S) -> hidden (B, S, d) after the final norm, aux ({} for
    the dense family)."""
    _require_dense(cfg)
    B, S = tokens.shape
    h = embed_tokens(params, tokens, cfg, ctx)
    positions = torch.arange(S, device=h.device).expand(B, S)
    for i in range(cfg.num_layers):
        h, _ = _dense_block(layer(params["blocks"], i), h, positions, cfg,
                            window=cfg.window)
    return _norm(h, layer(params["final_norm"], 0), cfg), {}
