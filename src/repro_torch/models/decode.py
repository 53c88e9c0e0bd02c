"""KV-cache decode for the dense family: the counterpart of
``repro.models.decode``'s ``init_cache`` / ``prefill`` / ``decode_step``.

Cache layout as in the reference: ``{"length": (B,) int32, "blocks":
{"k", "v": (num_layers, B, max_len, KH, hd)}}``, per-sample ``length`` for
continuous batching (slots at different positions).  The reference is
pure and returns new caches; here the cache is updated IN PLACE
(``decode_step`` writes one K/V row per sample, ``prefill`` its prompt's
rows), so a full-width cache is never copied.  Single device only
(``ctx=None``): the sequence-sharded flash-decode comes with the LM with a
``ParallelContext``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.lm import (
    _dense_block,
    _gqa_qkv,
    _norm,
    _require_dense,
    _require_local,
    embed_tokens,
    layer,
    torch_dtype,
)
from repro_torch.utils.device import resolve_device


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device=None) -> Dict[str, Any]:
    """A zero cache of ``batch`` slots of ``max_len`` positions on
    ``device`` (None: the card)."""
    _require_dense(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"length": torch.zeros((batch,), dtype=torch.int32, device=device),
            "blocks": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}}


# ===========================================================================
# Decode attention
# ===========================================================================

def _decode_attn(q, k_cache, v_cache, length, cfg: ModelConfig, ctx=None, *,
                 window=None):
    """q (B, 1, H, hd), caches (B, S, KH, hd).  Returns (B, 1, H * hd)."""
    _require_local(ctx)
    B = q.shape[0]
    o, m, l = layers.decode_attention_partial(
        q, k_cache, v_cache, length[:, None], window=window)
    out = layers.combine_decode_partials(o, m, l)
    return out.reshape(B, 1, -1).to(q.dtype)


def _write_kv(cache_k, cache_v, k_new, v_new, length) -> None:
    """Write one new (B, 1, KH, hd) entry at per-sample positions, in
    place.  A position past the cache is dropped, as the reference's
    scatter drops it (an empty slot's length keeps growing)."""
    B, S = cache_k.shape[:2]
    bi = torch.arange(B, device=cache_k.device)
    pos = length.long()
    inside = (pos < S)[:, None, None]
    pos = pos.clamp(max=S - 1)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache[bi, pos] = torch.where(inside, new[:, 0].to(cache.dtype),
                                     cache[bi, pos])


def _gqa_decode_block(pl, h, lc, length, cfg, ctx=None, *, window=None):
    """h (B, 1, d); lc = this layer's cache slice {"k", "v"}, written in
    place.  Returns h."""
    x = _norm(h, pl["ln1"], cfg)
    q, k_new, v_new = _gqa_qkv(pl["attn"], x, length[:, None], cfg)
    _write_kv(lc["k"], lc["v"], k_new, v_new, length)
    attn = _decode_attn(q, lc["k"], lc["v"], length + 1, cfg, ctx,
                        window=window)
    return h + attn @ pl["attn"]["wo"]


def _ffn_or_moe(pl, h, cfg):
    if "moe" in pl:
        raise NotImplementedError(
            "MoE layers wait for the MoE slice (ROADMAP Queue 1 item 13)")
    return h + layers.apply_ffn(pl["ffn"], _norm(h, pl["ln2"], cfg),
                                cfg.activation), {}


# ===========================================================================
# decode_step -- one new token for the whole batch
# ===========================================================================

def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig,
                ctx=None) -> Tuple[Dict[str, Any], torch.Tensor]:
    """tokens (B,) -> (cache, hidden (B, d)).  Writes every slot's new K/V
    row in place and returns the cache with ``length + 1``."""
    _require_dense(cfg)
    length = cache["length"]
    h = embed_tokens(params, tokens[:, None], cfg, ctx)         # (B, 1, d)
    for i in range(cfg.num_layers):
        pl = layer(params["blocks"], i)
        h = _gqa_decode_block(pl, h, layer(cache["blocks"], i), length, cfg,
                              ctx, window=cfg.window)
        h, _ = _ffn_or_moe(pl, h, cfg)
    h = _norm(h, layer(params["final_norm"], 0), cfg)
    cache["length"] = length + 1
    return cache, h[:, 0]


# ===========================================================================
# prefill -- run the full prompt, filling the cache
# ===========================================================================

def _prefill_into(params, tokens: torch.Tensor, cfg: ModelConfig,
                  kv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Run the prompt ``tokens`` (B, S) and write each layer's K/V into
    positions ``[0, S)`` of ``kv["k"]``, ``kv["v"]`` ((num_layers, B,
    >= S, KH, hd), possibly views of a larger cache).  Returns the hidden
    states (B, S, d) after the final norm."""
    B, S = tokens.shape
    h = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, device=h.device).expand(B, S)
    for i in range(cfg.num_layers):
        h, (k, v) = _dense_block(layer(params["blocks"], i), h, positions,
                                 cfg, window=cfg.window)
        kv["k"][i, :, :S] = k
        kv["v"][i, :, :S] = v
    return _norm(h, layer(params["final_norm"], 0), cfg)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, ctx=None, *,
            max_len: Optional[int] = None
            ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """tokens (B, S) -> (a cache of ``max_len`` positions at length S,
    hidden (B, S, d)), on the tokens' device."""
    _require_dense(cfg)
    _require_local(ctx)
    B, S = tokens.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"max_len {max_len} < prompt length {S}")
    cache = init_cache(cfg, B, max_len, dtype=params["embed"].dtype,
                       device=tokens.device)
    h = _prefill_into(params, tokens, cfg, cache["blocks"])
    cache["length"].fill_(S)
    return cache, h
