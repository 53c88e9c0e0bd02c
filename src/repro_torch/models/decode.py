"""KV-cache decode for the dense and MoE families: the counterpart of
``repro.models.decode``'s ``init_cache`` / ``prefill`` / ``decode_step``.

Cache layout as in the reference: ``{"length": (B,) int32}`` and one
dict of layer-stacked entries per layer stack of ``lm.block_stacks``
(``"blocks"``; for MoE ``"dense_blocks"`` and ``"moe_blocks"``):
``{"k", "v": (layers, B, max_len, KH, hd)}`` for GQA, the latent
``{"c_kv": (layers, B, max_len, kv_lora), "k_rope": (layers, B,
max_len, rope)}`` for MLA; per-sample ``length`` for continuous batching
(slots at different positions).  The reference is pure and returns new
caches; here the cache is updated IN PLACE (``decode_step`` writes one
row of each entry per sample, ``prefill`` its prompt's rows), so a
full-width cache is never copied.  Single device only (``ctx=None``):
the sequence-sharded flash-decode comes with the LM with a
``ParallelContext``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, mla
from repro_torch.models.lm import (
    _block,
    _gqa_qkv,
    _moe_apply,
    _norm,
    _require_local,
    _require_ported,
    block_stacks,
    embed_tokens,
    layer,
    torch_dtype,
)
from repro_torch.utils.device import resolve_device


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device=None) -> Dict[str, Any]:
    """A zero cache of ``batch`` slots of ``max_len`` positions on
    ``device`` (None: the card): K/V for GQA, the latent ``c_kv`` and
    ``k_rope`` for MLA."""
    _require_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    cache: Dict[str, Any] = {
        "length": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.attention == "mla":
        m = cfg.mla
        widths = {"c_kv": (m.kv_lora_rank,), "k_rope": (m.qk_rope_head_dim,)}
    else:
        widths = dict.fromkeys(("k", "v"), (cfg.num_kv_heads, cfg.head_dim))
    for name, n, _ in block_stacks(cfg):
        cache[name] = {key: torch.zeros((n, batch, max_len) + w, dtype=dtype,
                                        device=device)
                       for key, w in widths.items()}
    return cache


def kv_stacks(cache: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The cache's layer-stacked entries, ``{stack: {"k", "v"}}`` (or
    ``{"c_kv", "k_rope"}``): every nested dict, each with the batch at
    axis 1 (the reference's structural rule)."""
    return {name: st for name, st in cache.items() if isinstance(st, dict)}


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


def _write_rows(lc: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                length) -> None:
    """Write one new (B, 1, ...) row of each entry of ``new`` into the
    (B, S, ...) cache tensor ``lc[name]`` at per-sample positions, in
    place.  A position past the cache is dropped, as the reference's
    scatter drops it (an empty slot's length keeps growing).  Every entry
    shares (B, S), so the indices and the mask are built once."""
    B, S = next(iter(lc.values())).shape[:2]
    bi = torch.arange(B, device=length.device)
    pos = length.long()
    inside = pos < S
    pos = pos.clamp(max=S - 1)
    for name, row in new.items():
        cache = lc[name]
        keep = inside.view((B,) + (1,) * (cache.dim() - 2))
        cache[bi, pos] = torch.where(keep, row[:, 0].to(cache.dtype),
                                     cache[bi, pos])


def _gqa_decode_block(pl, h, lc, length, cfg, ctx=None, *, window=None):
    """h (B, 1, d); lc = this layer's cache slice {"k", "v"}, written in
    place.  Returns h."""
    x = _norm(h, pl["ln1"], cfg)
    q, k_new, v_new = _gqa_qkv(pl["attn"], x, length[:, None], cfg)
    _write_rows(lc, {"k": k_new, "v": v_new}, length)
    attn = _decode_attn(q, lc["k"], lc["v"], length + 1, cfg, ctx,
                        window=window)
    return h + attn @ pl["attn"]["wo"]


def _mla_decode_attn(p, x, c_kv, k_rope, length, cfg: ModelConfig,
                     ctx=None):
    """x (B, 1, d), latent caches (B, S, .), ``length`` (B,) counting the
    new row.  Returns (B, 1, d): the absorbed partial, its combine, the
    output projection (the reference's local branch)."""
    _require_local(ctx)
    ctx_l, m, l = mla.mla_decode_partial(p, x, cfg, c_kv, k_rope,
                                         length[:, None])
    return mla.mla_decode_output(p, layers.combine_decode_partials(
        ctx_l, m, l), x.dtype)


def _mla_decode_block(pl, h, lc, length, cfg, ctx=None):
    """h (B, 1, d); lc = this layer's latent cache slice {"c_kv",
    "k_rope"}: the new token's latent row written in place at
    ``length``, then attention over ``length + 1`` rows.  Returns h."""
    x = _norm(h, pl["ln1"], cfg)
    c_kv, k_rope = mla.latent_kv(pl["attn"], x, cfg, length[:, None])
    _write_rows(lc, {"c_kv": c_kv, "k_rope": k_rope}, length)
    return h + _mla_decode_attn(pl["attn"], x, lc["c_kv"], lc["k_rope"],
                                length + 1, cfg, ctx)


def _ffn_or_moe(pl, h, cfg):
    if "moe" in pl:
        out, aux = _moe_apply(pl["moe"], _norm(h, pl["ln2"], cfg), cfg)
        return h + out, aux
    return h + layers.apply_ffn(pl["ffn"], _norm(h, pl["ln2"], cfg),
                                cfg.activation), {}


# ===========================================================================
# decode_step -- one new token for the whole batch
# ===========================================================================

def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig,
                ctx=None) -> Tuple[Dict[str, Any], torch.Tensor]:
    """tokens (B,) -> (cache, hidden (B, d)).  Writes every slot's new
    cache row (K/V, or MLA's latent row) in place and returns the cache
    with ``length + 1``."""
    _require_ported(cfg)
    length = cache["length"]
    h = embed_tokens(params, tokens[:, None], cfg, ctx)         # (B, 1, d)
    for name, n, window in block_stacks(cfg):
        for i in range(n):
            pl, lc = layer(params[name], i), layer(cache[name], i)
            if cfg.attention == "mla":
                h = _mla_decode_block(pl, h, lc, length, cfg, ctx)
            else:
                h = _gqa_decode_block(pl, h, lc, length, cfg, ctx,
                                      window=window)
            h, _ = _ffn_or_moe(pl, h, cfg)
    h = _norm(h, layer(params["final_norm"], 0), cfg)
    cache["length"] = length + 1
    return cache, h[:, 0]


# ===========================================================================
# prefill -- run the full prompt, filling the cache
# ===========================================================================

def _prefill_into(params, tokens: torch.Tensor, cfg: ModelConfig,
                  kv: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Run the prompt ``tokens`` (B, S) and write each layer's cache entry
    into positions ``[0, S)`` of ``kv[stack][key]`` ((layers, B, >= S,
    ...) for every stack of ``lm.block_stacks`` and every key of its
    entry: K/V, or MLA's ``c_kv``/``k_rope``; possibly views of a larger
    cache).  Returns the hidden states (B, S, d) after the final norm."""
    B, S = tokens.shape
    h = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, device=h.device).expand(B, S)
    for name, n, window in block_stacks(cfg):
        for i in range(n):
            h, entry, _ = _block(layer(params[name], i), h, positions, cfg,
                                 window=window)
            for key, rows in entry.items():
                kv[name][key][i, :, :S] = rows
    return _norm(h, layer(params["final_norm"], 0), cfg)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, ctx=None, *,
            max_len: Optional[int] = None
            ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """tokens (B, S) -> (a cache of ``max_len`` positions at length S,
    hidden (B, S, d)), on the tokens' device."""
    _require_ported(cfg)
    _require_local(ctx)
    B, S = tokens.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"max_len {max_len} < prompt length {S}")
    cache = init_cache(cfg, B, max_len, dtype=params["embed"].dtype,
                       device=tokens.device)
    h = _prefill_into(params, tokens, cfg, kv_stacks(cache))
    cache["length"].fill_(S)
    return cache, h
