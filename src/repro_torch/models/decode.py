"""The KV cache and the carried states, and decode, for every family:
the counterpart of ``repro.models.decode``'s ``init_cache`` / ``prefill``
/ ``decode_step``.

Cache layout as in the reference: ``{"length": (B,) int32}`` and one
dict of layer-stacked entries per layer stack of ``lm.block_stacks``
(``"blocks"``; for MoE ``"dense_blocks"`` and ``"moe_blocks"``), each
with the batch (the slot) at axis 1; for the audio family also the
encoder's output ``"enc" (B, encoder_seq_len, d)``, the one top-level
tensor, batch first, which prefill writes once and every decode step's
cross attention reads.  A stack's entry is one of two kinds:

* positional rows, ``(layers, B, max_len, ...)``, one row per position:
  ``{"k", "v": (.., KH, hd)}`` for GQA (the hybrid family's too), the
  latent ``{"c_kv": (.., kv_lora), "k_rope": (.., rope)}`` for MLA;
  prefill writes rows ``[0, S)``, decode one row per slot at its
  ``length``;
* whole states (:data:`STATE_KEYS`), one per slot, that carry all of
  the prompt into decode: the hybrid family's Mamba ``ssm_h (layers, B,
  di, N)`` f32 and ``conv (layers, B, K-1, di)``; the ssm family's RWKV
  ``S (layers, B, H, hs, hs)`` f32, ``x_tm`` and ``x_cm (layers, B,
  d)``; prefill and decode overwrite them whole.

Per-sample ``length`` serves continuous batching (slots at different
positions).  The reference is pure and returns new caches; here the
cache is updated IN PLACE (decode writes its rows and states, prefill
its prompt's), so a full-width cache is never copied.

Under a ``ParallelContext`` with ``config.decode_kv_seq_sharded`` the
cache's sequence axis is sharded over the model axis's E simulated ranks
(:func:`cache_specs`): the cache stays one tensor, rank r reads positions
``[r Sc, (r + 1) Sc)`` (Sc = max_len / E), computes its flash-decode
partial over them with ``kv_offset = r Sc``, and the partials combine
across the ranks (``layers.combine_decode_partials(rank_dim=0)``), for
GQA and MLA's latent cache alike.  max_len must divide by E.  The
embedding and the MoE layers take the context too (``lm.embed_tokens``,
``lm._moe_apply``), in prefill and decode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import layers, mla, ssm
from repro_torch.models.lm import (
    _block,
    _gqa_qkv,
    _moe_apply,
    _norm,
    _require_ported,
    _rwkv_block,
    block_stacks,
    check_context,
    cross_attention,
    embed_tokens,
    encode,
    layer,
    torch_dtype,
)
from repro_torch.utils.device import resolve_device


# the cache entries that hold one whole state per slot; every other entry
# holds positional rows
STATE_KEYS = frozenset({"ssm_h", "conv", "S", "x_tm", "x_cm"})


def _entry_shapes(cfg: ModelConfig, dtype):
    """``{key: (shape past (layers, B) or (layers, B, max_len), dtype)}``
    of one layer stack's cache entries."""
    d = cfg.d_model
    if cfg.family == "ssm":
        hs = cfg.rwkv_head_size
        return {"S": ((d // hs, hs, hs), torch.float32),
                "x_tm": ((d,), dtype), "x_cm": ((d,), dtype)}
    if cfg.attention == "mla":
        m = cfg.mla
        return {"c_kv": ((m.kv_lora_rank,), dtype),
                "k_rope": ((m.qk_rope_head_dim,), dtype)}
    shapes = dict.fromkeys(("k", "v"), ((cfg.num_kv_heads, cfg.head_dim),
                                        dtype))
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * d
        shapes["ssm_h"] = ((di, cfg.ssm_state), torch.float32)
        shapes["conv"] = ((cfg.ssm_conv - 1, di), dtype)
    return shapes


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device=None) -> Dict[str, Any]:
    """A zero cache of ``batch`` slots of ``max_len`` positions on
    ``device`` (None: the card): K/V for GQA, the latent ``c_kv`` and
    ``k_rope`` for MLA, K/V and the Mamba states for the hybrid family,
    the RWKV states for the ssm family (the states ``ssm_h`` and ``S`` in
    f32 whatever ``dtype``), K/V and ``enc`` for the audio family."""
    _require_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    cache: Dict[str, Any] = {
        "length": torch.zeros((batch,), dtype=torch.int32, device=device)}
    shapes = _entry_shapes(cfg, dtype)
    for name, n, _ in block_stacks(cfg):
        cache[name] = {
            key: torch.zeros((n, batch) + (() if key in STATE_KEYS
                                           else (max_len,)) + shape,
                             dtype=dt, device=device)
            for key, (shape, dt) in shapes.items()}
    if cfg.family == "audio":
        cache["enc"] = torch.zeros((batch, cfg.encoder_seq_len, cfg.d_model),
                                   dtype=dtype, device=device)
    return cache


def kv_stacks(cache: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The cache's layer-stacked entries, ``{stack: {key: tensor}}``:
    every nested dict, each entry with the batch at axis 1 (the
    reference's structural rule), positional rows ``(layers, B, max_len,
    ...)`` and whole states (:data:`STATE_KEYS`) alike, so slicing axis 1
    takes a slot's rows and states together.  The top-level tensors
    (``length``, the audio family's ``enc``) are no layer stack and are
    left out."""
    return {name: st for name, st in cache.items() if isinstance(st, dict)}


def cache_specs(cfg: ModelConfig, ctx: ParallelContext,
                batch: int) -> Dict[str, Any]:
    """Which axes of :func:`init_cache`'s entries the reference shards, as
    a tree like the cache's of tuples of axis names (None: replicated),
    the counterpart of its ``PartitionSpec``s: the batch (slots) over the
    data axis when ``dp_size`` divides it, positional rows' sequence over
    the model axis with ``decode_kv_seq_sharded``, the hybrid family's
    ``ssm_h`` along its inner dim over the model axis.  On the simulated
    ranks it is a statement, not a layout: the cache stays one tensor on
    one device, and rank r of the sequence-sharded decode reads its slice
    of positions (module docstring)."""
    dpb = "data" if ctx.dp_for(batch) else None
    seq = "model" if ctx.config.decode_kv_seq_sharded else None
    stacked = {"ssm_h": (None, dpb, "model", None),
               "conv": (None, dpb, None, None),
               "S": (None, dpb, None, None, None),
               "x_tm": (None, dpb, None), "x_cm": (None, dpb, None)}
    shapes = _entry_shapes(cfg, torch.float32)
    specs: Dict[str, Any] = {"length": (dpb,)}
    for name, _, _ in block_stacks(cfg):
        specs[name] = {
            key: stacked[key] if key in STATE_KEYS
            else (None, dpb, seq) + (None,) * len(shape)
            for key, (shape, _) in shapes.items()}
    if cfg.family == "audio":
        specs["enc"] = (dpb, None, None)
    return specs


# ===========================================================================
# Decode attention
# ===========================================================================

def _seq_sharded(ctx: Optional[ParallelContext], max_len: int) -> int:
    """The ranks decode attention is sharded over: E under a context with
    ``decode_kv_seq_sharded`` (``max_len`` must divide by E, else
    ``ValueError``, where the reference's ``shard_map`` fails), else 0."""
    if check_context(ctx) is None or not ctx.config.decode_kv_seq_sharded:
        return 0
    if max_len % ctx.tp_size:
        raise ValueError(f"a cache of {max_len} positions does not divide "
                         f"over {ctx.tp_size} ranks")
    return ctx.tp_size


def _rank_partials(partial, caches, length, ranks: int):
    """``partial(*slices, length, kv_offset)`` over each rank's slice of
    the (B, S, ...) ``caches``, combined across the ranks; one call over
    the whole caches when ``ranks`` is 0."""
    if not ranks:
        return layers.combine_decode_partials(*partial(*caches, length, 0))
    sc = caches[0].shape[1] // ranks
    parts = [partial(*(c[:, r * sc:(r + 1) * sc] for c in caches), length,
                     r * sc) for r in range(ranks)]
    return layers.combine_decode_partials(
        *(torch.stack(t) for t in zip(*parts)), rank_dim=0)


def _decode_attn(q, k_cache, v_cache, length, cfg: ModelConfig, ctx=None, *,
                 window=None):
    """q (B, 1, H, hd), caches (B, S, KH, hd).  Returns (B, 1, H * hd):
    over the whole cache, or sequence-sharded over the context's ranks
    (module docstring)."""
    B = q.shape[0]
    out = _rank_partials(
        lambda k, v, n, off: layers.decode_attention_partial(
            q, k, v, n, window=window, kv_offset=off),
        (k_cache, v_cache), length[:, None],
        _seq_sharded(ctx, k_cache.shape[1]))
    return out.reshape(B, 1, -1).to(q.dtype)


def _write_rows(lc: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                length) -> None:
    """Write one new (B, 1, ...) row of each positional entry of ``new``
    into the (B, S, ...) cache tensor ``lc[name]`` at per-sample
    positions, in place.  A position past the cache is dropped, as the
    reference's scatter drops it (an empty slot's length keeps growing).
    The entries of ``new`` share (B, S), so the indices and the mask are
    built once.  A whole state (:data:`STATE_KEYS`) has no positions and
    raises."""
    states = STATE_KEYS.intersection(new)
    if states:
        raise ValueError(f"{sorted(states)}: whole states, not positional "
                         f"rows; decode overwrites them whole")
    B, S = lc[next(iter(new))].shape[:2]
    bi = torch.arange(B, device=length.device)
    pos = length.long()
    inside = pos < S
    pos = pos.clamp(max=S - 1)
    for name, row in new.items():
        cache = lc[name]
        keep = inside.view((B,) + (1,) * (cache.dim() - 2))
        cache[bi, pos] = torch.where(keep, row[:, 0].to(cache.dtype),
                                     cache[bi, pos])


def _gqa_decode_block(pl, h, lc, length, cfg, ctx=None, *, window=None,
                      cross_feats=None, rope=True):
    """h (B, 1, d); lc = this layer's cache slice {"k", "v"}, written in
    place; with ``cross_feats`` (the audio family's ``cache["enc"]``)
    cross attention after self attention, its K/V projected from the
    encoder output again (as in the reference); ``rope`` False for the
    audio family.  Returns h."""
    x = _norm(h, pl["ln1"], cfg)
    q, k_new, v_new = _gqa_qkv(pl["attn"], x, length[:, None], cfg,
                               rope=rope)
    _write_rows(lc, {"k": k_new, "v": v_new}, length)
    attn = _decode_attn(q, lc["k"], lc["v"], length + 1, cfg, ctx,
                        window=window)
    h = h + attn @ pl["attn"]["wo"]
    if cross_feats is not None:
        h = h + cross_attention(pl["cross"], _norm(h, pl["ln_cross"], cfg),
                                cross_feats, cfg)
    return h


def _mla_decode_attn(p, x, c_kv, k_rope, length, cfg: ModelConfig,
                     ctx=None):
    """x (B, 1, d), latent caches (B, S, .), ``length`` (B,) counting the
    new row.  Returns (B, 1, d): the absorbed partials (over the whole
    cache, or each rank's slice of it, module docstring), their combine,
    the output projection."""
    combined = _rank_partials(
        lambda ck, kr, n, off: mla.mla_decode_partial(
            p, x, cfg, ck, kr, n, kv_offset=off),
        (c_kv, k_rope), length[:, None], _seq_sharded(ctx, c_kv.shape[1]))
    return mla.mla_decode_output(p, combined, x.dtype)


def _mla_decode_block(pl, h, lc, length, cfg, ctx=None):
    """h (B, 1, d); lc = this layer's latent cache slice {"c_kv",
    "k_rope"}: the new token's latent row written in place at
    ``length``, then attention over ``length + 1`` rows.  Returns h."""
    x = _norm(h, pl["ln1"], cfg)
    c_kv, k_rope = mla.latent_kv(pl["attn"], x, cfg, length[:, None])
    _write_rows(lc, {"c_kv": c_kv, "k_rope": k_rope}, length)
    return h + _mla_decode_attn(pl["attn"], x, lc["c_kv"], lc["k_rope"],
                                length + 1, cfg, ctx)


def _hybrid_decode_block(pl, h, lc, length, cfg, ctx=None, *, window):
    """h (B, 1, d); lc = this layer's slice {"k", "v", "ssm_h", "conv"}:
    the new K/V row written at ``length`` and windowed attention over
    ``length + 1`` rows, beside one Mamba step on the carried states
    (overwritten in place); h plus the normed mean of both."""
    x = _norm(h, pl["ln1"], cfg)
    q, k_new, v_new = _gqa_qkv(pl["attn"], x, length[:, None], cfg)
    _write_rows(lc, {"k": k_new, "v": v_new}, length)
    attn = _decode_attn(q, lc["k"], lc["v"], length + 1, cfg, ctx,
                        window=window) @ pl["attn"]["wo"]
    m_out, ssm_h, conv = ssm.mamba_decode_step(pl["mamba"], x, cfg,
                                               lc["ssm_h"], lc["conv"])
    lc["ssm_h"].copy_(ssm_h)
    lc["conv"].copy_(conv)
    return h + 0.5 * (_norm(attn, pl["ln_attn_out"], cfg) +
                      _norm(m_out, pl["ln_mamba_out"], cfg))


def _rwkv_decode_block(pl, h, lc, cfg):
    """h (B, 1, d); lc = this layer's states {"S", "x_tm", "x_cm"}: one
    step of the time mix's scan and the channel mix from the carried
    states, overwritten in place.  Returns h."""
    h, new = _rwkv_block(pl, h, cfg, state=lc)
    for key, val in new.items():
        lc[key].copy_(val)
    return h


def _ffn_or_moe(pl, h, cfg, ctx=None):
    if "moe" in pl:
        out, aux = _moe_apply(pl["moe"], _norm(h, pl["ln2"], cfg), cfg, ctx)
        return h + out, aux
    return h + layers.apply_ffn(pl["ffn"], _norm(h, pl["ln2"], cfg),
                                cfg.activation), {}


# ===========================================================================
# decode_step -- one new token for the whole batch
# ===========================================================================

def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig,
                ctx: Optional[ParallelContext] = None
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """tokens (B,) -> (cache, hidden (B, d)).  Writes every slot's new
    cache row (K/V, or MLA's latent row) and overwrites its states
    (Mamba's, RWKV's) in place, and returns the cache with ``length +
    1``.  The audio family's layers cross-attend to ``cache["enc"]``.
    ``ctx``: the embedding, the MoE layers and (sequence-sharded) decode
    attention under the context (module docstring)."""
    _require_ported(cfg)
    length = cache["length"]
    audio = cfg.family == "audio"
    enc = cache["enc"] if audio else None
    h = embed_tokens(params, tokens[:, None], cfg, ctx)         # (B, 1, d)
    for name, n, windows in block_stacks(cfg):
        for i in range(n):
            pl, lc = layer(params[name], i), layer(cache[name], i)
            if cfg.family == "ssm":
                h = _rwkv_decode_block(pl, h, lc, cfg)
                continue
            if cfg.family == "hybrid":
                h = _hybrid_decode_block(pl, h, lc, length, cfg, ctx,
                                         window=windows[i])
            elif cfg.attention == "mla":
                h = _mla_decode_block(pl, h, lc, length, cfg, ctx)
            else:
                h = _gqa_decode_block(pl, h, lc, length, cfg, ctx,
                                      window=windows[i], cross_feats=enc,
                                      rope=not audio)
            h, _ = _ffn_or_moe(pl, h, cfg, ctx)
    h = _norm(h, layer(params["final_norm"], 0), cfg)
    cache["length"] = length + 1
    return cache, h[:, 0]


# ===========================================================================
# prefill -- run the full prompt, filling the cache
# ===========================================================================

def _prefill_into(params, tokens: torch.Tensor, cfg: ModelConfig,
                  kv: Dict[str, Dict[str, torch.Tensor]], ctx=None, *,
                  cross_feats=None) -> torch.Tensor:
    """Run the prompt ``tokens`` (B, S) and write each layer's cache entry
    into ``kv[stack][key]`` (``(layers, B, ...)`` for every stack of
    ``lm.block_stacks`` and every key of its entry, possibly views of a
    larger cache): positional rows (K/V, MLA's ``c_kv``/``k_rope``) into
    positions ``[0, S)``, whole states (:data:`STATE_KEYS`) entire.
    ``cross_feats``: the audio family's encoder output, which every layer
    cross-attends to.  ``ctx``: the embedding and the MoE layers under
    the context.  Returns the hidden states (B, S, d) after the final
    norm."""
    B, S = tokens.shape
    h = embed_tokens(params, tokens, cfg, ctx)
    positions = torch.arange(S, device=h.device).expand(B, S)
    for name, n, windows in block_stacks(cfg):
        for i in range(n):
            h, entry, _ = _block(layer(params[name], i), h, positions, cfg,
                                 ctx, window=windows[i],
                                 cross_feats=cross_feats)
            for key, val in entry.items():
                if key in STATE_KEYS:
                    kv[name][key][i] = val
                else:
                    kv[name][key][i, :, :S] = val
    return _norm(h, layer(params["final_norm"], 0), cfg)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: Optional[ParallelContext] = None, *,
            max_len: Optional[int] = None, frames=None, patches=None
            ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """tokens (B, S) -> (a cache of ``max_len`` positions at length S,
    hidden (B, S, d)), on the tokens' device; ``ctx``: the embedding and
    the MoE layers under the context.  audio: ``frames`` (B,
    S_enc, d) run through the encoder once, into ``cache["enc"]``.  vlm:
    text only; ``patches`` raises ``NotImplementedError``, as in the
    reference (an image-prefixed prompt goes through ``lm.forward``)."""
    _require_ported(cfg)
    check_context(ctx)
    if cfg.family == "vlm" and patches is not None:
        raise NotImplementedError(
            f"{cfg.name}: prefill with patches (an image-prefixed cache) "
            f"is not in the reference either; lm.forward(..., patches=) "
            f"runs the prefixed sequence")
    B, S = tokens.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"max_len {max_len} < prompt length {S}")
    cache = init_cache(cfg, B, max_len, dtype=params["embed"].dtype,
                       device=tokens.device)
    if cfg.family == "audio":
        cache["enc"] = encode(params, frames, cfg)
    h = _prefill_into(params, tokens, cfg, kv_stacks(cache), ctx,
                      cross_feats=cache.get("enc"))
    cache["length"].fill_(S)
    return cache, h
