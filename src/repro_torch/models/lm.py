"""The LM zoo's dense, MoE, hybrid, ssm, audio and vlm families: the
counterpart of ``repro.models.lm``.

Llama-style GQA stacks (granite, starcoder2, yi, nemotron); the
mixture-of-experts family (``first_k_dense`` dense layers, then layers
whose FFN is ``models/moe.moe_ffn``) with GQA attention (moonshot) or
MLA (deepseek-v3, ``models/mla.py``); the hybrid family (hymba: GQA
attention and Mamba heads in parallel on the same normed input, a
sliding window on every layer but ``global_attn_layers``) and the ssm
family (rwkv6: RWKV-6 time and channel mix, no attention), both through
``models/ssm.py``; the audio family (whisper: a non-causal encoder over
precomputed frame embeddings, ``enc_blocks``, and a decoder whose layers
cross-attend to its output, no rotary positions anywhere) and the vlm
family (internvl2: precomputed patch embeddings through a LayerNorm-GELU
projector, prepended to the text of a llama-style stack): init,
embedding, the full-sequence forward and the logits head, with the
reference's parameter layout -- per-layer tensors STACKED on a leading
layer axis (``blocks`` for the dense, hybrid, ssm, vlm and audio
decoder; ``enc_blocks`` for the audio encoder; ``dense_blocks`` and
``moe_blocks`` for MoE; deepseek's MTP head under ``mtp``), ``(in,
out)`` weights applied as ``x @ w`` --
so a numpy copy of the reference's ``init_params`` converts without a
transpose (``utils/convert.lm_params_from_numpy``).  The layers run in a
Python loop (the reference scans them).

With a ``ParallelContext`` (``core/parallel.py``: the ranks of the model
axis simulated on one device, stacked on a leading rank axis as the
distributed embedding bag's are) the tokens are looked up through the
row-wise sharded embedding bag (:func:`embed_tokens`) and the MoE layers
run expert-parallel over the ranks (:func:`_moe_apply`,
``models/moe.moe_ffn_ep``), as in the reference.  The reference's GSPMD
hints (activation constraints between blocks, sequence parallelism,
vocabulary-sharded logits) place tensors and change no value; the port
keeps every tensor whole and models none of them.
Serving ignores the MTP head, as the reference does; its loss is LM
training's (``train/step.lm_loss``).

Training: ``forward(..., remat=True)`` runs each block under
``torch.utils.checkpoint``: full recompute, MoE blocks too.  On one
device the reference recomputes every block whole as well: its policy
saves the names ``"moe_out"``, which only the expert-parallel branch
sets (``_moe_apply`` returns before it without a context).  Under a
context the reference saves the EP output and its backward does not
replay the all-to-alls and the expert matmuls; the port recomputes them,
the same values at more cost (ROADMAP "Differences on purpose").
Under grad, :func:`layer` slices a stacked parameter whose
``.grad`` the caller preallocated (``train/step.TrainStep``) through
:class:`_LayerSlice`, which adds the layer's gradient into that
``.grad`` slice: indexing (``select``'s backward) would build a zero
tensor the size of the whole stack for every layer.  Any other stacked
leaf is indexed, so ``torch.autograd.grad`` and ``torch.func`` see its
gradient.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.embedding_bag import (EmbeddingBagConfig,
                                            pooled_lookup_sharded,
                                            shard_tables)
from repro_torch.core.jagged import JaggedBatch
from repro_torch.core.parallel import ParallelContext
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
          ("hybrid", "hybrid_parallel"), ("ssm", "none"), ("audio", "gqa"),
          ("vlm", "gqa")}
# a window wider than any sequence: the global layers' (the reference's)
GLOBAL_WINDOW = 1 << 30


def _require_ported(cfg: ModelConfig) -> None:
    if (cfg.family, cfg.attention) not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / attention "
            f"{cfg.attention!r} is no pair the reference runs; the port "
            f"runs {sorted(PORTED)}")


def _hymba_windows(cfg: ModelConfig) -> tuple:
    """Per-layer window of the hybrid family: ``cfg.window`` (or
    :data:`GLOBAL_WINDOW`), and :data:`GLOBAL_WINDOW` on
    ``global_attn_layers``."""
    return tuple(GLOBAL_WINDOW if i in cfg.global_attn_layers
                 else cfg.window or GLOBAL_WINDOW
                 for i in range(cfg.num_layers))


def block_stacks(cfg: ModelConfig):
    """The layer stacks over the token stream in order, as ``(name,
    layers, windows)``, one window per layer: the dense, vlm and audio
    families' ``blocks`` (``cfg.window``; the audio decoder's, whose
    encoder stack ``enc_blocks`` is a pass of its own over the frames,
    :func:`encode`);
    the hybrid family's ``blocks`` (:func:`_hymba_windows`); the ssm
    family's ``blocks`` (no attention); MoE's ``dense_blocks`` (if
    ``first_k_dense``) then ``moe_blocks``, both without a window, as in
    the reference."""
    n = cfg.num_layers
    if cfg.family in ("dense", "vlm", "audio"):
        return [("blocks", n, (cfg.window,) * n)]
    if cfg.family == "hybrid":
        return [("blocks", n, _hymba_windows(cfg))]
    if cfg.family == "ssm":
        return [("blocks", n, (None,) * n)]
    nk = cfg.first_k_dense
    return ([("dense_blocks", nk, (None,) * nk)] if nk else []) + [
        ("moe_blocks", n - nk, (None,) * (n - nk))]


def embedding_bag_config(cfg: ModelConfig,
                         tp_size: int) -> EmbeddingBagConfig:
    """The vocabulary as the embedding bag's one table of
    :func:`padded_vocab` rows, sharded per ``cfg.vocab_sharding`` and
    looked up per ``cfg.vocab_rw_impl``, as the reference builds it (its
    ``rw_backend`` is always the bulk default)."""
    return EmbeddingBagConfig(
        num_tables=1, rows_per_table=padded_vocab(cfg, tp_size),
        dim=cfg.d_model, sharding=cfg.vocab_sharding,
        rw_impl=cfg.vocab_rw_impl, dtype=cfg.dtype)


def check_context(ctx) -> Optional[ParallelContext]:
    """``ctx`` if it is None or a ``ParallelContext``; anything else
    raises ``TypeError``."""
    if ctx is not None and not isinstance(ctx, ParallelContext):
        raise TypeError(f"ctx must be a ParallelContext or None, got "
                        f"{type(ctx).__name__}")
    return ctx


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
                      with_moe=False, with_mamba=False, with_cross=False):
    """One stack of ``n`` layers: norms, attention (GQA or MLA), with
    ``with_mamba`` the Mamba heads and their output norms, with
    ``with_cross`` the cross attention ``cross`` and its norm
    ``ln_cross``, then the FFN or (with ``with_moe``) the MoE block."""
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
    if with_cross:
        p["cross"] = _init_gqa(gen, n, cfg, dtype, device)
        p["ln_cross"] = _init_norm(n, d, cfg, dtype, device)
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
    ``models/ssm.init_rwkv_params``; the audio decoder's ``blocks`` add
    ``"cross"`` (GQA weights) and ``"ln_cross"``); for the audio family
    the encoder, ``"enc_blocks"`` (``cfg.encoder_layers`` dense layers),
    ``"enc_pos" (encoder_seq_len, d)`` (N(0, 0.01**2)) and
    ``"enc_norm"``; for the vlm family ``"projector": {"ln_w", "ln_b"
    (vision_dim,), "fc1" (vision_dim, d), "fc2" (d, d)}``; with
    ``cfg.mtp_depth``, ``"mtp": {"proj" (2d, d), "norm_h", "norm_e",
    "block"}``, one dense layer, as the reference builds it.  The draws are ``torch.Generator``'s, not
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
                with_mamba=cfg.family == "hybrid",
                with_cross=cfg.family == "audio")
    if cfg.family == "audio":
        params["enc_blocks"] = _init_block_stack(gen, cfg.encoder_layers,
                                                 cfg, dtype, device)
        pos = torch.empty((cfg.encoder_seq_len, d), dtype=torch.float32,
                          device=device)
        params["enc_pos"] = pos.normal_(generator=gen).mul_(0.01).to(dtype)
        params["enc_norm"] = _init_norm(1, d, cfg, dtype, device)
    if cfg.family == "vlm":
        v = cfg.vision_dim
        params["projector"] = {
            "ln_w": torch.ones((v,), dtype=dtype, device=device),
            "ln_b": torch.zeros((v,), dtype=dtype, device=device),
            "fc1": layers.stacked_dense_init(gen, 1, v, d, dtype=dtype,
                                             device=device)[0],
            "fc2": layers.stacked_dense_init(gen, 1, d, d, dtype=dtype,
                                             device=device)[0]}
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": layers.stacked_dense_init(gen, 1, 2 * d, d, dtype=dtype,
                                              device=device)[0],
            "norm_h": _init_norm(1, d, cfg, dtype, device),
            "norm_e": _init_norm(1, d, cfg, dtype, device),
            "block": _init_block_stack(gen, 1, cfg, dtype, device)}
    return params


class _LayerSlice(torch.autograd.Function):
    """``stack[i]`` of a leaf ``stack`` whose ``.grad`` is preallocated
    (the train step's buffers): the view in the forward; the backward adds
    the slice's gradient into ``stack.grad[i]`` and passes nothing on, so
    no stack-sized zero tensor is built per layer.  Only ``.backward()``
    into those buffers sees this gradient: :func:`_slice` takes it only
    where the caller has allocated them."""

    @staticmethod
    def forward(ctx, stack, i):
        ctx.set_materialize_grads(False)
        ctx.stack, ctx.i = stack, i
        return stack[i]

    @staticmethod
    def backward(ctx, g):
        if g is not None:
            ctx.stack.grad[ctx.i].add_(g)
        return None, None


def _slice(v: torch.Tensor, i: int) -> torch.Tensor:
    if (torch.is_grad_enabled() and v.requires_grad and v.is_leaf
            and v.grad is not None):
        return _LayerSlice.apply(v, i)
    return v[i]


def layer(stack: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked parameter (or cache) tree: views (under
    grad, a leaf whose ``.grad`` is preallocated through
    :class:`_LayerSlice`; any other leaf by indexing, which every form of
    autograd differentiates)."""
    return {k: layer(v, i) if isinstance(v, dict) else _slice(v, i)
            for k, v in stack.items()}


def _run_block(remat: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, under ``torch.utils.checkpoint`` with
    ``remat`` when grad is enabled (the reference's ``jax.checkpoint``
    of each scanned block)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


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
    for MLA.  The audio family rotates nothing (its positions live in
    the learned ``enc_pos`` and, in the decoder, the cache's length)."""
    if cfg.attention == "mla":
        out, (c_kv, k_rope) = mla.mla_attention(p, x, positions, cfg,
                                                causal=causal)
        return out, {"c_kv": c_kv, "k_rope": k_rope}
    out, (k, v) = gqa_attention(p, x, positions, cfg, causal=causal,
                                window=window, rope=cfg.family != "audio")
    return out, {"k": k, "v": v}


def cross_attention(p, h, kv_feats, cfg: ModelConfig):
    """Decoder -> encoder cross attention (whisper): q from ``h`` (B, S,
    d), K/V from ``kv_feats`` (B, S_enc, d), no rotation, no mask, full
    attention whatever the lengths.  Returns (B, S, d)."""
    B, S, _ = h.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Se = kv_feats.shape[1]
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (kv_feats @ p["wk"]).reshape(B, Se, KH, hd)
    v = (kv_feats @ p["wv"]).reshape(B, Se, KH, hd)
    o = layers.full_attention(q, k, v, causal=False)
    return o.reshape(B, S, -1) @ p["wo"]


# ===========================================================================
# Embedding and head
# ===========================================================================

def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, d): rows of the (1, Vp, d) table.

    Under a context with ``cfg.vocab_sharding == "row"`` the table is
    sharded row-wise over the model axis and the N = B * S tokens are N
    single-id bags of the embedding bag (``(1, N, 1)`` ids, unit
    lengths) through ``pooled_lookup_sharded``: ``"allgather"`` pools
    each rank's owned rows of every token (one TBE launch a rank) and
    sums the E partials; ``"a2a"`` takes the paper's pipeline (N divisible
    by E).  The flat tokens split into the context's data-parallel groups
    when ``dp_size`` divides N, one after another.  One lookup of weight
    1 plus E - 1 zero partials is the row itself, so the result is
    bitwise the local gather's.  Rows that do not divide over the ranks,
    and an unknown ``vocab_sharding`` or ``vocab_rw_impl``, raise
    ``ValueError``, where the reference's ``shard_map`` fails.
    ``"replicated"`` keeps the local gather."""
    table = params["embed"]                                  # (1, Vp, d)
    if check_context(ctx) is None or cfg.vocab_sharding == "replicated":
        return table[0][tokens.long()]
    if cfg.vocab_sharding != "row":
        raise ValueError(f"vocab_sharding must be 'row' or 'replicated', "
                         f"got {cfg.vocab_sharding!r}")
    eb_cfg = embedding_bag_config(cfg, ctx.tp_size)
    shards = shard_tables(table, eb_cfg, ctx.tp_size)
    B, S = tokens.shape
    flat = tokens.reshape(-1)
    groups = ctx.dp_groups(flat.shape[0])
    n = flat.shape[0] // groups
    outs = []
    for g in range(groups):
        ids = flat[g * n:(g + 1) * n]
        batch = JaggedBatch(
            indices=ids.reshape(1, n, 1),
            lengths=torch.ones((1, n), dtype=torch.int32,
                               device=ids.device))
        outs.append(pooled_lookup_sharded(shards, batch, eb_cfg)[:, 0])
    return torch.cat(outs).reshape(B, S, cfg.d_model)


def lm_logits(params, hidden: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """hidden (..., d) -> logits (..., Vp).  Under a context the same
    product: the reference's vocabulary-sharded constraint on the logits
    (``logits_vocab_sharded``) is a layout."""
    check_context(ctx)
    head = params["embed"][0].T if cfg.tie_embeddings else params["head"]
    return hidden @ head


# ===========================================================================
# Full-sequence forward
# ===========================================================================

def _dense_block(pl, h, positions, cfg, *, window=None, causal=True,
                 cross_feats=None):
    """One pre-norm block; with ``cross_feats`` (the audio decoder's
    encoder output) cross attention between self attention and the FFN.
    Returns (h, entry): the block's cache entry (:func:`_attention`) is
    what prefill writes into the cache."""
    x = _norm(h, pl["ln1"], cfg)
    attn_out, entry = _attention(pl["attn"], x, positions, cfg,
                                 causal=causal, window=window)
    h = h + attn_out
    if cross_feats is not None:
        h = h + cross_attention(pl["cross"], _norm(h, pl["ln_cross"], cfg),
                                cross_feats, cfg)
    return h + layers.apply_ffn(pl["ffn"], _norm(h, pl["ln2"], cfg),
                                cfg.activation), entry


def _moe_apply(p_moe, h, cfg: ModelConfig,
               ctx: Optional[ParallelContext] = None):
    """h (B, S, d) -> (out (B, S, d), aux).  Without a context
    ``moe_ffn`` over the B * S rows.  Under one, ``moe_ffn_ep`` over the
    model axis's E ranks, as the reference's ``shard_map`` splits the
    tokens: ``P(dp, tp if S % E == 0 else None)``.  When E divides S
    each rank takes its slice of the sequence (of every sample of its
    data-parallel group); otherwise (every decode step: S = 1) each rank
    holds the same tokens and dispatches them all, and the output is
    rank 0's copy.  The data-parallel groups (``dp_size`` dividing B) run
    one after another.  ``aux`` follows the reference's replicated
    ``out_specs=P()``: its values are the first group's, while the
    gradient of ``moe_aux`` is that of the mean over the groups (its
    transpose hands each device 1 / (dp E) of the cotangent and sums over
    the group's ranks).  Raises ``ValueError`` when E does not divide the
    experts."""
    B, S, d = h.shape
    if check_context(ctx) is None:
        out, aux = moe_mod.moe_ffn(p_moe, h.reshape(-1, d), cfg)
        return out.reshape(B, S, d), aux
    E = ctx.tp_size
    seq = S % E == 0
    groups = ctx.dp_groups(B)
    b = B // groups
    outs, auxes = [], []
    for g in range(groups):
        hg = h[g * b:(g + 1) * b]
        if seq:          # rank r: rows [r S/E, (r + 1) S/E) of each sample
            x = hg.reshape(b, E, S // E, d).transpose(0, 1).reshape(
                E, b * S // E, d)
        else:            # every rank: all of the group's tokens
            x = hg.reshape(1, b * S, d).expand(E, b * S, d)
        out, aux = moe_mod.moe_ffn_ep(p_moe, x, cfg)
        outs.append(out.reshape(E, b, S // E, d).transpose(0, 1).reshape(
            b, S, d) if seq else out[0].reshape(b, S, d))
        auxes.append(aux)
    aux = dict(auxes[0])
    if groups > 1:
        mean = torch.stack([a["moe_aux"] for a in auxes]).mean()
        aux["moe_aux"] = mean + (aux["moe_aux"] - mean).detach()
    return torch.cat(outs), aux


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


def _block(pl, h, positions, cfg, ctx=None, *, window=None,
           cross_feats=None):
    """One pre-norm layer of any stack (``cross_feats``: the audio
    decoder's, :func:`_dense_block`).  Returns (h, entry, aux): the
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
        h, entry = _dense_block(pl, h, positions, cfg, window=window,
                                cross_feats=cross_feats)
        return h, entry, {}
    attn_out, entry = _attention(pl["attn"], _norm(h, pl["ln1"], cfg),
                                 positions, cfg, window=window)
    h = h + attn_out
    out, aux = _moe_apply(pl["moe"], _norm(h, pl["ln2"], cfg), cfg, ctx)
    return h + out, entry, aux


def encode(params, frames, cfg: ModelConfig, *,
           remat: bool = False) -> torch.Tensor:
    """The audio family's encoder: ``frames`` (B, S_enc, d), precomputed
    frame embeddings, cast to the parameters' dtype, plus ``enc_pos``,
    through ``enc_blocks`` (non-causal, no rotation; each under
    ``torch.utils.checkpoint`` with ``remat`` under grad) and
    ``enc_norm``.  Returns (B, S_enc, d)."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the audio family needs frames= "
                         f"(B, S_enc, d) frame embeddings")
    pos = params["enc_pos"]
    enc = torch.as_tensor(frames, device=pos.device).to(pos.dtype)
    enc = enc + pos[: enc.shape[1]]
    for i in range(cfg.encoder_layers):
        enc, _ = _run_block(remat, _dense_block,
                            layer(params["enc_blocks"], i), enc, None, cfg,
                            causal=False)
    return _norm(enc, layer(params["enc_norm"], 0), cfg)


def project_patches(pj, patches, dtype) -> torch.Tensor:
    """The vlm family's projector: ``patches`` (B, P, vision_dim) in
    ``dtype`` -> (B, P, d), the reference's formula in that dtype: a
    LayerNorm of the population variance with its own eps 1e-6 (not
    ``cfg.norm_eps``), then ``fc1``, the tanh GELU, ``fc2``."""
    x = torch.as_tensor(patches, device=pj["fc1"].device).to(dtype)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + 1e-6) * pj["ln_w"] + pj["ln_b"]
    return F.gelu(x @ pj["fc1"], approximate="tanh") @ pj["fc2"]


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: Optional[ParallelContext] = None, *,
            frames=None, patches=None, remat: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, S) -> hidden (B, S_total, d) after the final norm, aux.

    audio: ``frames`` (B, S_enc, d) precomputed frame embeddings through
    :func:`encode` first; every decoder layer cross-attends to its output,
    returned as ``aux["encoder_out"]``.  vlm: ``patches`` (B,
    vision_tokens, vision_dim) through :func:`project_patches`, prepended
    to the text, so S_total = vision_tokens + S and the text's positions
    start at vision_tokens.  aux: for MoE ``moe_aux``, the mean over the
    MoE layers, and ``moe_dropped``, their sum; {} for the dense, hybrid
    and ssm families.  ``remat``: each block (the encoder's too) under
    ``torch.utils.checkpoint`` when grad is enabled, the same values.
    ``ctx``: the embedding through the sharded bag and the MoE layers
    expert-parallel (:func:`embed_tokens`, :func:`_moe_apply`); every
    other layer computes what it computes without one."""
    _require_ported(cfg)
    h = embed_tokens(params, tokens, cfg, ctx)
    aux: Dict[str, torch.Tensor] = {}
    cross = None
    if cfg.family == "vlm":
        if patches is None:
            raise ValueError(f"{cfg.name}: the vlm forward needs patches= "
                             f"(B, {cfg.vision_tokens}, {cfg.vision_dim})")
        h = torch.cat([project_patches(params["projector"], patches,
                                       h.dtype), h], dim=1)
    if cfg.family == "audio":
        cross = aux["encoder_out"] = encode(params, frames, cfg,
                                            remat=remat)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device).expand(B, S)
    auxes = []
    for name, n, windows in block_stacks(cfg):
        for i in range(n):
            h, _, a = _run_block(remat, _block, layer(params[name], i), h,
                                 positions, cfg, ctx, window=windows[i],
                                 cross_feats=cross)
            if a:
                auxes.append(a)
    if auxes:
        aux = {"moe_aux": torch.stack([a["moe_aux"] for a in auxes]).mean(),
               "moe_dropped": torch.stack(
                   [a["moe_dropped"] for a in auxes]).sum(dtype=torch.int32)}
    return _norm(h, layer(params["final_norm"], 0), cfg), aux
