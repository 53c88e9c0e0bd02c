"""Multi-head Latent Attention (DeepSeek-V3): the counterpart of
``repro.models.mla``, the full-sequence and the absorbed decode paths.

The KV cache holds only the compressed latent per token, ``c_kv``
(kv_lora) and the shared ``k_rope`` (rope): 576 values a token at
deepseek's widths against 2 * 128 * 128 = 32,768 for a GQA K/V cache of
its 128 heads.  Decode uses the absorbed formulation: ``w_uk`` is folded
into the query and ``w_uv`` into the output, so scores and context live
in the latent space and a step never expands the cache to 128 heads.

The decode partial returns the flash-decode triple ``(ctx, m, l)`` in
latent space, combined by ``layers.combine_decode_partials`` as GQA's is,
also across the simulated ranks of a sequence-sharded cache
(``models/decode.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models import layers


def init_mla_params(gen: torch.Generator, n: int, cfg: ModelConfig,
                    dtype=torch.float32, device=None):
    """Stacked (n, ...) MLA parameters, the reference's layout:
    ``w_dq`` (d, q_lora), ``q_norm``, ``w_uq`` (q_lora, H * (nope +
    rope)), ``w_dkv`` (d, kv_lora + rope), ``kv_norm``, ``w_uk`` (kv_lora,
    H, nope), ``w_uv`` (kv_lora, H, v) and ``w_o`` (H * v, d), each matrix
    truncated-normal at its fan-in scale (``layers.stacked_init``)."""
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim

    def stack(shape, fan_in):
        return layers.stacked_init(gen, n, shape, fan_in, dtype=dtype,
                                   device=device)

    def ones(width):
        return torch.ones((n, width), dtype=dtype, device=device)

    return {
        "w_dq": stack((d, m.q_lora_rank), d),
        "q_norm": ones(m.q_lora_rank),
        "w_uq": stack((m.q_lora_rank, H * qk), m.q_lora_rank),
        "w_dkv": stack((d, m.kv_lora_rank + m.qk_rope_head_dim), d),
        "kv_norm": ones(m.kv_lora_rank),
        "w_uk": stack((m.kv_lora_rank, H, m.qk_nope_head_dim),
                      m.kv_lora_rank),
        "w_uv": stack((m.kv_lora_rank, H, m.v_head_dim), m.kv_lora_rank),
        "w_o": stack((H * m.v_head_dim, d), H * m.v_head_dim),
    }


def _project_q(p, x, cfg: ModelConfig, positions):
    """x (B, S, d) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope)."""
    m = cfg.mla
    cq = layers.rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(
        x.shape[0], x.shape[1], cfg.num_heads,
        m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = layers.apply_rope(q[..., m.qk_nope_head_dim:], positions,
                               theta=cfg.rope_theta)
    return q_nope, q_rope


def latent_kv(p, x, cfg: ModelConfig, positions):
    """x (B, S, d) -> (c_kv (B, S, kv_lora), k_rope (B, S, rope)): the
    cache entry."""
    m = cfg.mla
    ckv = x @ p["w_dkv"]
    c_kv = layers.rms_norm(ckv[..., : m.kv_lora_rank], p["kv_norm"],
                           cfg.norm_eps)
    k_rope = layers.apply_rope(ckv[..., None, m.kv_lora_rank:], positions,
                               theta=cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_attention(p, x, positions, cfg: ModelConfig, *, causal=True):
    """Full-sequence MLA (prefill).  Returns (out (B, S, d), (c_kv,
    k_rope)).

    Up to ``cfg.attn_chunk_threshold`` keys: two f32 einsums, the rope
    term contracting the SHARED ``k_rope`` directly ("bqhr,bkr->bhqk"),
    never broadcast to H heads; the (B, H, S, S) f32 scores are
    materialised (2.05 GB each at deepseek's 128 heads and S = 2,000).
    Beyond it: q and k concatenated at hd nope + rope against v at hd v,
    through ``layers.attention``, which sends that shape to
    ``chunked_attention``."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _project_q(p, x, cfg, positions)
    c_kv, k_rope = latent_kv(p, x, cfg, positions)
    k_nope = torch.einsum("bsk,khn->bshn", c_kv, p["w_uk"])
    v = torch.einsum("bsk,khv->bshv", c_kv, p["w_uv"])
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5

    if S <= cfg.attn_chunk_threshold:
        s = torch.einsum("bqhn,bkhn->bhqk", q_nope.float(), k_nope.float())
        s += torch.einsum("bqhr,bkr->bhqk", q_rope.float(), k_rope.float())
        s *= scale
        if causal:
            qpos = torch.arange(S, device=x.device)
            s.masked_fill_(~(qpos[None, :] <= qpos[:, None]), -1e30)
        pr = torch.softmax(s, dim=-1)
        del s
        o = torch.einsum("bhqk,bkhv->bqhv", pr, v.float()).to(x.dtype)
    else:
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, m.qk_rope_head_dim)], dim=-1)
        o = layers.attention(q, k, v, causal=causal, scale=scale,
                             chunk_threshold=cfg.attn_chunk_threshold)
    out = o.reshape(B, S, H * m.v_head_dim) @ p["w_o"]
    return out, (c_kv, k_rope)


def mla_decode_partial(p, x, cfg: ModelConfig, c_kv, k_rope, length, *,
                       kv_offset=0):
    """Absorbed one-token decode over a latent cache (slice).

    x (B, 1, d); c_kv (B, Sc, kv_lora); k_rope (B, Sc, rope) whose
    absolute positions start at ``kv_offset``; ``length`` (B, 1) the valid
    context length, the new token's row included: the query sits at
    ``length - 1``.  Returns the flash triple (ctx (B, H, kv_lora)
    unnormalised, m (B, H), l (B, H)), the context in LATENT space
    (:func:`mla_decode_output` expands it after the combine)."""
    m = cfg.mla
    positions = (length - 1).expand(x.shape[0], 1)            # query position
    q_nope, q_rope = _project_q(p, x, cfg, positions)         # (B, 1, H, .)
    q_abs = torch.einsum("bqhn,khn->bqhk", q_nope, p["w_uk"])  # (B,1,H,kvr)
    s = (torch.einsum("bqhk,bsk->bhs", q_abs.float(), c_kv.float()) +
         torch.einsum("bqhr,bsr->bhs", q_rope.float(), k_rope.float()))
    s = s * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    kpos = kv_offset + torch.arange(c_kv.shape[1], device=x.device)
    valid = kpos[None, :] < length.reshape(-1, 1)
    s = s.masked_fill(~valid[:, None, :], -1e30)
    mx = s.amax(dim=-1)                                       # (B, H)
    pr = torch.exp(s - mx[..., None])
    l = pr.sum(dim=-1)
    ctx = torch.einsum("bhs,bsk->bhk", pr, c_kv.float())
    return ctx, mx, l


def mla_decode_output(p, ctx, x_dtype):
    """Latent context (B, H, kv_lora) -> output (B, 1, d) through the
    absorbed ``w_uv`` and ``w_o``, in f32, cast to ``x_dtype``."""
    v = torch.einsum("bhk,khv->bhv", ctx, p["w_uv"].float())
    return (v.reshape(ctx.shape[0], 1, -1) @ p["w_o"].float()).to(x_dtype)
