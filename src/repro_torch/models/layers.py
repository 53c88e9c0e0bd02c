"""Shared LM building blocks: the counterpart of ``repro.models.layers``.

Parameters are nested dicts of tensors, every module an ``init_*`` /
``apply`` pair, as in the reference.  Conventions:

  * activations   (B, S, D) unless stated
  * attention     q (B, S, H, hd), kv (B, S, KH, hd), GQA via head groups
  * stacked layers: a leading ``(num_layers, ...)`` axis, walked by a
    Python loop (the reference scans it)
  * long sequences: :func:`attention` sends self-attention over more than
    ``chunk_threshold`` keys to the flash kernel
    (``kernels/flash_attention.py``; on a CPU tensor its plain version,
    :func:`chunked_attention`), except a shape the kernel does not take
    (MLA's hd_v != hd) and any input that needs a gradient under grad
    (the kernel has no backward), which go to :func:`chunked_attention`
    on any device, as every long shape does in the reference
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (  # noqa: F401
    chunked_attention,
    flash_attention,
)


# ---------------------------------------------------------------------------
# Param init helpers
# ---------------------------------------------------------------------------

def stacked_init(gen: torch.Generator, n: int, shape, fan_in: int, *,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, *shape) truncated-normal (-2, 2) draws scaled by
    ``fan_in ** -0.5``, drawn one layer at a time in f32 so the
    temporaries stay one layer's size."""
    shape = tuple(shape)
    out = torch.empty((n,) + shape, dtype=dtype, device=device)
    tmp = torch.empty(shape, dtype=torch.float32, device=device)
    for i in range(n):
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out[i] = tmp.mul_(fan_in ** -0.5)
    return out


def stacked_dense_init(gen: torch.Generator, n: int, in_dim: int,
                       out_dim: int, *, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """(n, in, out) matrices at fan-in scale (:func:`stacked_init`)."""
    return stacked_init(gen, n, (in_dim, out_dim), in_dim, dtype=dtype,
                        device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * weight.float()).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def activation_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        # Nemotron-4: squared ReLU
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    """(head_dim/2,) inverse frequencies, f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, *, theta: float = 10000.0):
    """Rotate the halves (half-split) in f32.  x: (..., S, H, hd),
    positions (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    ang = positions[..., :, None].float() * inv             # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention -- full (short sequences) and the flash kernel (long ones)
# ---------------------------------------------------------------------------

def _expand_kv(k, H: int):
    """(B, S, KH, hd) -> (B, S, H, hd) by repeating groups (GQA)."""
    KH = k.shape[2]
    if KH == H:
        return k
    return torch.repeat_interleave(k, H // KH, dim=2)


def full_attention(q, k, v, *, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0,
                   scale: Optional[float] = None):
    """Naive (S_q, S_k) attention, the path for short sequences.

    ``q_offset``: absolute position of q[0] relative to k[0]."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scale = scale if scale is not None else hd ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


# calls of :func:`attention`'s chunked route (the flash kernel counts its
# own launches in ``kernels/flash_attention.LAUNCH_COUNTS``)
CALL_COUNTS = {"chunked_attention": 0}


def reset_call_counts() -> None:
    for name in CALL_COUNTS:
        CALL_COUNTS[name] = 0


def attention(q, k, v, *, causal=True, window=None, q_offset: int = 0,
              scale=None, chunk_threshold: int = 8192):
    """The reference's dispatch: full attention for at most
    ``chunk_threshold`` keys (or a q shorter than k), beyond it the
    flash kernel, which takes ``scale = hd ** -0.5`` and ``hd_v == hd``
    and computes no gradient.  Any other long shape (MLA's q/k at hd 192
    against v at 128), and any long input that needs a gradient under
    grad (training), goes to :func:`chunked_attention`, the reference's
    formulation, on either device, and adds one to
    ``CALL_COUNTS["chunked_attention"]``."""
    Sk = k.shape[1]
    if Sk <= chunk_threshold or q.shape[1] != Sk:
        return full_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, scale=scale)
    hd = q.shape[-1]
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if (grad or (scale is not None and scale != hd ** -0.5)
            or v.shape[-1] != hd):
        CALL_COUNTS["chunked_attention"] += 1
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
    return flash_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Decode attention (flash-decode partials)
# ---------------------------------------------------------------------------

def decode_attention_partial(q, k_cache, v_cache, length, *, scale=None,
                             window: Optional[int] = None, kv_offset=0):
    """One-token attention over a KV cache (slice).

    q: (B, 1, H, hd); caches: (B, Sc, KH, hd) whose absolute positions
    start at ``kv_offset``; ``length``: the valid context length, a scalar
    or (B, 1) (positions >= length are masked).  Returns the unnormalised
    flash-decode triple (o (B, H, hd), m (B, H), l (B, H)).

    The reference repeats K/V to H heads; here the heads are grouped as
    (KH, G) against the cache as it is, which is the same arithmetic
    without an H-head copy of the cache."""
    B, _, H, hd = q.shape
    Sc, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    scale = scale if scale is not None else hd ** -0.5
    qg = q.float().reshape(B, KH, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg,
                     k_cache.float()).reshape(B, H, Sc) * scale
    pos = kv_offset + torch.arange(Sc, device=q.device)
    if torch.is_tensor(length) and length.dim():
        valid = pos[None, :] < length
        if window is not None:
            valid = valid & (pos[None, :] >= length - window)
    else:
        valid = pos < length
        if window is not None:
            valid = valid & (pos >= length - window)
    valid = torch.broadcast_to(valid, (B, Sc))[:, None, :]
    s = s.masked_fill(~valid, -1e30)
    m = s.amax(dim=-1)                                        # (B, H)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)                                         # (B, H)
    o = torch.einsum("bkgs,bskd->bkgd", p.reshape(B, KH, G, Sc),
                     v_cache.float()).reshape(B, H, -1)       # unnormalised
    return o, m, l


def combine_decode_partials(o, m, l, rank_dim: Optional[int] = None):
    """Normalise flash-decode triples.  With ``rank_dim`` the triples of
    the simulated ranks are stacked along that dim of ``o``, ``m`` and
    ``l`` (each rank's over its slice of the cache) and combine as the
    reference's ``pmax``/``psum`` over the mesh axis do: ``m* = max m``,
    ``l* = sum l e^(m - m*)``, ``o* = sum o e^(m - m*)``, then ``o* /
    l*``."""
    if rank_dim is not None:
        m_star = m.amax(dim=rank_dim, keepdim=True)
        scale = torch.exp(m - m_star)
        l = (l * scale).sum(dim=rank_dim)
        o = (o * scale[..., None]).sum(dim=rank_dim)
    return o / torch.clamp(l, min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def init_ffn(gen: torch.Generator, n: int, d: int, d_ff: int, *,
             gated: bool = True, dtype=torch.float32, device=None):
    p = {"up": stacked_dense_init(gen, n, d, d_ff, dtype=dtype,
                                  device=device),
         "down": stacked_dense_init(gen, n, d_ff, d, dtype=dtype,
                                    device=device)}
    if gated:
        p["gate"] = stacked_dense_init(gen, n, d, d_ff, dtype=dtype,
                                       device=device)
    return p


def apply_ffn(p, x, act: str):
    h = x @ p["up"]
    if "gate" in p:
        h = activation_fn(act)(x @ p["gate"]) * h
    else:
        h = activation_fn(act)(h)
    return h @ p["down"]
