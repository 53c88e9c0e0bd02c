"""State-space sequence mixers, Mamba (S6, Hymba's SSM heads) and RWKV-6
(Finch): the counterpart of ``repro.models.ssm``, with its names.

Both have a full-sequence form (prefill, forward) and a single-step form
carrying O(1) state (decode).

Mamba recurrence (per channel c, state n):
    h_t = exp(dt_t A)[c,n] h_{t-1} + dt_t B_t[n] x_t[c]
    y_t[c] = sum_n C_t[n] h_t[c,n] + D[c] x_t[c]
computed chunk by chunk, a log-depth doubling scan inside each chunk
(the reference's ``associative_scan``), the chunks in a Python loop
carrying ``h`` (its ``lax.scan``).

RWKV-6 recurrence (per head, hs x hs state S):
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
with the Finch data-dependent decay w_t = exp(-exp(w0 + lora(x_t))).

Dtypes as in the reference: projections in the parameters' dtype, the
scans and decays in f32, the per-head group norm in ``x.dtype``.  The
scans are stock torch ops on tensors (the reference's are XLA's lowering
of ``lax.scan`` / ``associative_scan``, no Pallas kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

# the per-head group norm's epsilon (the reference's)
GROUP_NORM_EPS = 64e-5


def _full(n, shape, value, dtype, device):
    return torch.full((n,) + tuple(shape), value, dtype=dtype, device=device)


# ===========================================================================
# Mamba (S6) -- the SSM heads of Hymba
# ===========================================================================

def init_mamba_params(gen: torch.Generator, n: int, cfg: ModelConfig,
                      dtype=torch.float32, device=None, keep=None):
    """``n`` stacked Mamba mixers, the reference's layout and scales
    (every matrix at the fan-in of its first axis; ``keep`` maps a
    matrix's name to the part of each layer kept)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    dt_rank = max(1, math.ceil(d / 16))
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=device))

    k = keep or {}

    def dense(i, o, name):
        return layers.stacked_dense_init(gen, n, i, o, dtype=dtype,
                                         device=device, keep=k.get(name))

    return {
        "in_proj": dense(d, 2 * di, "in_proj"),            # x and z (gate)
        "conv_w": dense(cfg.ssm_conv, di, "conv_w"),
        "conv_b": _full(n, (di,), 0.0, dtype, device),
        "x_proj": dense(di, dt_rank + 2 * N, "x_proj"),
        "dt_proj": dense(dt_rank, di, "dt_proj"),
        "dt_bias": _full(n, (di,), 0.0, dtype, device),
        # S4D-real init: A = -(1..N) per channel
        "A_log": A_log.expand(n, di, N).to(dtype).contiguous(),
        "D": _full(n, (di,), 1.0, dtype, device),
        "out_proj": dense(di, d, "out_proj"),
    }


def _mamba_gates(p, x, cfg: ModelConfig):
    """x (B, S, d) -> (xs, z), each (B, S, di): the input projection's two
    halves."""
    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    return xs, z


def _mamba_ssm_inputs(p, xs, cfg: ModelConfig):
    """xs (B, S, di) -> (dt (B, S, di), Bc, Cc (B, S, N), A (di, N) f32)."""
    N = cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    proj = xs @ p["x_proj"]                              # (B, S, dt_rank+2N)
    dt = F.softplus(proj[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])
    Bc = proj[..., dt_rank: dt_rank + N]
    Cc = proj[..., dt_rank + N:]
    A = -torch.exp(p["A_log"].float())
    return dt, Bc, Cc, A


def _causal_conv(xs, w, b, conv_state=None):
    """Depthwise causal conv1d, then SiLU.  xs (B, S, di), w (K, di).
    Returns (y, new_state): ``conv_state`` (B, K-1, di) carries the last
    K-1 inputs (K-1 zero rows for a fresh sequence; the reference's
    ``zeros_like(xs[:, :K-1])`` has only S rows when S < K-1, and its
    forward raises on such a prompt)."""
    K = w.shape[0]
    B, S, di = xs.shape
    pad = xs.new_zeros((B, K - 1, di)) if conv_state is None \
        else conv_state
    xp = torch.cat([pad, xs], dim=1)                     # (B, S+K-1, di)
    y = sum(xp[:, i: i + S] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu(y), new_state


def mamba_conv_state(p, x, cfg: ModelConfig):
    """The ``conv_state`` that decode carries after the prompt x (B, S,
    d): the last K-1 pre-conv inputs (``x @ in_proj``, first half), zeros
    in front of a prompt shorter than K-1, as :func:`_causal_conv` pads
    it.  Only those rows are projected."""
    K = cfg.ssm_conv
    xs, _ = _mamba_gates(p, x[:, -(K - 1):], cfg)
    return torch.cat([torch.zeros_like(xs[:, :K - 1 - xs.shape[1]]), xs],
                     dim=1)


def _doubling_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 from h = 0:
    returns (prod a_{<=t}, h_t), each like ``a``.  Log-depth (Hillis and
    Steele): at stride s every step t >= s combines with step t - s,
    (a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r + b_r), the reference's
    ``associative_scan`` combine, into a second buffer.  Under grad, with
    an input that needs one, each stride's result is a new tensor (the
    same values: autograd differentiates no ``out=`` op and no buffer
    written after use)."""
    n = a.shape[1]
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        s = 1
        while s < n:
            a, b = (torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1),
                    torch.cat([b[:, :s], torch.addcmul(b[:, s:], b[:, :-s],
                                                       a[:, s:])], dim=1))
            s *= 2
        return a, b
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    s = 1
    while s < n:
        a2[:, :s] = a[:, :s]
        b2[:, :s] = b[:, :s]
        torch.mul(a[:, :-s], a[:, s:], out=a2[:, s:])
        torch.addcmul(b[:, s:], b[:, :-s], a[:, s:], out=b2[:, s:])
        a, a2, b, b2 = a2, a, b2, b
        s *= 2
    return a, b


def mamba_forward(p, x, cfg: ModelConfig, *, chunk: int = 128):
    """Full-sequence Mamba mixer: x (B, S, d) -> (y (B, S, d), h_final
    (B, di, N) f32).  Chunks of ``chunk`` steps, each a doubling scan of
    (B, chunk, di, N) f32 transitions carrying ``h`` from the chunk
    before; the last chunk may be shorter (the reference pads it with
    zeros, identity steps: the same values)."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    xs, z = _mamba_gates(p, x, cfg)
    xs, _ = _causal_conv(xs, p["conv_w"], p["conv_b"])
    dt, Bc, Cc, A = _mamba_ssm_inputs(p, xs, cfg)

    chunk = min(chunk, S)
    h = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, S, chunk):
        dtc = dt[:, lo:lo + chunk]
        a = torch.exp(dtc[..., None].float() * A)                # (B,c,di,N)
        bx = (dtc * xs[:, lo:lo + chunk])[..., None].float() * \
            Bc[:, lo:lo + chunk, None, :].float()
        aa, bb = _doubling_scan(a, bx)
        hc = torch.addcmul(bb, aa, h[:, None])
        ys.append(torch.einsum("bcdn,bcn->bcd", hc,
                               Cc[:, lo:lo + chunk].float()))
        h = hc[:, -1]
    y = torch.cat(ys, dim=1)
    y = (y + xs * p["D"]).to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], h


def mamba_decode_step(p, x, cfg: ModelConfig, h, conv_state):
    """One token: x (B, 1, d); h (B, di, N) f32; conv_state (B, K-1, di).
    Returns (y (B, 1, d), h, conv_state), new tensors."""
    xs, z = _mamba_gates(p, x, cfg)
    xs, conv_state = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_state)
    dt, Bc, Cc, A = _mamba_ssm_inputs(p, xs, cfg)
    a = torch.exp(dt[:, 0, :, None].float() * A)                 # (B,di,N)
    bx = (dt * xs)[:, 0, :, None].float() * Bc[:, 0, None, :].float()
    h = a * h + bx
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0].float())[:, None]
    y = (y + xs * p["D"]).to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], h, conv_state


# ===========================================================================
# RWKV-6 (Finch)
# ===========================================================================

def init_rwkv_params(gen: torch.Generator, n: int, cfg: ModelConfig,
                     dtype=torch.float32, device=None, keep=None):
    """``n`` stacked RWKV-6 layers (time mix and channel mix), the
    reference's layout and scales (``keep`` maps a matrix's name to the
    part of each layer kept)."""
    d = cfg.d_model
    lora = 64

    k = keep or {}

    def dense(i, o, name):
        return layers.stacked_dense_init(gen, n, i, o, dtype=dtype,
                                         device=device, keep=k.get(name))

    return {
        # token-shift interpolation weights (static mu per stream)
        "mu": _full(n, (5, d), 0.5, dtype, device),        # r, k, v, w, g
        "w_r": dense(d, d, "w_r"),
        "w_k": dense(d, d, "w_k"),
        "w_v": dense(d, d, "w_v"),
        "w_g": dense(d, d, "w_g"),
        "w_o": dense(d, d, "w_o"),
        # Finch data-dependent decay lora: w = exp(-exp(w0 + tanh(xA)B))
        "w0": _full(n, (d,), -6.0, dtype, device),
        "w_A": dense(d, lora, "w_A"),
        "w_B": dense(lora, d, "w_B"),
        "u": _full(n, (d,), 0.0, dtype, device),           # bonus
        "ln_w": _full(n, (d,), 1.0, dtype, device),        # per-head norm
        "ln_b": _full(n, (d,), 0.0, dtype, device),
        # channel mix
        "mu_c": _full(n, (2, d), 0.5, dtype, device),
        "ck": dense(d, cfg.d_ff, "ck"),
        "cv": dense(cfg.d_ff, d, "cv"),
        "cr": dense(d, d, "cr"),
    }


def _shifted(x, x_last):
    """x shifted right by one token: ``x_last`` (B, d) (decode's carried
    token) or zeros in front."""
    first = torch.zeros_like(x[:, :1]) if x_last is None else x_last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _rwkv_mix_inputs(p, x, x_prev, cfg: ModelConfig):
    """Token-shifted projections for one or more steps: x, x_prev (B, S,
    d).  Returns r, k, v, w (the decay, in x's dtype), each (B, S, H, hs),
    and the gate g (B, S, d)."""
    hs = cfg.rwkv_head_size
    H = cfg.d_model // hs
    mu = p["mu"]                                         # (5, d)

    def mix(i):
        return x + (x_prev - x) * mu[i]

    r = mix(0) @ p["w_r"]
    k = mix(1) @ p["w_k"]
    v = mix(2) @ p["w_v"]
    xw = mix(3)
    g = F.silu(mix(4) @ p["w_g"])
    w = torch.exp(-torch.exp(
        (p["w0"] + torch.tanh(xw @ p["w_A"]) @ p["w_B"]).float()))

    def hview(a):
        return a.reshape(a.shape[0], a.shape[1], H, hs)

    return hview(r), hview(k), hview(v), g, hview(w.to(x.dtype))


def _rwkv_out(p, y, g, x):
    """y (B, S, H, hs) f32 -> the time mix's output (B, S, d): per-head
    group norm in x's dtype, the affine, the gate, ``w_o``."""
    B, S, d = x.shape
    y = y.to(x.dtype)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = ((y - mean) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(B, S, d)
    y = (y * p["ln_w"] + p["ln_b"]) * g
    return y @ p["w_o"]


def rwkv_time_mix(p, x, cfg: ModelConfig, *, state=None, x_last=None):
    """Full-sequence time mix by the per-step scan: x (B, S, d) -> (y,
    (final_state (B, H, hs, hs) f32, last_x (B, d))).  ``state`` and
    ``x_last`` carry decode's state; None for a fresh sequence."""
    B, S, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    r, k, v, g, w = _rwkv_mix_inputs(p, x, _shifted(x, x_last), cfg)
    u = p["u"].reshape(H, hs).float()
    St = (torch.zeros((B, H, hs, hs), dtype=torch.float32, device=x.device)
          if state is None else state)
    ys = []
    for t in range(S):
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]                 # (B,H,hs,hs)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt,
                               St + u[..., None] * kv))
        St = wt[..., :, None] * St + kv
    return _rwkv_out(p, torch.stack(ys, dim=1), g, x), (St, x[:, -1])


def rwkv_time_mix_chunked(p, x, cfg: ModelConfig, *, chunk: int = 64,
                          state=None, x_last=None):
    """Chunk-parallel time mix, equal to :func:`rwkv_time_mix` up to f32
    rounding, with the state materialised at chunk boundaries only.

    Within a chunk of C tokens (per head, state S[k, v], decay w_t[k]):
        P_t[k] = prod_{i<=t} w_i[k]           (log-space cumsum)
        y_t = (r_t . P_{t-1} ⊙ S_0) + sum_{i<t} ((r_t⊙P_{t-1})·(k_i/P_i)) v_i
              + (r_t·k_t) u ⊙ v_t                      [diagonal bonus]
        S_C = P_C ⊙ S_0 + (K ⊙ P_C/P)^T V
    one (C, C) matrix per head per chunk.  The last chunk may be shorter
    (the reference pads it with inert steps: the same values)."""
    B, S, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    C = min(chunk, S)
    r, k, v, g, w = _rwkv_mix_inputs(p, x, _shifted(x, x_last), cfg)
    u = p["u"].reshape(H, hs).float()
    St = (torch.zeros((B, H, hs, hs), dtype=torch.float32, device=x.device)
          if state is None else state)
    ys = []
    for lo in range(0, S, C):
        rb, kb, vb, wb = (a[:, lo:lo + C].float() for a in (r, k, v, w))
        n = rb.shape[1]
        lw = torch.log(torch.clamp(wb, min=1e-38))
        logP = torch.cumsum(lw, dim=1)                 # P_t (log), t = 1..n
        r_dec = rb * torch.exp(logP - lw)              # r_t ⊙ P_{t-1}
        k_grow = kb * torch.exp(-logP)                 # k_i / P_i
        # A[t, i] = (r_t⊙P_{t-1})·(k_i/P_i), strictly causal (i < t)
        A = torch.einsum("bthk,bihk->bhti", r_dec, k_grow)
        A = A.masked_fill(~torch.ones((n, n), dtype=torch.bool,
                                      device=x.device).tril(-1), 0.0)
        y = torch.einsum("bhti,bihv->bthv", A, vb)
        y = y + torch.einsum("bthk,bhkv->bthv", r_dec, St)
        diag = torch.einsum("bthk,hk->bth", rb * kb, u)
        ys.append(y + diag[..., None] * vb)
        PC = torch.exp(logP[:, -1])                    # (B, H, hs)
        St = PC[..., None] * St + torch.einsum(
            "bthk,bthv->bhkv", kb * torch.exp(logP[:, -1:] - logP), vb)
    return _rwkv_out(p, torch.cat(ys, dim=1), g, x), (St, x[:, -1])


def rwkv_channel_mix(p, x, cfg: ModelConfig, *, x_last=None):
    """Channel mix (the rwkv FFN): squared ReLU with token shift.  Returns
    (out (B, S, d), last_x (B, d))."""
    x_prev = _shifted(x, x_last)
    mu = p["mu_c"]
    xk = x + (x_prev - x) * mu[0]
    xr = x + (x_prev - x) * mu[1]
    k = torch.square(F.relu(xk @ p["ck"]))
    return torch.sigmoid(xr @ p["cr"]) * (k @ p["cv"]), x[:, -1]
