"""Flash attention (forward): the wrapper, its plain version and the launch
counts.

Two hand-written CUDA kernels compute the online-softmax attention of
``repro.kernels.flash_attention``:

    o[b, s, h] = softmax_t(hd**-0.5 * q[b, s, h] . k[b, t, h // G]) v[b, t, h // G]

over ``q (B, S, H, hd)``, ``k``/``v (B, S, KH, hd)`` with ``G = H // KH``
(GQA), causal and sliding-window masks (``t > s - window``), padded keys
masked with ``-1e30``, f32 statistics and output in q's dtype.

* ``csrc/flash_attention_wgmma.cu`` (route ``"wgmma"``): bf16 at hd 64 or
  128, on the tensor cores, fed by TMA.  It rounds the probabilities to
  bf16 before P.V, as SDPA does.  Its inputs must meet TMA's rules
  (:func:`check_tma`): 16-byte aligned bases, byte strides multiples of 16.
* ``csrc/flash_attention.cu`` (route ``"simt"``): f32 FMAs on the CUDA
  cores, for f32 inputs (held to 2e-5, which TF32 tensor cores cannot
  meet) and bf16 at hd 16 or 32.

:func:`pick_route` picks the kernel from dtype and hd alone.
:func:`flash_attention` dispatches on the device of ``q``: a CPU tensor
takes the plain version :func:`flash_attention_ref`, which is
:func:`chunked_attention`, the port of ``repro.models.layers
.chunked_attention`` (the reference's oracle of the Pallas kernel); a CUDA
tensor launches its route's kernel and adds one to ``LAUNCH_COUNTS
["flash_attention"]`` and to ``ROUTE_COUNTS[route]``, or raises.  There is
no fallback: a build or launch failure of either kernel raises, and an
input that breaks TMA's rules raises rather than taking the SIMT route.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as _build

LAUNCH_COUNTS = {"flash_attention": 0}
ROUTE_COUNTS = {"wgmma": 0, "simt": 0}

HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for counts in (LAUNCH_COUNTS, ROUTE_COUNTS):
        for name in counts:
            counts[name] = 0


def pick_route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that takes ``dtype`` at head_dim ``hd``: ``"wgmma"`` for
    bf16 at hd 64 or 128, ``"simt"`` for everything else."""
    return ("wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
            else "simt")


def check_tma(name: str, t: torch.Tensor) -> None:
    """Raise unless the (B, S, heads, hd) bf16 tensor ``t`` meets TMA's
    rules: base address 16-byte aligned, the byte strides of batch, seq
    and head multiples of 16, head_dim contiguous."""
    if t.stride(3) != 1:
        raise ValueError(f"{name}: TMA needs a contiguous head dimension")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: TMA needs a 16-byte aligned base address "
                         f"(got {t.data_ptr():#x})")
    size = t.element_size()
    for dim, what in ((0, "batch"), (1, "seq"), (2, "head")):
        if (t.stride(dim) * size) % 16:
            raise ValueError(
                f"{name}: TMA needs byte strides that are multiples of 16; "
                f"the {what} stride is {t.stride(dim) * size} bytes")


def _kernel(route: str):
    if route == "wgmma":
        lib = _build.load("flash_attention_wgmma")
        fn, err = lib.flash_attention_wgmma_fwd, lib.flash_wgmma_error_string
        ints = 7
    else:
        lib = _build.load("flash_attention")
        fn, err = lib.flash_attention_fwd, lib.flash_error_string
        ints = 8
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P] + [I] * ints + [
            ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), P]
        fn.restype = ctypes.c_int
        err.argtypes = [I]
        err.restype = ctypes.c_char_p
    return fn, err


# --- plain version (what CPU tensors take) ----------------------------------

def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_block: int = 1024,
                      kv_block: int = 1024, scale: Optional[float] = None,
                      skip_masked_blocks: bool = True) -> torch.Tensor:
    """Blockwise online-softmax attention that never materialises (S, S):
    q (B, S, H, hd), k (B, S, KH, hd), v (B, S, KH, hd_v) -> (B, S, H,
    hd_v) in q's dtype, computed in f32.

    Each q block walks the kv blocks carrying (m, l, acc); padded keys,
    keys after the query (``causal``) and keys at or before ``query -
    window`` score -1e30.  With ``causal`` and ``skip_masked_blocks``, kv
    blocks wholly above the diagonal are not visited (the reference keeps
    the old carry for them: the same result)."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    hd_v = v.shape[3]
    G = H // KH
    scale = scale if scale is not None else hd ** -0.5
    qb, kb = min(q_block, S), min(kv_block, S)
    nQ, nK = -(-S // qb), -(-S // kb)
    dev = q.device
    qf = q.float().reshape(B, S, KH, G, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, S, H, hd_v), dtype=q.dtype, device=dev)
    for qi in range(nQ):
        q_lo = qi * qb
        qt = qf[:, q_lo:q_lo + qb]                       # (B, qn, KH, G, hd)
        qn = qt.shape[1]
        qpos = q_lo + torch.arange(qb, device=dev)[:qn]
        m = torch.full((B, KH, G, qn), -torch.inf, device=dev)
        l = torch.zeros((B, KH, G, qn), device=dev)
        acc = torch.zeros((B, KH, G, qn, hd_v), device=dev)
        for ki in range(nK):
            k_lo = ki * kb
            if causal and skip_masked_blocks and k_lo > q_lo + qb - 1:
                break
            kt, vt = kf[:, k_lo:k_lo + kb], vf[:, k_lo:k_lo + kb]
            kpos = k_lo + torch.arange(kt.shape[1], device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qt, kt) * scale
            msk = (kpos < S)[None, :].expand(qn, -1)
            if causal:
                msk = msk & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                msk = msk & (kpos[None, :] > qpos[:, None] - window)
            s = s.masked_fill(~msk, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd",
                                                       p, vt)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]    # (B, KH, G, qn, hd)
        out[:, q_lo:q_lo + qn] = o.permute(0, 3, 1, 2, 4).reshape(
            B, qn, H, hd_v).to(q.dtype)
    return out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain ``flash_attention``: :func:`chunked_attention`."""
    return chunked_attention(q, k, v, causal=causal, window=window)


# --- the wrapper --------------------------------------------------------------

def _launch(q, k, v, causal: bool, window: Optional[int],
            route: Optional[str] = None) -> torch.Tensor:
    """One launch of the kernel of ``route`` (by default :func:`pick_route`'s
    choice; ``"simt"`` at bf16 hd 64/128 is for timing the two kernels
    against each other only).  Counts nothing."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(
            f"the flash kernels run on CUDA tensors (got {device}); CPU "
            f"tensors take the plain version")
    for name, t in (("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}: one dtype")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, S, H, hd), k and v (B, S, KH, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    KH = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != hd or H % KH:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}"
                         f" (same B, S, hd; KH dividing H)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous head dimension")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    route = route or pick_route(q.dtype, hd)
    if route == "wgmma":
        if pick_route(q.dtype, hd) != "wgmma":
            raise ValueError(f"the wgmma kernel takes bf16 at hd "
                             f"{WGMMA_HEAD_DIMS}, got {q.dtype} at hd {hd}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma(name, t)
        args = ()
    elif route == "simt":
        args = (_DTYPE_CODES[q.dtype],)
    else:
        raise ValueError(f"route must be 'wgmma' or 'simt', got {route!r}")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    fn, err = _kernel(route)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *args, B, S, H, KH, hd, int(causal),
                0 if window is None else int(window), hd ** -0.5,
                (ctypes.c_longlong * 9)(*strides), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({route}) launch failed: "
                           f"{err(rc).decode()} ({rc})")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, S, KH, hd) -> (B, S, H, hd) in q's dtype,
    scale ``hd ** -0.5``.  One launch of :func:`pick_route`'s kernel on a
    CUDA tensor; the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    route = pick_route(q.dtype, q.shape[-1])
    out = _launch(q, k, v, causal, window, route)
    LAUNCH_COUNTS["flash_attention"] += 1
    ROUTE_COUNTS[route] += 1
    return out
