"""One-sided row puts -- the remote cold tier's row-fetch kernel: wrapper
and plain versions.

The counterpart of ``onesided_fetch_rows`` in
``repro.kernels.onesided_a2a``, the repo's NVSHMEM analogue: every
embedding row a fetch moves is one put issued from inside a kernel.  The
hand-written CUDA kernel ``csrc/onesided_put_rows.cu`` does one simulated
rank's puts per launch, into H exchange buffers named by a device-side
pointer table:

  * :func:`onesided_put_rows` -- the exchange.  ``contribs`` is the
    ``(H_src, H_dst, M, D)`` stack of the H ranks' contributions;
    ``out[q, r] = contribs[r, q]``: rank r's rows for requester q land in
    q's buffer at ``[r]``.  H launches, one per source rank, on one stream;
  * :func:`onesided_fetch_rows` -- the exchange, then each requester's sum
    over owners, ``(H, M, D)``: ``out[q]`` is rank q's fetched rows.  The
    sum lies outside the kernel, as in the reference, and is ``torch.sum``
    over the source axis of ``(H_dst, H_src, M, D)``.  Each row has one
    owner and the other ranks contribute ``0 * row`` (``-0.0`` for a
    negative value), so every element adds the owner's value to zeros and
    the sum returns it bit for bit, in whatever order it is taken.

The wrapper dispatches on the device of the tensor it is given: a CPU
tensor takes the plain version beside it (``*_ref``), a CUDA tensor
launches the kernel, anything else raises.  Each kernel launch adds one to
``LAUNCH_COUNTS["onesided_put_rows"]``; the plain versions count nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build

LAUNCH_COUNTS = {"onesided_put_rows": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _kernel():
    lib = _build.load("onesided_put_rows")
    fn = lib.onesided_put_rows
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, I, I, LL, LL, I, I, P]
        fn.restype = I
        lib.put_rows_error_string.argtypes = [I]
        lib.put_rows_error_string.restype = ctypes.c_char_p
    return lib


# --- plain versions (what CPU tensors take) ---------------------------------

def onesided_put_rows_ref(contribs: torch.Tensor) -> torch.Tensor:
    """Plain exchange: ``out[dst][r] = contribs[r][dst]`` for every
    (r, dst), by indexing."""
    H = contribs.shape[0]
    out = torch.empty_like(contribs)
    for r in range(H):
        for dst in range(H):
            out[dst][r] = contribs[r][dst]
    return out


def onesided_fetch_rows_ref(contribs: torch.Tensor) -> torch.Tensor:
    """Plain row fetch: the plain exchange, then the sum over owners."""
    return onesided_put_rows_ref(contribs).sum(dim=1)


# --- wrappers ---------------------------------------------------------------

def onesided_put_rows(contribs: torch.Tensor) -> torch.Tensor:
    """The exchange of the row fetch: ``(H_src, H_dst, M, D)`` f32/bf16
    contributions -> ``(H_dst, H_src, M, D)``, one kernel launch per source
    rank, each putting its H * M rows into the requesters' buffers."""
    if contribs.device.type == "cpu":
        return onesided_put_rows_ref(contribs)
    if contribs.device.type != "cuda":
        raise ValueError(
            f"the put kernel runs on CUDA tensors (got {contribs.device}); "
            f"CPU tensors take the plain version")
    if contribs.dtype not in _DTYPE_CODES:
        raise TypeError(f"contribs must be one of {tuple(_DTYPE_CODES)}, "
                        f"got {contribs.dtype}")
    if contribs.dim() != 4 or contribs.shape[0] != contribs.shape[1]:
        raise ValueError(f"contribs must be (H, H, M, D), got "
                         f"{tuple(contribs.shape)}")
    if not contribs.is_contiguous():
        raise ValueError("contribs must be contiguous")
    H, _, M, D = contribs.shape
    out = torch.empty_like(contribs)
    if M == 0 or D == 0:
        return out
    item = contribs.element_size()
    # the H destination buffers' addresses, a table on the card; it is
    # referenced until the launches below are enqueued, and any later reuse
    # of its memory is ordered after them on the same stream
    ptrs = torch.tensor([out[q].data_ptr() for q in range(H)],
                        dtype=torch.int64, device=contribs.device)
    vec = (D * item) % 16 == 0 and contribs.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    lib = _kernel()
    with torch.cuda.device(contribs.device):
        stream = torch.cuda.current_stream(contribs.device).cuda_stream
        for r in range(H):
            rc = lib.onesided_put_rows(
                contribs[r].data_ptr(), ptrs.data_ptr(), r, H, M, D,
                _DTYPE_CODES[contribs.dtype], int(vec), stream)
            if rc != 0:
                raise RuntimeError(
                    f"onesided_put_rows launch failed: "
                    f"{lib.put_rows_error_string(rc).decode()} ({rc})")
            LAUNCH_COUNTS["onesided_put_rows"] += 1
    return out


def onesided_fetch_rows(contribs: torch.Tensor) -> torch.Tensor:
    """Row-fetch gather: ``(H_src, H_dst, M, D)`` contributions -> each
    requester's ``(M, D)`` fetched rows, stacked ``(H, M, D)``.  The sum
    over owners runs after the puts on the same stream, so it starts once
    every put has landed."""
    return onesided_put_rows(contribs).sum(dim=1)
