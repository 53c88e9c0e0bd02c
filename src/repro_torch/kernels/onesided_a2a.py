"""One-sided puts and gets -- the NVSHMEM analogue's kernels: wrappers and
plain versions.

The counterpart of ``repro.kernels.onesided_a2a``, the repo's NVSHMEM
analogue: every exchange is issued from inside a kernel, over the ranks'
buffers named by a table of their addresses, handed to the kernel by
value among its parameters (at most :data:`MAX_RANKS` ranks).  One
hand-written CUDA source, ``csrc/onesided_a2a.cu``, moves whole
contiguous CHUNKS, int32, f32 or bf16, and serves every exchange of the
package with two kernels:

  * :func:`onesided_all_to_all` -- ``(E_src, E_dst, C, ...)`` ->
    ``(E_dst, E_src, C, ...)``: rank r's chunk for d lands in d's buffer
    at ``[r]``, the reference's ``out[i]`` on rank j ``== x[j]`` from rank
    i.  One launch of the put kernel for all E source ranks;
  * :func:`onesided_reduce_scatter` -- ``(E_src, E_dst, M, ...)`` ->
    ``(E_dst, M, ...)``, rank d's sum over sources of their ``[d]``, in
    ``x``'s dtype.  The reference's workaround is the all-to-all, then a
    local sum; here one launch of the pull-sum kernel fuses the two: each
    destination reads its chunk from every source's buffer and sums in
    registers, in the order of ``x.sum(0)`` on the card, so no exchange
    buffer is written;
  * :func:`onesided_ring_permute` -- ``(n, ...)`` -> ``(n, ...)``: rank
    ``(r + shift) % n`` receives rank r's block.  One launch of the put
    kernel for all n source ranks;
  * :func:`onesided_put_rows` -- the remote cold tier's row exchange,
    ``(H_src, H_dst, M, D)`` -> ``(H_dst, H_src, M, D)``: rank r's M rows
    for requester q land in q's buffer at ``[r]``.  The reference issues
    one put per row; those M rows are contiguous on both sides, so here
    they are one chunk put.  One launch for all H source ranks;
  * :func:`onesided_fetch_rows` -- the row exchange, then each requester's
    sum over owners, ``(H, M, D)``: ``out[q]`` is rank q's fetched rows.
    The sum lies outside the kernel, as in the reference.  Each row has
    one owner and the other ranks contribute ``0 * row`` (``-0.0`` for a
    negative value), so every element adds the owner's value to zeros and
    the sum returns it bit for bit, in whatever order it is taken.

Every wrapper dispatches on the device of the tensor it is given: a CPU
tensor takes the plain version beside it (``*_ref``), a CUDA tensor
launches the kernel, anything else raises.  Each kernel launch adds one to
the wrapper's entry in :data:`LAUNCH_COUNTS`; the plain versions count
nothing.  Every call of a wrapper, on either device, adds one to its entry
in :data:`CALL_COUNTS` (``onesided_fetch_rows`` counts as the
``onesided_put_rows`` call it makes).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as _build

LAUNCH_COUNTS = {"onesided_put_rows": 0, "onesided_all_to_all": 0,
                 "onesided_reduce_scatter": 0, "onesided_ring_permute": 0}
# calls of each wrapper, on any device (a CPU tensor's plain version
# too): the launch census of ``repro_torch.analysis.contracts``, which a
# dispatch mode cannot take, since the ctypes launch dispatches nothing
CALL_COUNTS = dict.fromkeys(LAUNCH_COUNTS, 0)

_DTYPE_CODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
# the ranks a launch takes (kMaxRanks of the .cu): the table goes to the
# kernel by value, among its 4 KB of parameters, which would hold 480; the
# pull-sum keeps x.sum(0)'s order only up to 63 sources (the .cu says why)
MAX_RANKS = 63


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _kernel():
    lib = _build.load("onesided_a2a")
    if lib.onesided_a2a_put.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        TAB = ctypes.POINTER(LL)
        lib.onesided_a2a_put.argtypes = [P, TAB, I, I, I, LL, I, I, P]
        lib.onesided_a2a_put.restype = I
        lib.onesided_rs_pull.argtypes = [TAB, P, I, I, I, LL, I, I, P]
        lib.onesided_rs_pull.restype = I
        lib.onesided_ring_put.argtypes = [P, TAB, I, I, I, I, LL, I, I, P]
        lib.onesided_ring_put.restype = I
        lib.a2a_error_string.argtypes = [I]
        lib.a2a_error_string.restype = ctypes.c_char_p
    return lib


def _check_device(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"the {what} kernel runs on CUDA tensors (got {x.device}); CPU "
            f"tensors take the plain version")


# --- plain versions (what CPU tensors take) ---------------------------------

def onesided_all_to_all_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain all-to-all: ``out[d][r] = x[r][d]`` for every (r, d), by
    indexing."""
    E = x.shape[0]
    out = torch.empty_like(x)
    for r in range(E):
        for d in range(E):
            out[d][r] = x[r][d]
    return out


def onesided_put_rows_ref(contribs: torch.Tensor) -> torch.Tensor:
    """Plain row exchange: the plain all-to-all of the contributions."""
    return onesided_all_to_all_ref(contribs)


def onesided_fetch_rows_ref(contribs: torch.Tensor) -> torch.Tensor:
    """Plain row fetch: the plain exchange, then the sum over owners."""
    return onesided_put_rows_ref(contribs).sum(dim=1)


def onesided_reduce_scatter_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain reduce-scatter: the plain all-to-all, then the sum over
    sources in ``x``'s dtype (an int32 sum wraps modulo 2**32, as the
    reference's does)."""
    return onesided_all_to_all_ref(x).sum(dim=1, dtype=x.dtype)


def onesided_ring_permute_ref(x: torch.Tensor, shift: int = 1
                              ) -> torch.Tensor:
    """Plain ring permute: ``out[(r + shift) % n] = x[r]``, by indexing."""
    n = x.shape[0]
    out = torch.empty_like(x)
    for r in range(n):
        out[(r + shift) % n] = x[r]
    return out


# --- wrappers ---------------------------------------------------------------

def _check_chunks(x: torch.Tensor, min_dim: int, what: str) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes one of {tuple(_DTYPE_CODES)}, "
                        f"got {x.dtype}")
    if x.dim() < min_dim:
        raise ValueError(f"{what} needs at least {min_dim} dimensions, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")
    if x.shape[0] > MAX_RANKS:
        raise ValueError(f"{what} takes at most {MAX_RANKS} ranks, got "
                         f"{x.shape[0]}")


def _rank_table(bufs: torch.Tensor) -> ctypes.Array:
    """The addresses of the ranks' buffers ``bufs[r]``, one per rank, as a
    host table.  The launcher hands it to the kernel by value, so nothing
    is copied to the card."""
    n = bufs.shape[0]
    return (ctypes.c_longlong * n)(*(bufs[r].data_ptr() for r in range(n)))


def _aligned(x: torch.Tensor, out: torch.Tensor, chunk: int) -> bool:
    """16-byte units: the chunk's bytes and both tensors' bases aligned
    (every rank's buffer then is too)."""
    return (chunk * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.a2a_error_string(rc).decode()} ({rc})")


def _launch_all_to_all(x: torch.Tensor, counter: str, first: int = 0,
                       count: Optional[int] = None) -> torch.Tensor:
    """One chunk-put launch for source ranks ``first .. first + count -
    1`` (all E by default), counted under ``counter``.  A range short of
    all E fills only those sources' rows ``out[:, first:first + count]``
    of the returned ``(E, E, ...)`` buffer."""
    E = x.shape[0]
    count = E - first if count is None else count
    out = torch.empty((E, E) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    chunk = x[0, 0].numel()
    if chunk == 0:
        return out
    ptrs = _rank_table(out)
    vec = _aligned(x, out, chunk)
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check_rc(lib, lib.onesided_a2a_put(
            x[first].data_ptr(), ptrs, first, count, E, chunk,
            _DTYPE_CODES[x.dtype], int(vec), stream), counter)
    LAUNCH_COUNTS[counter] += 1
    return out


def _launch_pull_sum(x: torch.Tensor, first: int = 0,
                     count: Optional[int] = None) -> torch.Tensor:
    """One pull-sum launch for destinations ``first .. first + count - 1``
    (all E by default): ``(count, ...)``, destination ``first + j``'s sum
    over sources at ``[j]``."""
    E = x.shape[0]
    count = E - first if count is None else count
    out = torch.empty((count,) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    chunk = x[0, 0].numel()
    if chunk == 0:
        return out
    ptrs = _rank_table(x)
    vec = _aligned(x, out, chunk)
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check_rc(lib, lib.onesided_rs_pull(
            ptrs, out.data_ptr(), E, first, count, chunk,
            _DTYPE_CODES[x.dtype], int(vec), stream),
            "onesided_reduce_scatter")
    LAUNCH_COUNTS["onesided_reduce_scatter"] += 1
    return out


def _check_square(x: torch.Tensor, what: str) -> None:
    _check_chunks(x, 2, what)
    if x.shape[0] != x.shape[1]:
        raise ValueError(f"{what} takes (E, E, ...), got "
                         f"{tuple(x.shape)}")


def onesided_all_to_all(x: torch.Tensor) -> torch.Tensor:
    """All-to-all of the stacked send buffers: ``(E_src, E_dst, C, ...)``
    int32/f32/bf16 -> ``(E_dst, E_src, C, ...)``, one kernel launch in
    which every source rank puts its E chunks into the ranks' buffers."""
    CALL_COUNTS["onesided_all_to_all"] += 1
    if x.device.type == "cpu":
        return onesided_all_to_all_ref(x)
    _check_device(x, "all-to-all")
    _check_square(x, "onesided_all_to_all")
    return _launch_all_to_all(x, "onesided_all_to_all")


def onesided_reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """The paper's reduce-scatter workaround (NVSHMEM 2.9 had none), the
    one-sided all-to-all and then the local sum over sources, fused into
    one kernel launch: ``(E_src, E_dst, M, ...)`` -> ``(E_dst, M, ...)``,
    each destination's chunks read from every source's buffer and summed
    in registers, in ``x``'s dtype and in the order of ``x.sum(0)``."""
    CALL_COUNTS["onesided_reduce_scatter"] += 1
    if x.device.type == "cpu":
        return onesided_reduce_scatter_ref(x)
    _check_device(x, "reduce-scatter")
    _check_square(x, "onesided_reduce_scatter")
    return _launch_pull_sum(x)


def _launch_ring(x: torch.Tensor, shift: int, first: int = 0,
                 count: Optional[int] = None) -> torch.Tensor:
    """One ring-put launch for source ranks ``first .. first + count - 1``
    (all n by default).  A range short of all n fills only the blocks
    ``out[(r + shift) % n]`` of those sources."""
    n = x.shape[0]
    count = n - first if count is None else count
    out = torch.empty_like(x)
    chunk = x[0].numel()
    if chunk == 0:
        return out
    ptrs = _rank_table(out)
    vec = _aligned(x, out, chunk)
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check_rc(lib, lib.onesided_ring_put(
            x[first].data_ptr(), ptrs, first, count, n, shift % n, chunk,
            _DTYPE_CODES[x.dtype], int(vec), stream), "onesided_ring_permute")
    LAUNCH_COUNTS["onesided_ring_permute"] += 1
    return out


def onesided_ring_permute(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """One-sided ring shift of the stacked blocks: ``(n, ...)`` -> ``(n,
    ...)``, rank ``(r + shift) % n`` receives rank r's block; one kernel
    launch in which every source rank puts its block."""
    CALL_COUNTS["onesided_ring_permute"] += 1
    if x.device.type == "cpu":
        return onesided_ring_permute_ref(x, shift)
    _check_device(x, "ring permute")
    _check_chunks(x, 1, "onesided_ring_permute")
    return _launch_ring(x, shift)


def onesided_put_rows(contribs: torch.Tensor) -> torch.Tensor:
    """The exchange of the row fetch: ``(H_src, H_dst, M, D)``
    contributions -> ``(H_dst, H_src, M, D)``, one kernel launch in which
    every source rank puts its M rows for every requester, one chunk
    each."""
    CALL_COUNTS["onesided_put_rows"] += 1
    if contribs.device.type == "cpu":
        return onesided_put_rows_ref(contribs)
    _check_device(contribs, "put")
    _check_square(contribs, "onesided_put_rows")
    if contribs.dim() != 4:
        raise ValueError(f"contribs must be (H, H, M, D), got "
                         f"{tuple(contribs.shape)}")
    return _launch_all_to_all(contribs, "onesided_put_rows")


def onesided_fetch_rows(contribs: torch.Tensor) -> torch.Tensor:
    """Row-fetch gather: ``(H_src, H_dst, M, D)`` contributions -> each
    requester's ``(M, D)`` fetched rows, stacked ``(H, M, D)``.  The sum
    over owners runs after the puts on the same stream, so it starts once
    every put has landed."""
    return onesided_put_rows(contribs).sum(dim=1)
