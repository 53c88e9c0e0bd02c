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

One rank per process (``core.parallel.ProcessContext``), the same two
kernels serve the per-rank exchanges, each launched with ``first = rank,
count = 1`` over the ranks' :class:`SymmetricBuffers` -- buffers each
process allocates with ``cudaMalloc`` and every other process opens
through its CUDA IPC handle:

  * :func:`onesided_all_to_all_rank` -- this rank's ``(E_dst, C, ...)`` ->
    ``(E_src, C, ...)``: one put launch writes this rank's E chunks into
    the peers' receive buffers;
  * :func:`onesided_reduce_scatter_rank` -- ``(E_dst, M, ...)`` -> ``(M,
    ...)``: one pull-sum launch reads this rank's chunk from every peer's
    send buffer and sums it in rank order 0 .. E-1, ``x.sum(0)``'s order;
  * :func:`onesided_all_reduce_rank` -- the pull-sum over the peers'
    whole send buffers: every rank sums all of them, ``x.sum(0)``'s order;
  * :func:`onesided_fetch_rows_rank` -- the remote tier's row exchange,
    this rank's ``(H_dst, M, D)`` contributions -> its ``(M, D)`` rows:
    one put launch writes chunk d into rank d's receive buffer at
    ``[rank]``, then the local sum over the ``(H_src, M, D)`` received,
    a select (one owner per element);
  * :func:`onesided_ring_permute_rank` -- this rank's block -> the block
    of rank ``(rank - shift) % n``: one ring-put launch writes it into
    rank ``(rank + shift) % n``'s receive buffer.

Across processes, stream order no longer orders the puts: a fence (this
rank's stream synchronised, then a barrier of the group) comes before
every exchange, so no peer still reads the buffer it writes, and after
the puts and the copy into the send buffer, so every write has landed
before anyone reads.  :data:`FENCE_STATS` counts the fences and their
seconds.

Every wrapper dispatches on the device of the tensor it is given: a CPU
tensor takes the plain version beside it (``*_ref``; per rank, the
group's collectives), a CUDA tensor launches the kernel, anything else
raises.  Each kernel launch adds one to the wrapper's entry in
:data:`LAUNCH_COUNTS` (the per-rank all-reduce under
``onesided_reduce_scatter``, its kernel's; the per-rank row fetch under
``onesided_put_rows``); the plain versions count nothing.  Every call of a
wrapper, on either device, adds one to its entry in :data:`CALL_COUNTS`
(``onesided_fetch_rows`` counts as the ``onesided_put_rows`` call it
makes, and ``onesided_fetch_rows_rank`` as one).
"""
from __future__ import annotations

import ctypes
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

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


# the per-rank exchanges' fences: how many, and their host seconds
FENCE_STATS = {"fences": 0, "seconds": 0.0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
    FENCE_STATS.update(fences=0, seconds=0.0)


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
        PP = ctypes.POINTER(ctypes.c_void_p)
        lib.symm_handle_bytes.argtypes = []
        lib.symm_handle_bytes.restype = I
        lib.symm_alloc.argtypes = [I, LL, PP]
        lib.symm_export.argtypes = [I, P, ctypes.c_char_p]
        lib.symm_open.argtypes = [I, ctypes.c_char_p, PP]
        lib.symm_close.argtypes = [I, P]
        lib.symm_free.argtypes = [I, P]
        for fn in (lib.symm_alloc, lib.symm_export, lib.symm_open,
                   lib.symm_close, lib.symm_free):
            fn.restype = I
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


# --- one rank per process ----------------------------------------------------

class _DeviceBytes:
    """A raw device allocation seen through ``__cuda_array_interface__``,
    so that ``torch.as_tensor`` views it without owning it."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


def _check_symm(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"symmetric buffer: {what} failed: "
                           f"{lib.a2a_error_string(rc).decode()} ({rc})")


class SymmetricBuffers:
    """One buffer of ``nbytes`` on every rank of a process group, each
    addressable by every rank: the symmetric memory of the one-sided
    exchanges when each rank is a process.

    Every rank allocates its own buffer with ``cudaMalloc`` on its device
    (``csrc/onesided_a2a.cu``, ``symm_alloc``), exports its CUDA IPC
    handle, gathers every rank's handle over the group
    (``all_gather_object``) and opens the peers' handles
    (``cudaIpcOpenMemHandle`` with lazy peer access).  :attr:`ptrs` then
    holds the E buffers' addresses in this process, in rank order, which
    the put and pull-sum kernels take as their table.  A handle that does
    not open raises: there is no fallback to a bulk collective.

    The constructor is collective: every rank of the group builds its
    buffers at the same point with the same size.  ``rank`` and ``world``
    are the rank's and the size of ``group`` (a model-axis subgroup under
    a data axis: the handles are gathered over it and indexed by the rank
    in it, so two model axes sharing a card open only their own peers'
    buffers); others raise.  :attr:`handles` keeps the E handles, in
    rank order."""

    def __init__(self, group, rank: int, world: int, device, nbytes: int):
        self.group, self.rank, self.world = group, rank, world
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"symmetric buffers live on a card, got "
                             f"{self.device}")
        if not 1 <= world <= MAX_RANKS:
            raise ValueError(f"at most {MAX_RANKS} ranks, got {world}")
        if (dist.get_rank(group), dist.get_world_size(group)) != (rank,
                                                                 world):
            raise ValueError(
                f"rank {rank} of {world} is not this process's place in the"
                f" group: {dist.get_rank(group)} of "
                f"{dist.get_world_size(group)}")
        self.nbytes = int(nbytes)
        self._index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        lib = self._lib = _kernel()
        own = ctypes.c_void_p()
        _check_symm(lib, lib.symm_alloc(self._index, self.nbytes,
                                        ctypes.byref(own)), "cudaMalloc")
        self._own = own.value
        handle = ctypes.create_string_buffer(lib.symm_handle_bytes())
        _check_symm(lib, lib.symm_export(self._index, self._own, handle),
                    "cudaIpcGetMemHandle")
        handles = [None] * world
        dist.all_gather_object(handles, handle.raw, group=group)
        self.handles = tuple(handles)
        self._opened = []
        ptrs = []
        for r, h in enumerate(handles):
            if r == rank:
                ptrs.append(self._own)
                continue
            peer = ctypes.c_void_p()
            _check_symm(lib, lib.symm_open(self._index, h,
                                           ctypes.byref(peer)),
                        f"cudaIpcOpenMemHandle of rank {r}'s buffer")
            self._opened.append(peer.value)
            ptrs.append(peer.value)
        self.ptrs = tuple(ptrs)
        self._table = (ctypes.c_longlong * world)(*ptrs)

    def view(self, dtype: torch.dtype, shape: Sequence[int]) -> torch.Tensor:
        """This rank's buffer, its first bytes as a ``shape`` tensor of
        ``dtype``."""
        n = 1
        for s in shape:
            n *= int(s)
        nbytes = n * dtype.itemsize
        if nbytes > self.nbytes:
            raise ValueError(f"{nbytes} B do not fit a symmetric buffer of "
                             f"{self.nbytes} B")
        raw = torch.as_tensor(_DeviceBytes(self._own, self.nbytes),
                              device=self.device)
        return raw[:nbytes].view(dtype).view(tuple(shape))

    def close(self) -> None:
        """Collective: close the peers' buffers, wait for every rank to
        have closed this one, free it."""
        if self._own is None:
            return
        for p in self._opened:
            _check_symm(self._lib, self._lib.symm_close(self._index, p),
                        "cudaIpcCloseMemHandle")
        self._opened = []
        dist.barrier(group=self.group)
        _check_symm(self._lib, self._lib.symm_free(self._index, self._own),
                    "cudaFree")
        self._own = None


def fence(group, device: torch.device) -> None:
    """This rank's stream drained, then a barrier of the group: every
    rank's earlier device work -- a put, a read of its buffers -- is done
    before any rank goes on.  Counted and timed in :data:`FENCE_STATS`."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    dist.barrier(group=group)
    FENCE_STATS["fences"] += 1
    FENCE_STATS["seconds"] += time.perf_counter() - t0


def _check_rank_chunks(x: torch.Tensor, world: int, what: str) -> None:
    _check_chunks(x, 1, what)
    if x.shape[0] != world:
        raise ValueError(f"{what} takes ({world}, ...) chunks, one per rank,"
                         f" got {tuple(x.shape)}")


# plain versions: the group's collectives, on the CPU

def all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """The group's all-gather of the contiguous ``x`` into ``(world,) +
    x.shape``, flat: gloo checks the first dimensions, world x the
    input's.  (``all_gather_into_tensor`` took the name
    ``all_gather_single`` in later torch releases.)"""
    fn = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    fn(out.view(-1), x.view(-1), group=group)


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """The group's reduce-scatter (sum) of the contiguous ``(world,) +
    out.shape`` ``x`` into ``out``, flat, as :func:`all_gather_into`.
    (``reduce_scatter_tensor`` is ``reduce_scatter_single`` in later
    releases.)"""
    fn = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    fn(out.view(-1), x.view(-1), group=group)


def onesided_all_to_all_rank_ref(x: torch.Tensor, group) -> torch.Tensor:
    """Plain per-rank all-to-all: the group's ``all_to_all_single``."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def onesided_reduce_scatter_rank_ref(x: torch.Tensor, group) -> torch.Tensor:
    """Plain per-rank reduce-scatter: every source's chunk for this rank
    gathered (the plain all-to-all), then summed in rank order."""
    return onesided_all_to_all_rank_ref(x, group).sum(dim=0, dtype=x.dtype)


def onesided_all_reduce_rank_ref(x: torch.Tensor, group) -> torch.Tensor:
    """Plain per-rank all-reduce: every rank's value gathered, then summed
    in rank order."""
    out = torch.empty((dist.get_world_size(group),) + tuple(x.shape),
                      dtype=x.dtype, device=x.device)
    all_gather_into(out, x.contiguous(), group)
    return out.sum(dim=0, dtype=x.dtype)


def onesided_fetch_rows_rank_ref(contribs: torch.Tensor,
                                 group) -> torch.Tensor:
    """Plain per-rank row fetch: the contributions exchanged over the
    group's ``all_to_all_single``, then the sum over owners."""
    return onesided_all_to_all_rank_ref(contribs, group).sum(dim=0)


def onesided_ring_permute_rank_ref(x: torch.Tensor, shift: int,
                                   group) -> torch.Tensor:
    """Plain per-rank ring permute: a send to rank ``(r + shift) % n``
    and a receive from rank ``(r - shift) % n``, over the group."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    dst, src = (rank + shift) % n, (rank - shift) % n
    if dst == rank:
        return x.clone()
    out = torch.empty_like(x)
    x = x.contiguous()
    if group is not None:       # the ops take the peers' global ranks
        dst, src = (dist.get_global_rank(group, r) for r in (dst, src))
    ops = [dist.P2POp(dist.isend, x, dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


# wrappers

def onesided_all_to_all_rank(x: torch.Tensor, rank: int, group,
                             recv: Optional[SymmetricBuffers] = None
                             ) -> torch.Tensor:
    """This rank's all-to-all: ``(E_dst, C, ...)`` -> ``(E_src, C, ...)``,
    chunk d of every source at ``[source]`` of rank d's result.  One
    launch of the put kernel with ``first = rank, count = 1`` writes this
    rank's E chunks into the peers' receive buffers ``recv``, between two
    fences; the result is a copy of this rank's receive buffer.  CPU
    tensors take the group's ``all_to_all_single`` (``recv`` unused)."""
    CALL_COUNTS["onesided_all_to_all"] += 1
    if x.device.type == "cpu":
        return onesided_all_to_all_rank_ref(x, group)
    _check_device(x, "all-to-all")
    _check_rank_chunks(x, recv.world, "onesided_all_to_all_rank")
    return _put_rank(x, rank, group, recv, "onesided_all_to_all").clone()


def _put_rank(x: torch.Tensor, rank: int, group, recv: SymmetricBuffers,
              counter: str) -> torch.Tensor:
    """One put launch (``first = rank, count = 1``, counted under
    ``counter``) of this rank's ``(E_dst, C, ...)`` chunks into the peers'
    receive buffers ``recv``, between two fences; returns this rank's
    receive buffer as ``(E_src, C, ...)``, which the next exchange's first
    fence keeps from the peers until what reads it here has run."""
    E = recv.world
    chunk = x[0].numel()
    if chunk == 0:
        return torch.empty_like(x)
    out = recv.view(x.dtype, x.shape)
    vec = _aligned(x, out, chunk)
    lib = _kernel()
    fence(group, x.device)              # no peer still reads its buffer
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check_rc(lib, lib.onesided_a2a_put(
            x.data_ptr(), recv._table, rank, 1, E, chunk,
            _DTYPE_CODES[x.dtype], int(vec), stream), counter)
    LAUNCH_COUNTS[counter] += 1
    fence(group, x.device)              # every rank's puts have landed
    return out


def _pull_sum_rank(x: torch.Tensor, rank: int, group,
                   send: SymmetricBuffers, first: int, chunk: int,
                   out_shape) -> torch.Tensor:
    """``x`` copied into this rank's send buffer between two fences, then
    one pull-sum launch over the E send buffers' chunk ``first``."""
    E = send.world
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if chunk == 0:
        return out
    staged = send.view(x.dtype, x.shape)
    vec = _aligned(staged, out, chunk)
    lib = _kernel()
    fence(group, x.device)              # no peer still reads its buffer
    staged.copy_(x)
    fence(group, x.device)              # every send buffer is written
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check_rc(lib, lib.onesided_rs_pull(
            send._table, out.data_ptr(), E, first, 1, chunk,
            _DTYPE_CODES[x.dtype], int(vec), stream),
            "onesided_reduce_scatter")
    LAUNCH_COUNTS["onesided_reduce_scatter"] += 1
    return out


def onesided_reduce_scatter_rank(x: torch.Tensor, rank: int, group,
                                 send: Optional[SymmetricBuffers] = None
                                 ) -> torch.Tensor:
    """This rank's reduce-scatter: ``(E_dst, M, ...)`` -> ``(M, ...)``, the
    sum over sources of their ``[rank]``, in ``x``'s dtype and rank order
    (``x.sum(0)``'s).  One pull-sum launch with ``first = rank, count =
    1`` reads the chunk from every peer's send buffer ``send``.  The next
    exchange's first fence keeps the peers from overwriting their send
    buffers while this rank still reads them."""
    CALL_COUNTS["onesided_reduce_scatter"] += 1
    if x.device.type == "cpu":
        return onesided_reduce_scatter_rank_ref(x, group)
    _check_device(x, "reduce-scatter")
    _check_rank_chunks(x, send.world, "onesided_reduce_scatter_rank")
    return _pull_sum_rank(x, rank, group, send, rank, x[0].numel(),
                          tuple(x.shape[1:]))


def onesided_all_reduce_rank(x: torch.Tensor, rank: int, group,
                             send: Optional[SymmetricBuffers] = None
                             ) -> torch.Tensor:
    """This rank's all-reduce: the sum of every rank's ``x``, in ``x``'s
    dtype and rank order (``x.sum(0)``'s over the stacked ranks).  One
    pull-sum launch over the peers' whole send buffers (the chunk is all
    of ``x``), counted under ``onesided_reduce_scatter``."""
    CALL_COUNTS["onesided_reduce_scatter"] += 1
    if x.device.type == "cpu":
        return onesided_all_reduce_rank_ref(x, group)
    _check_device(x, "all-reduce")
    if x.dtype not in _DTYPE_CODES or not x.is_contiguous():
        raise ValueError(f"onesided_all_reduce_rank takes a contiguous "
                         f"tensor of one of {tuple(_DTYPE_CODES)}, got "
                         f"{x.dtype}")
    return _pull_sum_rank(x, rank, group, send, 0, x.numel(),
                          tuple(x.shape))


def onesided_fetch_rows_rank(contribs: torch.Tensor, rank: int, group,
                             recv: Optional[SymmetricBuffers] = None
                             ) -> torch.Tensor:
    """This rank's row fetch: its ``(H_dst, M, D)`` contributions -> its
    ``(M, D)`` fetched rows.  One launch of the put kernel with ``first =
    rank, count = 1``, counted under ``onesided_put_rows``, writes chunk d
    into rank d's receive buffer ``recv`` at ``[rank]``, between two
    fences; then the sum over the ``(H_src, M, D)`` received, on this
    rank's stream.  Each element has one owner and zeros elsewhere, so the
    sum returns the owner's bits (``-0.0`` comes back ``+0.0``).  CPU
    tensors take the group's ``all_to_all_single`` (``recv`` unused)."""
    CALL_COUNTS["onesided_put_rows"] += 1
    if contribs.device.type == "cpu":
        return onesided_fetch_rows_rank_ref(contribs, group)
    _check_device(contribs, "put")
    _check_rank_chunks(contribs, recv.world, "onesided_fetch_rows_rank")
    if contribs.dim() != 3:
        raise ValueError(f"contribs must be (H, M, D), got "
                         f"{tuple(contribs.shape)}")
    return _put_rank(contribs, rank, group, recv,
                     "onesided_put_rows").sum(dim=0)


def onesided_ring_permute_rank(x: torch.Tensor, shift: int, rank: int,
                               group, recv: Optional[SymmetricBuffers] = None
                               ) -> torch.Tensor:
    """This rank's ring permute: its block goes to rank ``(rank + shift) %
    n``, and it returns the block of rank ``(rank - shift) % n``.  One
    launch of the ring-put kernel with ``first = rank, count = 1`` writes
    the block into that rank's receive buffer ``recv``, between two
    fences; the result is a copy of this rank's receive buffer.  CPU
    tensors take a send/recv pair over the group (``recv`` unused)."""
    CALL_COUNTS["onesided_ring_permute"] += 1
    if x.device.type == "cpu":
        return onesided_ring_permute_rank_ref(x, shift, group)
    _check_device(x, "ring permute")
    if x.dtype not in _DTYPE_CODES or not x.is_contiguous():
        raise ValueError(f"onesided_ring_permute_rank takes a contiguous "
                         f"tensor of one of {tuple(_DTYPE_CODES)}, got "
                         f"{x.dtype}")
    n = recv.world
    chunk = x.numel()
    if chunk == 0:
        return torch.empty_like(x)
    out = recv.view(x.dtype, x.shape)
    vec = _aligned(x, out, chunk)
    lib = _kernel()
    fence(group, x.device)              # no peer still reads its buffer
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check_rc(lib, lib.onesided_ring_put(
            x.data_ptr(), recv._table, rank, 1, n, shift % n, chunk,
            _DTYPE_CODES[x.dtype], int(vec), stream), "onesided_ring_permute")
    LAUNCH_COUNTS["onesided_ring_permute"] += 1
    fence(group, x.device)              # every rank's block has landed
    return out.clone()
