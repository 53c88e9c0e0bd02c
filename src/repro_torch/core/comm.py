"""Collective communication over simulated ranks on one device.

The counterpart of ``repro.core.comm``: its instrumentation
(:class:`CollectiveEvent`, :func:`instrument`, :func:`set_event_sink`,
:func:`record_runtime`), the collectives of the distributed embedding bag
(:func:`all_to_all`, :func:`all_gather`, :func:`all_reduce`,
:func:`reduce_scatter`, :func:`permute_ring`) and the batched row fetch
:func:`fetch_rows` of the tiered cache.  The paper's two transports keep
their names:

  * ``"bulk"`` -- the NCCL analogue: host-launched bulk collectives, here
    stock torch ops over the stacked ranks (a transpose, a sum);
  * ``"onesided"`` -- the NVSHMEM analogue: puts and gets issued from
    inside a kernel (``kernels/onesided_a2a.py``: whole chunks put for the
    all-to-all, the ring and the row fetch, whole chunks read and summed
    for the reduce-scatter; hand-written CUDA kernels on a card, their
    plain versions on the CPU).

The ranks of one mesh axis are simulated in one process on one device, as
the reference's CPU tests back their ranks with forced host devices of one
process.  Per-rank values are stacked on a leading rank axis, and a
collective takes the stack: ``all_to_all`` maps ``(E_src, E_dst, ...)`` to
``(E_dst, E_src, ...)``, ``reduce_scatter`` ``(E_src, E_dst, M, ...)`` to
``(E_dst, M, ...)``, ``permute_ring`` ``(E, ...)`` to ``(E, ...)``.  A
collective whose result every rank holds alike (``all_gather``,
``all_reduce``) returns that result once.  Each call records one
:class:`CollectiveEvent` with the reference's ``bytes_in`` -- ONE rank's
payload -- and ``axis_size = E``.  There is no one-sided mode switch: the
device of the tensors picks the route.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, List, Optional

import torch

from repro_torch.kernels.onesided_a2a import (
    onesided_all_to_all,
    onesided_fetch_rows,
    onesided_reduce_scatter,
    onesided_ring_permute,
)

BACKENDS = ("bulk", "onesided")

# ---------------------------------------------------------------------------
# Instrumentation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveEvent:
    op: str            # all_to_all | all_gather | reduce_scatter | all_reduce
    #                  # | permute | fetch_rows
    bytes_in: int      # one rank's payload bytes entering the collective
    axis_size: int
    backend: str
    # ``time.perf_counter`` stamps of the measured interval; 0.0/0.0 marks
    # an event that carries no time
    t0: float = 0.0
    t1: float = 0.0


class _Log(threading.local):
    def __init__(self):
        self.events: Optional[List[CollectiveEvent]] = None


_LOG = _Log()

# process-wide event sink: unlike the thread-local instrument() log, events
# recorded on other threads reach it too
_SINK: Optional[Callable[[CollectiveEvent], object]] = None


def set_event_sink(fn: Optional[Callable[[CollectiveEvent], object]]):
    """Install a process-wide CollectiveEvent callback (None removes it);
    returns the previous sink so callers can restore it."""
    global _SINK
    prev, _SINK = _SINK, fn
    return prev


@contextlib.contextmanager
def instrument():
    """Collect the CollectiveEvents this thread records under the
    context."""
    prev, _LOG.events = _LOG.events, []
    try:
        yield _LOG.events
    finally:
        _LOG.events = prev


def _emit(ev: CollectiveEvent):
    if _LOG.events is not None:
        _LOG.events.append(ev)
    if _SINK is not None:
        _SINK(ev)


def _record(op: str, x: torch.Tensor, backend: str) -> None:
    """One event for a collective over the stacked ``x``: one rank's
    payload (``x[0]``) and the axis size ``E = x.shape[0]``, stamped once
    (``t0 == t1``: the event carries no time), as the reference records at
    trace time."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of "
                         f"{BACKENDS}")
    if _LOG.events is None and _SINK is None:
        return
    t = time.perf_counter()
    _emit(CollectiveEvent(op, x[0].numel() * x.element_size(),
                          int(x.shape[0]), backend, t, t))


def record_runtime(op: str, nbytes: int, n_devices: int, backend: str,
                   t0: float, t1: float):
    """Record a collective timed at run time (``t1 > t0``), as
    ``RemoteStore.fetch`` does around each fetch."""
    if _LOG.events is None and _SINK is None:
        return
    _emit(CollectiveEvent(op, int(nbytes), int(n_devices), backend,
                          float(t0), float(t1)))


# ---------------------------------------------------------------------------
# Collectives over the stacked ranks
# ---------------------------------------------------------------------------

def all_to_all(x: torch.Tensor, *, backend: str = "bulk") -> torch.Tensor:
    """All-to-all: ``(E_src, E_dst, C, ...)`` -> ``(E_dst, E_src, C,
    ...)``; rank d receives every rank's chunk for d, in rank order.
    ``"onesided"`` puts whole chunks from inside a kernel (one launch for
    all source ranks); ``"bulk"`` transposes with stock torch ops."""
    _record("all_to_all", x, backend)
    if backend == "onesided":
        return onesided_all_to_all(x)
    return x.transpose(0, 1).contiguous()


def all_gather(x: torch.Tensor, *, axis: int = 0, tiled: bool = False,
               backend: str = "bulk") -> torch.Tensor:
    """All-gather of the E ranks' ``x[r]``: stacked along a new ``axis``,
    or concatenated along ``axis`` when ``tiled``.  Every rank holds the
    same result; it is returned once."""
    _record("all_gather", x, backend)
    parts = x.unbind(0)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts,
                                                                dim=axis)


def all_reduce(x: torch.Tensor, *, backend: str = "bulk") -> torch.Tensor:
    """Sum of the E ranks' ``x[r]`` (the reference's ``psum``), returned
    once, in ``x``'s dtype (an int32 sum wraps modulo 2**32, as the
    reference's does)."""
    _record("all_reduce", x, backend)
    return x.sum(dim=0, dtype=x.dtype)


def reduce_scatter(x: torch.Tensor, *, backend: str = "bulk",
                   emulate_with_a2a: bool = False) -> torch.Tensor:
    """Reduce-scatter over the leading per-rank dimension: ``(E_src, E_dst,
    M, ...)`` -> ``(E_dst, M, ...)``, rank d's sum over sources of their
    ``[d]``, in ``x``'s dtype.

    ``"onesided"`` always takes the paper's NVSHMEM 2.9 workaround (§4.4),
    the one-sided all-to-all and then a local sum, fused into one kernel
    that reads every source's chunk and sums it in registers.
    ``emulate_with_a2a`` takes the workaround's two passes on ``"bulk"``
    (a transpose, then a sum); otherwise the bulk route is one sum over
    sources (the reference's ``psum_scatter``)."""
    _record("reduce_scatter", x, backend)
    if backend == "onesided":
        return onesided_reduce_scatter(x)
    if emulate_with_a2a:
        return x.transpose(0, 1).contiguous().sum(dim=1, dtype=x.dtype)
    return x.sum(dim=0, dtype=x.dtype)


def permute_ring(x: torch.Tensor, *, shift: int = 1,
                 backend: str = "bulk") -> torch.Tensor:
    """Ring collective-permute: ``(n, ...)`` -> ``(n, ...)``, rank ``(r +
    shift) % n`` receives rank r's block.  ``"onesided"`` puts each block
    from inside a kernel; ``"bulk"`` is ``torch.roll``."""
    _record("permute", x, backend)
    if backend == "onesided":
        return onesided_ring_permute(x, shift)
    return torch.roll(x, shift, dims=0)


# ---------------------------------------------------------------------------
# The batched row fetch
# ---------------------------------------------------------------------------

def fetch_rows(shards: torch.Tensor, local_addr: torch.Tensor,
               owner: torch.Tensor, *, backend: str = "bulk"
               ) -> torch.Tensor:
    """Batched cross-host row fetch -- the remote cold tier's transport.

      shards:     (H, rows_local, D) host h's flat row slice at ``[h]``
                  (owner-local addressing, all tables concatenated).
      local_addr: (M,) owner-local flat address of each requested row.
      owner:      (M,) owning host of each requested row.

    Returns the ``(M, D)`` payloads.  The protocol of the reference: every
    simulated rank sees the replicated request list (which stands in for
    the reference's two ``all_gather``s), rank r builds its ``(H, M, D)``
    contribution -- the rows it owns, ``0 * row`` elsewhere -- and the
    payloads move to the requesters, summed over owners.  Every row has
    exactly one owner, so that sum is a select: each element adds the
    owner's value to zeros, which returns it bit for bit in any order.
    Every rank asked for the same rows and so gets the same result; rank
    0's is returned.  ``backend`` picks the transport; the device of the
    tensors picks the route (a card launches the kernel, the CPU takes its
    plain version)."""
    if backend not in ("bulk", "onesided"):
        raise ValueError(f"unknown remote backend {backend!r}")
    H = shards.shape[0]
    M = local_addr.shape[0]
    ranks = torch.arange(H, device=shards.device)
    # (H_src, H_dst, M): rank r owns request m of requester q
    mine = (owner.to(shards.device)[None, None, :] == ranks[:, None, None]
            ).expand(H, H, M)
    # torch indexing raises on out-of-range ids where jnp clamps: mask the
    # address before the gather
    safe = torch.where(mine, local_addr.to(shards.device).long(), 0)
    contribs = shards[ranks[:, None, None], safe]    # (H_src, H_dst, M, D)
    contribs.mul_(mine[..., None].to(shards.dtype))
    if backend == "onesided":
        return onesided_fetch_rows(contribs)[0]
    return contribs.sum(dim=0)[0]
