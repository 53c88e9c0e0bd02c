"""Collective communication for the remote cold tier, simulated on one
device.

The counterpart of ``repro.core.comm`` for this slice of the port: its
instrumentation (:class:`CollectiveEvent`, :func:`instrument`,
:func:`set_event_sink`, :func:`record_runtime`) and the batched row fetch
:func:`fetch_rows` of the tiered cache.  The paper's two transports keep
their names:

  * ``"bulk"`` -- the NCCL analogue: one bulk reduce-scatter of the
    stacked contributions (the reference's ``psum_scatter``), here a sum
    over the source rank with stock torch ops;
  * ``"onesided"`` -- the NVSHMEM analogue: one put per embedding row from
    inside a kernel (``kernels/onesided_a2a.onesided_fetch_rows``, a
    hand-written CUDA kernel on a card, its plain version on the CPU).

The H hosts are simulated in one process, their row shards stacked in one
``(H, rows_local, D)`` tensor on one device, as the reference's CPU tests
back its hosts with forced host devices of one process.  The other
collectives (``all_to_all``, ``reduce_scatter``, ``all_gather``,
``permute_ring``) come with the distributed slice.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, List, Optional

import torch

from repro_torch.kernels.onesided_a2a import onesided_fetch_rows

# ---------------------------------------------------------------------------
# Instrumentation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveEvent:
    op: str            # fetch_rows (the other ops come with later slices)
    bytes_in: int      # payload bytes entering the collective
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


def record_runtime(op: str, nbytes: int, n_devices: int, backend: str,
                   t0: float, t1: float):
    """Record a collective timed at run time (``t1 > t0``), as
    ``RemoteStore.fetch`` does around each fetch."""
    if _LOG.events is None and _SINK is None:
        return
    _emit(CollectiveEvent(op, int(nbytes), int(n_devices), backend,
                          float(t0), float(t1)))


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
