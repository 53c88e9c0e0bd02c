"""The launchers' mesh of processes: the counterpart of
``repro.launch.mesh.make_debug_mesh``, the ``(data = n / 2, model = 2)``
mesh the reference's launchers build whenever they see more than one
device, here over n ranks each a process (``core/parallel.run_ranks``).

The reference's ``make_production_mesh`` (the 256- and 512-chip TPU
meshes, ``--production-mesh``, ``--multi-pod``) is not here (ROADMAP
Queue 1 item 13.8).
"""
from __future__ import annotations

import resource
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.parallel import DEFAULT_TIMEOUT_S, run_ranks

MODEL_AXIS = 2          # the debug mesh's model axis, as the reference's


def rank_count(ranks: Optional[int], device) -> int:
    """How many ranks a launcher runs: ``ranks`` when given (``--ranks``,
    the counterpart of ``--xla_force_host_platform_device_count``), else
    the reference's ``len(jax.devices())``: the cards when no ``device``
    is named (at least 1), and 1 with a named device."""
    if ranks is not None:
        if ranks < 1:
            raise ValueError(f"--ranks must be >= 1, got {ranks}")
        return ranks
    if device is None:
        return max(torch.cuda.device_count(), 1)
    return 1


def run_debug_mesh(fn: Callable, n: int, device=None, args: tuple = (),
                   timeout_s: float = DEFAULT_TIMEOUT_S):
    """``fn(ctx, *args)`` on ``n`` ranks, one process each, as the
    reference's debug mesh ``(n / 2, 2)``: global rank ``d * 2 + m`` is
    model rank m of data group d.  ``device`` None puts rank r on card
    ``r % device_count`` over NCCL when every rank has a card of its own,
    over gloo otherwise; a named device ("cpu", or one card the ranks
    share) runs them over gloo.  An odd ``n`` raises ``ValueError``, as
    the reference's ``make_mesh((n // 2, 2))`` cannot use n devices
    either.  Returns global rank 0's result."""
    if n % MODEL_AXIS:
        raise ValueError(f"{n} ranks do not form the debug mesh (n / "
                         f"{MODEL_AXIS}, {MODEL_AXIS}): pass an even "
                         f"--ranks")
    if device is None and n <= torch.cuda.device_count():
        backend = "nccl"
    else:
        backend = "gloo"
    return run_ranks(fn, n, backend=backend, device=device,
                     dp_size=n // MODEL_AXIS, args=args,
                     timeout_s=timeout_s)


def peak_bytes(device: torch.device) -> int:
    """This process's peak memory on ``device``: the caching allocator's
    peak on a card, the process's peak resident set on the CPU (Linux
    reports kilobytes)."""
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def gather_world(obj) -> list:
    """Every rank's ``obj``, in global rank order, on every rank."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
