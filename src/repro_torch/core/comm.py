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

With ``ctx=`` a :class:`~repro_torch.core.parallel.ProcessContext`, the
ranks are processes, and each collective takes ONE rank's value and
returns that rank's result (``all_to_all`` ``(E_dst, C, ...)`` ->
``(E_src, C, ...)``, ``reduce_scatter`` ``(E_dst, M, ...)`` -> ``(M,
...)``, ``all_gather`` and ``all_reduce`` the result every rank holds,
``permute_ring`` this rank's block -> the block it receives,
``fetch_rows`` this rank's shard and request -> its ``(M, D)`` rows).
The routes (:data:`RANK_ROUTES`):

  * ``"bulk"`` -- the group's ``all_to_all_single``,
    ``all_gather_into_tensor``, ``all_reduce`` and
    ``reduce_scatter_tensor``.  Gloo runs each of them on CUDA tensors
    too (through the host, inside gloo), so nothing is composed or
    staged here; its sums take gloo's order, not rank order;
    ``emulate_with_a2a`` takes the paper's reduce-scatter as an
    all-to-all and a local sum in rank order;
  * ``"onesided"`` -- on a card the chunk kernels over the ranks'
    symmetric buffers (``kernels/onesided_a2a.py``): the all-to-all as
    puts, the reduce-scatter and the all-reduce as pull-sums, both in
    rank order, bitwise ``x.sum(0)`` over the stacked ranks; on the CPU
    their plain versions over the group.  The all-gather has no one-sided
    kernel, in the reference either: it goes over the group.

Each call records one event, as over the stacked ranks: ``bytes_in`` is
this rank's payload, ``axis_size`` the model axis's ranks.

A context with a data axis (``dp_size > 1``) runs those over its data
group's model axis, and has two collectives of its own over the data
axis, both bulk (the group's ``all_gather_into_tensor`` and
``all_reduce``; the reference leaves them to XLA): :func:`data_all_gather`
brings the rows each data group computed from its share of a batch back
whole on every rank, and :func:`data_all_reduce` sums what each data
group holds (a gradient of its share).  Each records one event with
``axis_size = dp_size``.

Under grad the rank routes are ``torch.autograd.Function`` s whose
backward is the inverse collective over the group, under the
reference's semantics: every rank computes the same loss from the
values the ranks hold alike, so a replicated value's cotangent is the
same on every rank and counts once.

  * ``all_reduce`` (bulk, and the one-sided pull-sum): the identity --
    each rank's partial takes the whole cotangent (the row-wise bag's
    backward across ranks);
  * ``all_gather``: this rank's slice of the cotangent;
  * ``data_all_gather``: this data group's slice of the cotangent;
  * ``data_all_reduce``: the identity, as ``all_reduce``'s;
  * ``all_to_all`` (bulk): the all-to-all of the cotangents;
  * ``reduce_scatter`` (bulk, ``emulate_with_a2a`` too): the all-gather
    of the cotangents;
  * ``permute_ring`` (bulk): the permute by ``-shift`` (the reference's
    ``ppermute`` transposes to the inverse permutation);
  * ``fetch_rows`` (bulk): the all-gather of the requesters' cotangents
    back to the owners, each adding the rows it owns into its shard
    (``index_add_``; the transpose of the reference's ``psum_scatter``
    and its gather);
  * :func:`split`, the entry of a value the ranks hold alike into a
    per-rank computation (the reference's ``shard_map`` in_specs): its
    forward takes this rank's slice along an axis (or the whole value),
    its backward all-gathers the ranks' cotangents along that axis (or
    sums them);
  * :func:`gathered`, a parameter a train state's placement cuts
    (:class:`Placed`) made whole over both axes: its backward brings the
    cotangent back to the piece's gradient layout, each sum in f32
    (:class:`_PlacedGather`).

The backward's collectives record no event, as the reference's
transposes go through no ``repro.core.comm`` call.  What has no
derivative is refused while grad is enabled and the value needs one
(``RuntimeError``), on either device and on the simulated ranks too: the
one-sided all-to-all, reduce-scatter, ring permute and row fetch (the
reference's Pallas puts have no derivative: ``jax.grad`` fails inside
them).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import onesided_a2a as _oa
from repro_torch.kernels.onesided_a2a import (
    onesided_all_to_all,
    onesided_fetch_rows,
    onesided_reduce_scatter,
    onesided_ring_permute,
)

BACKENDS = ("bulk", "onesided")
# the elements of the pieces a placed gather's backward sums in one
# collective an axis (its f32 staging, 0.5 GB); a larger piece goes alone
GATHER_BUCKET_ELEMS = 1 << 27

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

def all_to_all(x: torch.Tensor, *, backend: str = "bulk",
               ctx=None) -> torch.Tensor:
    """All-to-all: ``(E_src, E_dst, C, ...)`` -> ``(E_dst, E_src, C,
    ...)``; rank d receives every rank's chunk for d, in rank order.
    ``"onesided"`` puts whole chunks from inside a kernel (one launch for
    all source ranks); ``"bulk"`` transposes with stock torch ops.  With
    ``ctx``, this rank's ``(E_dst, C, ...)`` -> ``(E_src, C, ...)``."""
    if ctx is not None:
        return _rank_all_to_all(x, backend, ctx)
    _record("all_to_all", x, backend)
    if backend == "onesided":
        _refuse_grad(x, "all_to_all", ONESIDED_NO_GRAD)
        return onesided_all_to_all(x)
    return x.transpose(0, 1).contiguous()


def all_gather(x: torch.Tensor, *, axis: int = 0, tiled: bool = False,
               backend: str = "bulk", ctx=None) -> torch.Tensor:
    """All-gather of the E ranks' ``x[r]``: stacked along a new ``axis``,
    or concatenated along ``axis`` when ``tiled``.  Every rank holds the
    same result; it is returned once.  With ``ctx``, ``x`` is this rank's
    value."""
    if ctx is not None:
        return _rank_all_gather(x, axis, tiled, backend, ctx)
    _record("all_gather", x, backend)
    parts = x.unbind(0)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts,
                                                                dim=axis)


def all_reduce(x: torch.Tensor, *, backend: str = "bulk",
               ctx=None) -> torch.Tensor:
    """Sum of the E ranks' ``x[r]`` (the reference's ``psum``), returned
    once, in ``x``'s dtype (an int32 sum wraps modulo 2**32, as the
    reference's does).  With ``ctx``, ``x`` is this rank's value."""
    if ctx is not None:
        return _rank_all_reduce(x, backend, ctx)
    _record("all_reduce", x, backend)
    return x.sum(dim=0, dtype=x.dtype)


def reduce_scatter(x: torch.Tensor, *, backend: str = "bulk",
                   emulate_with_a2a: bool = False, ctx=None) -> torch.Tensor:
    """Reduce-scatter over the leading per-rank dimension: ``(E_src, E_dst,
    M, ...)`` -> ``(E_dst, M, ...)``, rank d's sum over sources of their
    ``[d]``, in ``x``'s dtype.

    ``"onesided"`` always takes the paper's NVSHMEM 2.9 workaround (§4.4),
    the one-sided all-to-all and then a local sum, fused into one kernel
    that reads every source's chunk and sums it in registers.
    ``emulate_with_a2a`` takes the workaround's two passes on ``"bulk"``
    (a transpose, then a sum); otherwise the bulk route is one sum over
    sources (the reference's ``psum_scatter``).  With ``ctx``, this rank's
    ``(E_dst, M, ...)`` -> ``(M, ...)``."""
    if ctx is not None:
        return _rank_reduce_scatter(x, backend, emulate_with_a2a, ctx)
    _record("reduce_scatter", x, backend)
    if backend == "onesided":
        _refuse_grad(x, "reduce_scatter", ONESIDED_NO_GRAD)
        return onesided_reduce_scatter(x)
    if emulate_with_a2a:
        return x.transpose(0, 1).contiguous().sum(dim=1, dtype=x.dtype)
    return x.sum(dim=0, dtype=x.dtype)


def permute_ring(x: torch.Tensor, *, shift: int = 1,
                 backend: str = "bulk", ctx=None) -> torch.Tensor:
    """Ring collective-permute: ``(n, ...)`` -> ``(n, ...)``, rank ``(r +
    shift) % n`` receives rank r's block.  ``"onesided"`` puts each block
    from inside a kernel; ``"bulk"`` is ``torch.roll``.  With ``ctx``,
    ``x`` is this rank's block, and the result the block of rank ``(r -
    shift) % n``."""
    if ctx is not None:
        return _rank_permute_ring(x, shift, backend, ctx)
    _record("permute", x, backend)
    if backend == "onesided":
        _refuse_grad(x, "permute_ring", ONESIDED_NO_GRAD)
        return onesided_ring_permute(x, shift)
    return torch.roll(x, shift, dims=0)


# ---------------------------------------------------------------------------
# Collectives of one rank per process
# ---------------------------------------------------------------------------

# (op, backend) -> what carries it when the ranks are processes, on either
# device; chip_smoke.py logs it beside the group's backend
RANK_ROUTES = {
    ("all_to_all", "bulk"): "all_to_all_single",
    ("all_to_all", "onesided"): "put_chunks_kernel (CPU: all_to_all_single)",
    ("all_gather", "bulk"): "all_gather_into_tensor",
    ("all_gather", "onesided"): "all_gather_into_tensor",
    ("all_reduce", "bulk"): "all_reduce",
    ("all_reduce", "onesided"):
        "sum_chunks_kernel (CPU: all_gather_into_tensor + rank-order sum)",
    ("reduce_scatter", "bulk"): "reduce_scatter_tensor",
    ("reduce_scatter", "bulk+emulate"):
        "all_to_all_single + rank-order sum",
    ("reduce_scatter", "onesided"):
        "sum_chunks_kernel (CPU: all_to_all_single + rank-order sum)",
    ("permute", "bulk"): "all_to_all_single, one non-empty split each way",
    ("permute", "onesided"): "put_chunks_kernel, the ring entry "
                             "(CPU: isend + irecv)",
    ("fetch_rows", "bulk"):
        "all_gather_into_tensor x 2 (the row counts, the requests) + "
        "reduce_scatter_tensor",
    ("fetch_rows", "onesided"):
        "all_gather_into_tensor x 2 + put_chunks_kernel + the local sum "
        "(CPU: all_to_all_single + the sum)",
}


def _record_rank(op: str, x: torch.Tensor, backend: str, ctx,
                 axis_size: Optional[int] = None) -> None:
    """One event for this rank's collective: its payload, the axis's
    ranks (the model axis's unless ``axis_size`` is given)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of "
                         f"{BACKENDS}")
    if _LOG.events is None and _SINK is None:
        return
    t = time.perf_counter()
    _emit(CollectiveEvent(op, x.numel() * x.element_size(),
                          ctx.world if axis_size is None else axis_size,
                          backend, t, t))


# why the one-sided routes refuse a value that needs a gradient
ONESIDED_NO_GRAD = ("the one-sided route has no derivative (the "
                    "reference's Pallas put has none: jax.grad fails "
                    "inside it); train with backend='bulk', or run under "
                    "torch.no_grad()")

def _refuse_grad(x: torch.Tensor, what: str, why: str) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"{what}: the value needs a gradient, and {why}")


def _check_rank_value(x: torch.Tensor, ctx, what: str) -> None:
    if x.device != ctx.device:
        raise ValueError(f"{what}: this rank's value is on {x.device}, its "
                         f"context on {ctx.device}")


def _symmetric(ctx, name: str, x: torch.Tensor):
    """The rank's symmetric buffers for ``x`` on a card, None on the CPU
    (whose plain versions need none)."""
    if x.device.type != "cuda":
        return None
    return ctx.symmetric(name, x.numel() * x.element_size())


def _a2a_group(x: torch.Tensor, ctx) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=ctx.group)
    return out


def _gather_group(x: torch.Tensor, axis: int, tiled: bool, ctx, *,
                  n: Optional[int] = None, group=None) -> torch.Tensor:
    """The all-gather of ``x`` over ``group`` of ``n`` ranks (default:
    the model axis of ``ctx``)."""
    if n is None:
        n, group = ctx.world, ctx.group
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    _oa.all_gather_into(out, x.contiguous(), group)
    parts = out.unbind(0)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts,
                                                                dim=axis)


def _reduce_group(x: torch.Tensor, backend: str, ctx) -> torch.Tensor:
    x = x.contiguous()
    if backend == "onesided":
        return _oa.onesided_all_reduce_rank(x, ctx.rank, ctx.group,
                                            _symmetric(ctx, "send", x))
    out = x.clone()
    dist.all_reduce(out, group=ctx.group)
    return out


def _scatter_group(x: torch.Tensor, emulate_with_a2a: bool,
                   ctx) -> torch.Tensor:
    if emulate_with_a2a:
        return _a2a_group(x, ctx).sum(dim=0, dtype=x.dtype)
    out = torch.empty(tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _oa.reduce_scatter_into(out, x.contiguous(), ctx.group)
    return out


def _own_slice(g: torch.Tensor, axis: int, tiled: bool, n: int,
               rank: int) -> torch.Tensor:
    """This rank's part of an all-gathered value's cotangent."""
    if tiled:
        return g.narrow(axis, rank * n, n).contiguous()
    return g.select(axis, rank).contiguous()


class _AllReduce(torch.autograd.Function):
    """The sum of every rank's ``x``; the backward is the identity (every
    rank's partial takes the whole cotangent of the replicated sum)."""

    @staticmethod
    def forward(fctx, x, backend, ctx):
        return _reduce_group(x, backend, ctx)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` stacked or concatenated along ``axis``; the
    backward takes this rank's part of the replicated cotangent."""

    @staticmethod
    def forward(fctx, x, axis, tiled, ctx):
        fctx.args = (axis % (x.dim() + (0 if tiled else 1)), tiled,
                     x.shape[axis] if tiled else 1, ctx.rank)
        return _gather_group(x, axis, tiled, ctx)

    @staticmethod
    def backward(fctx, g):
        axis, tiled, n, rank = fctx.args
        return _own_slice(g, axis, tiled, n, rank), None, None, None


class _AllToAll(torch.autograd.Function):
    """The bulk all-to-all; the backward sends each cotangent chunk back
    to the rank that sent the chunk (the same all-to-all)."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _a2a_group(x, ctx)

    @staticmethod
    def backward(fctx, g):
        return _a2a_group(g, fctx.ctx), None


class _ReduceScatter(torch.autograd.Function):
    """The bulk reduce-scatter; the backward all-gathers the cotangents:
    this rank's chunk for rank d takes rank d's."""

    @staticmethod
    def forward(fctx, x, emulate_with_a2a, ctx):
        fctx.ctx = ctx
        return _scatter_group(x, emulate_with_a2a, ctx)

    @staticmethod
    def backward(fctx, g):
        return _gather_group(g, 0, False, fctx.ctx), None, None


class _Split(torch.autograd.Function):
    """This rank's slice of a value every rank holds alike (the whole
    value with ``axis`` None); the backward all-gathers the ranks'
    cotangents along ``axis`` (sums them)."""

    @staticmethod
    def forward(fctx, x, axis, ctx):
        fctx.axis, fctx.ctx = axis, ctx
        if axis is None:
            return x.view_as(x)
        n = x.shape[axis] // ctx.world
        return x.narrow(axis, ctx.rank * n, n).contiguous()

    @staticmethod
    def backward(fctx, g):
        if fctx.axis is None:
            return _reduce_group(g, "bulk", fctx.ctx), None, None
        return _gather_group(g, fctx.axis, True, fctx.ctx), None, None


def split(x: torch.Tensor, *, axis: Optional[int] = None,
          ctx) -> torch.Tensor:
    """The entry of ``x``, which every rank of ``ctx`` (a
    ``ProcessContext``) holds alike, into a computation each rank runs on
    its own share: this rank's ``1/E`` slice along ``axis`` (E must
    divide it), or with ``axis`` None the whole ``x``.  The forward sends
    nothing; under grad the backward all-gathers the ranks' cotangents
    along ``axis`` (sums them over the group), so the gradient upstream
    is the same on every rank -- the transpose of the reference's
    ``shard_map`` in_specs ``P(..., tp)`` (``P()``)."""
    if axis is not None and x.shape[axis] % ctx.world:
        raise ValueError(f"split: {ctx.world} ranks do not divide axis "
                         f"{axis} of {tuple(x.shape)}")
    return _Split.apply(x, axis, ctx)


class _DataGather(torch.autograd.Function):
    """Every data group's ``x`` concatenated along its leading axis; the
    backward takes this data group's rows of the replicated cotangent."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.args = (x.shape[0], ctx.dp_rank)
        return _gather_group(x, 0, True, ctx, n=ctx.dp_size,
                             group=ctx.data_group)

    @staticmethod
    def backward(fctx, g):
        n, d = fctx.args
        return g.narrow(0, d * n, n).contiguous(), None


class _DataReduce(torch.autograd.Function):
    """The sum of every data group's ``x``; the backward is the identity
    (each group's term takes the whole cotangent of the replicated
    sum)."""

    @staticmethod
    def forward(fctx, x, ctx):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=ctx.data_group)
        return out

    @staticmethod
    def backward(fctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class Placed:
    """A rank's piece of a parameter that a placement cuts over the mesh
    (``launch/specs.Placement``), in the tree a forward reads: ``local``
    the piece (a whole layer stack, ``index`` a layer of it once
    ``lm.layer`` has taken one), ``gather`` the axis each of its dims is
    all-gathered over before use (None: as held), ``grad`` the axis each
    dim of the gradient stays cut over (the moments' layout: an int8
    moment is whole along the last dim), ``ctx`` the ``ProcessContext``
    of the whole mesh.  Under grad the gradient is added into ``buffer``
    (that layout; a stack's, ``index`` selecting the layer), reduced over
    the model axis when ``summed`` (the rank used the parameter on its own
    tokens: an MoE layer's shared experts) and over the data axis when
    ``split`` (each data group ran its share of the batch)."""
    local: torch.Tensor
    gather: tuple
    grad: tuple
    ctx: object
    buffer: Optional[torch.Tensor] = None
    summed: bool = False
    split: bool = False
    index: Optional[int] = None

    def dims(self) -> tuple:
        """(gather, grad) entries of the value :func:`gathered` makes:
        the stack's less its layer dim when ``index`` is set."""
        if self.index is None:
            return self.gather, self.grad
        return self.gather[1:], self.grad[1:]


def _axis_group(ctx, axis: str):
    """(ranks, this rank's index, group) of ``axis`` of ``ctx``."""
    if axis == "model":
        return ctx.world, ctx.rank, ctx.group
    return ctx.dp_size, ctx.dp_rank, ctx.data_group


def _gather_many(xs: list, cuts: list, ctx) -> None:
    """Each ``xs[i]`` of ``cuts`` (``(i, {axis: dim})``) all-gathered over
    the axes it is cut over and concatenated along their dims: one
    all-gather a set of axes and dtype, of the pieces laid end to end,
    over the model axis's group, the data axis's, or the whole mesh (the
    world's group, global rank ``d * world + m``) for a piece cut over
    both."""
    sets: dict = {}
    for i, dims in cuts:
        sets.setdefault((tuple(sorted(dims)), xs[i].dtype), []).append(
            (i, dims))
    for (axes, dtype), part in sets.items():
        if len(axes) == 2:
            n, group = ctx.dp_size * ctx.world, None
        else:
            n, _, group = _axis_group(ctx, axes[0])
        flat = torch.cat([xs[i].reshape(-1) for i, _ in part])
        out = torch.empty((n, flat.numel()), dtype=dtype, device=flat.device)
        _oa.all_gather_into(out, flat, group)
        off = 0
        for i, dims in part:
            m = xs[i].numel()
            seg = out[:, off:off + m].reshape((n,) + tuple(xs[i].shape))
            off += m
            if len(dims) == 1:
                (d,) = dims.values()
                xs[i] = torch.cat(seg.unbind(0), dim=d)
                continue
            tp = ctx.world
            rows = [torch.cat(seg[g * tp:(g + 1) * tp].unbind(0),
                              dim=dims["model"])
                    for g in range(ctx.dp_size)]
            xs[i] = torch.cat(rows, dim=dims["data"])


def _reduce_many(xs: dict, cuts: list, whole: list, axis: str,
                 ctx) -> None:
    """Each ``xs[i]`` summed over ``axis`` in f32: this rank's slice along
    ``dim`` for each ``(i, dim)`` of ``cuts`` (one reduce-scatter of them
    laid end to end, rank-major), all of it for each ``i`` of ``whole``
    (one all-reduce).  Each piece goes into one f32 staging buffer in one
    copy that takes the cast and the layout."""
    n, _, group = _axis_group(ctx, axis)
    if cuts:
        rows = [xs[i].movedim(d, 0).unflatten(0, (n, -1)) for i, d in cuts]
        sizes = [r[0].numel() for r in rows]
        src = torch.empty((n, sum(sizes)), dtype=torch.float32,
                          device=rows[0].device)
        out = torch.empty(sum(sizes), dtype=torch.float32,
                          device=rows[0].device)
        off = 0
        for r, m in zip(rows, sizes):
            src[:, off:off + m].view(r.shape).copy_(r)
            off += m
        _oa.reduce_scatter_into(out, src, group)
        del src
        off = 0
        for (i, d), r, m in zip(cuts, rows, sizes):
            xs[i] = out[off:off + m].view(r.shape[1:]).movedim(0, d)
            off += m
    if whole:
        flat = torch.empty(sum(xs[i].numel() for i in whole),
                           dtype=torch.float32, device=xs[whole[0]].device)
        off = 0
        for i in whole:
            m = xs[i].numel()
            flat[off:off + m].view(xs[i].shape).copy_(xs[i])
            xs[i] = flat[off:off + m].view(xs[i].shape)
            off += m
        dist.all_reduce(flat, group=group)


class _PlacedGather(torch.autograd.Function):
    """The whole values of :class:`Placed` pieces (a layer's): all-gathered
    over the axes their ``gather`` names, the pieces cut over the same
    axes in one collective (:func:`_gather_many`).  The backward brings
    each whole
    cotangent back to its gradient's layout and adds it into the piece's
    buffer, passing nothing on: over the model axis this rank's slice
    (every model rank computed the same cotangent) or, when ``summed``,
    the sum over the model axis (a reduce-scatter; an all-reduce where
    the gradient stays whole); over the data axis the sum (a
    reduce-scatter, or an all-reduce) when ``split``, else this rank's
    slice.  Every sum runs in f32 and rounds once, into the buffer, one
    collective an axis for a bucket of pieces of up to
    :data:`GATHER_BUCKET_ELEMS` elements (a larger piece alone), each
    piece staged in f32 in one copy (:func:`_reduce_many`): a layer's
    pieces never stand in f32 all at once (a deepseek-v3 MoE layer's 128
    experts a rank are 22.5 GB in f32)."""

    @staticmethod
    def forward(fctx, ps, *local):
        fctx.set_materialize_grads(False)
        fctx.ps = ps
        xs = [x if p.index is None else x[p.index]
              for p, x in zip(ps, local)]
        _gather_many(xs, [(i, {e: d for d, e in enumerate(p.dims()[0])
                               if e is not None})
                          for i, p in enumerate(ps)], ps[0].ctx)
        return tuple(xs)

    @staticmethod
    def backward(fctx, *gs):
        ps = fctx.ps
        ctx = ps[0].ctx
        live = [i for i, g in enumerate(gs)
                if g is not None and ps[i].buffer is not None]

        def sums(p, axis):
            if axis == "model":
                return p.summed and ctx.world > 1
            return p.split and ctx.dp_size > 1

        # buckets of pieces of up to GATHER_BUCKET_ELEMS elements (a larger
        # piece alone), each through its axes' collectives and into its
        # buffers before the next
        buckets, size = [[]], 0
        for i in live:
            if buckets[-1] and size + gs[i].numel() > GATHER_BUCKET_ELEMS:
                buckets.append([])
                size = 0
            buckets[-1].append(i)
            size += gs[i].numel()
        for bucket in buckets:
            xs = {i: gs[i] for i in bucket}
            for axis in ("model", "data"):
                cuts, whole = [], []
                for i in bucket:
                    gather, keep = ps[i].dims()
                    dims = [d for d, e in enumerate(gather) if e == axis]
                    kept = bool(dims) and keep[dims[0]] == axis
                    if sums(ps[i], axis):
                        if kept:
                            cuts.append((i, dims[0]))
                        else:
                            whole.append(i)
                    elif kept:
                        n, r, _ = _axis_group(ctx, axis)
                        b = xs[i].shape[dims[0]] // n
                        xs[i] = xs[i].narrow(dims[0], r * b, b)
                _reduce_many(xs, cuts, whole, axis, ctx)
            for i in bucket:
                p = ps[i]
                buf = p.buffer if p.index is None else p.buffer[p.index]
                buf.add_(xs[i].to(buf.dtype))
            del xs
        return (None,) * (len(ps) + 1)


def gathered(tree):
    """``tree`` (a parameter tree, a layer of one, or one leaf) with each
    :class:`Placed` piece replaced by its whole value, all-gathered over
    the mesh, all of them in one :class:`_PlacedGather`; every other leaf
    as it is."""
    found: list = []

    def collect(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                collect(v, path + (k,))
        elif isinstance(t, Placed):
            found.append((path, t))

    collect(tree, ())
    if not found:
        return tree
    ps = tuple(p for _, p in found)
    whole = dict(zip((path for path, _ in found),
                     _PlacedGather.apply(ps, *(p.local for p in ps))))

    def rebuild(t, path):
        if isinstance(t, dict):
            return {k: rebuild(v, path + (k,)) for k, v in t.items()}
        return whole.get(path, t) if isinstance(t, Placed) else t

    return rebuild(tree, ())


def data_all_gather(x: torch.Tensor, *, ctx) -> torch.Tensor:
    """The data axis's all-gather of a ``ProcessContext``: every data
    group's ``x`` concatenated along the leading (batch) axis in
    data-group order, the same on every rank -- the rows a data group
    computed from its share of a batch, back whole (the reference's
    ``out_specs=P(dp, ...)``).  Under grad the backward hands each data
    group its own rows.  Without a data axis, ``x`` itself."""
    if ctx.dp_size == 1:
        return x
    _check_rank_value(x, ctx, "data_all_gather")
    _record_rank("all_gather", x, "bulk", ctx, axis_size=ctx.dp_size)
    return _DataGather.apply(x, ctx)


def data_all_reduce(x: torch.Tensor, *, ctx) -> torch.Tensor:
    """The data axis's all-reduce of a ``ProcessContext``: the sum of
    every data group's ``x`` (this rank's, and the same model rank's in
    the other groups) in ``x``'s dtype, the same on every rank -- a
    gradient of each group's share of a batch summed into the whole
    batch's.  Under grad the backward is the identity.  Without a data
    axis, ``x`` itself."""
    if ctx.dp_size == 1:
        return x
    _check_rank_value(x, ctx, "data_all_reduce")
    _record_rank("all_reduce", x, "bulk", ctx, axis_size=ctx.dp_size)
    return _DataReduce.apply(x, ctx)


def _rank_all_to_all(x: torch.Tensor, backend: str, ctx) -> torch.Tensor:
    _check_rank_value(x, ctx, "all_to_all")
    _record_rank("all_to_all", x, backend, ctx)
    if x.shape[0] != ctx.world:
        raise ValueError(f"all_to_all takes ({ctx.world}, ...) chunks, got "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    if backend == "onesided":
        _refuse_grad(x, "all_to_all", ONESIDED_NO_GRAD)
        return _oa.onesided_all_to_all_rank(x, ctx.rank, ctx.group,
                                            _symmetric(ctx, "recv", x))
    return _AllToAll.apply(x, ctx)


def _rank_all_gather(x: torch.Tensor, axis: int, tiled: bool,
                     backend: str, ctx) -> torch.Tensor:
    _check_rank_value(x, ctx, "all_gather")
    _record_rank("all_gather", x, backend, ctx)
    return _AllGather.apply(x, axis, tiled, ctx)


def _rank_all_reduce(x: torch.Tensor, backend: str, ctx) -> torch.Tensor:
    _check_rank_value(x, ctx, "all_reduce")
    _record_rank("all_reduce", x, backend, ctx)
    return _AllReduce.apply(x, backend, ctx)


def _rank_reduce_scatter(x: torch.Tensor, backend: str,
                         emulate_with_a2a: bool, ctx) -> torch.Tensor:
    _check_rank_value(x, ctx, "reduce_scatter")
    _record_rank("reduce_scatter", x, backend, ctx)
    if x.shape[0] != ctx.world:
        raise ValueError(f"reduce_scatter takes ({ctx.world}, ...) chunks, "
                         f"got {tuple(x.shape)}")
    x = x.contiguous()
    if backend == "onesided":
        _refuse_grad(x, "reduce_scatter", ONESIDED_NO_GRAD)
        return _oa.onesided_reduce_scatter_rank(
            x, ctx.rank, ctx.group, _symmetric(ctx, "send", x))
    return _ReduceScatter.apply(x, emulate_with_a2a, ctx)


def _permute_group(x: torch.Tensor, shift: int, ctx) -> torch.Tensor:
    """The bulk ring permute: one all-to-all whose only non-empty chunks
    are the block to ``(r + shift) % n`` and the one from ``(r - shift) %
    n``."""
    n, rank = ctx.world, ctx.rank
    flat = x.contiguous().reshape(-1)
    send = [0] * n
    recv = [0] * n
    send[(rank + shift) % n] = recv[(rank - shift) % n] = flat.numel()
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, output_split_sizes=recv,
                           input_split_sizes=send, group=ctx.group)
    return out.view(x.shape)


class _PermuteRing(torch.autograd.Function):
    """The bulk ring permute; the backward permutes the cotangent by
    ``-shift``, back to the rank that sent the block."""

    @staticmethod
    def forward(fctx, x, shift, ctx):
        fctx.shift, fctx.ctx = shift, ctx
        return _permute_group(x, shift, ctx)

    @staticmethod
    def backward(fctx, g):
        return _permute_group(g, -fctx.shift, fctx.ctx), None, None


def _rank_permute_ring(x: torch.Tensor, shift: int, backend: str,
                       ctx) -> torch.Tensor:
    _check_rank_value(x, ctx, "permute_ring")
    _record_rank("permute", x, backend, ctx)
    x = x.contiguous()
    if backend == "onesided":
        _refuse_grad(x, "permute_ring", ONESIDED_NO_GRAD)
        return _oa.onesided_ring_permute_rank(x, shift, ctx.rank, ctx.group,
                                              _symmetric(ctx, "recv", x))
    return _PermuteRing.apply(x, shift, ctx)


# ---------------------------------------------------------------------------
# The batched row fetch
# ---------------------------------------------------------------------------

def fetch_rows(shards: torch.Tensor, local_addr: torch.Tensor,
               owner: torch.Tensor, *, backend: str = "bulk", ctx=None
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
    plain version).

    With ``ctx`` (a ``ProcessContext``), ``shards`` is this rank's own
    ``(rows_local, D)`` shard and ``local_addr``/``owner`` the rows THIS
    rank asks for; every rank of the group calls at the same point with
    the same M (unequal M raises on every rank, as the reference's
    all-gather would fail).  The reference's protocol, each step a
    collective: all-gather every rank's request, build this rank's ``(E,
    M, D)`` contributions from its shard, and move them to the requesters
    with the group's ``reduce_scatter_tensor`` (``"bulk"``) or with puts
    into the peers' receive buffers and a local sum (``"onesided"``).
    Returns this rank's ``(M, D)``; one :class:`CollectiveEvent`
    ``("fetch_rows", E * M * D * itemsize, E, backend)``, the
    reference's, and none for the all-gathers of the requests."""
    if backend not in ("bulk", "onesided"):
        raise ValueError(f"unknown remote backend {backend!r}")
    if ctx is not None:
        return _rank_fetch_rows(shards, local_addr, owner, backend, ctx)
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
        _refuse_grad(contribs, "fetch_rows", ONESIDED_NO_GRAD)
        return onesided_fetch_rows(contribs)[0]
    return contribs.sum(dim=0)[0]


def _contributions(shard: torch.Tensor, safe: torch.Tensor,
                   mine: torch.Tensor) -> torch.Tensor:
    """This rank's ``(E_dst, M, D)`` contributions: the rows it owns at
    their owner-local addresses ``safe``, ``0 * row`` elsewhere."""
    contribs = shard[safe]
    return contribs.mul_(mine[..., None].to(shard.dtype))


class _FetchRows(torch.autograd.Function):
    """The bulk row fetch from this rank's contributions; the backward
    all-gathers the requesters' cotangents back to the owners, and each
    adds the rows it owns into its shard's gradient."""

    @staticmethod
    def forward(fctx, shard, safe, mine, ctx):
        fctx.save_for_backward(safe, mine)
        fctx.rows, fctx.ctx = shard.shape[0], ctx
        contribs = _contributions(shard, safe, mine)
        _record_rank("fetch_rows", contribs, "bulk", ctx)
        out = torch.empty(tuple(contribs.shape[1:]), dtype=shard.dtype,
                          device=shard.device)
        _oa.reduce_scatter_into(out, contribs, ctx.group)
        return out

    @staticmethod
    def backward(fctx, g):
        safe, mine = fctx.saved_tensors
        gathered = _gather_group(g, 0, False, fctx.ctx)     # (E_dst, M, D)
        gathered.mul_(mine[..., None].to(g.dtype))
        d = g.shape[-1]
        grad = torch.zeros((fctx.rows, d), dtype=g.dtype, device=g.device)
        grad.index_add_(0, safe.reshape(-1), gathered.reshape(-1, d))
        return grad, None, None, None


def _rank_fetch_rows(shard: torch.Tensor, local_addr: torch.Tensor,
                     owner: torch.Tensor, backend: str, ctx) -> torch.Tensor:
    _check_rank_value(shard, ctx, "fetch_rows")
    if backend == "onesided":
        _refuse_grad(shard, "fetch_rows", ONESIDED_NO_GRAD)
    if shard.dim() != 2:
        raise ValueError(f"fetch_rows: this rank's shard must be "
                         f"(rows_local, D), got {tuple(shard.shape)}")
    dev, E = shard.device, ctx.world
    m = local_addr.shape[0]
    # every rank's M first: the requests' all-gather needs equal sizes
    ms = torch.empty(E, dtype=torch.int64, device=dev)
    _oa.all_gather_into(ms, torch.full((1,), m, dtype=torch.int64,
                                       device=dev), ctx.group)
    ms = ms.tolist()
    if any(v != m for v in ms):
        raise ValueError(f"fetch_rows: the ranks ask for unequal row counts "
                         f"{ms}; every rank's request must have the same M")
    req = torch.stack([local_addr.to(dev, torch.int64),
                       owner.to(dev, torch.int64)])
    gathered = torch.empty((E,) + tuple(req.shape), dtype=torch.int64,
                           device=dev)
    _oa.all_gather_into(gathered, req, ctx.group)
    # (E_dst, M): this rank owns request m of requester q
    mine = gathered[:, 1] == ctx.rank
    safe = torch.where(mine, gathered[:, 0], 0)
    if backend == "bulk":
        return _FetchRows.apply(shard, safe, mine, ctx)
    contribs = _contributions(shard, safe, mine)
    _record_rank("fetch_rows", contribs, backend, ctx)
    return _oa.onesided_fetch_rows_rank(
        contribs, ctx.rank, ctx.group, _symmetric(ctx, "recv", contribs))
