"""ParallelContext -- the simulated mesh the distributed embedding bag and
the LM run over; ProcessContext -- one rank of a model axis whose ranks
are processes.

The counterpart of ``repro.core.parallel``.  The reference's context wraps
a jax ``Mesh``: its last axis is the model (tp) axis the tables, the
vocabulary, the experts and the decode cache's sequence are sharded over,
the others are data (dp) axes the batch is split over.  Here the mesh is
simulated in one process on one device:

  * the model axis has ``tp_size`` ranks, stacked on a leading rank axis
    (``core/comm.py``);
  * ``dp_size`` data-parallel groups split the batch and run one after
    another, each over the whole model axis.

Models take ``ctx: ParallelContext | None``; ``None`` is the single-device
path.  With a context the LM looks its tokens up through the row-wise
sharded embedding bag, runs its MoE layers expert-parallel over the ranks
and its decode attention over the ranks' slices of the cache
(``config.decode_kv_seq_sharded``).  The reference's GSPMD helpers
(``constrain``, ``sharding``, ``batch_spec``) place tensors on a device
mesh and change no value; one card holds every tensor whole, so the port
has none of them.

Beside the simulation, a rank can be a process, the standard PyTorch
idiom (:class:`ProcessContext`, :func:`make_process_context`,
:func:`run_ranks`): it holds only its own shard on its own device, and
its collectives go through a ``torch.distributed`` process group
(``core/comm.py``), its one-sided puts into the peers' buffers through
CUDA IPC (``kernels/onesided_a2a.SymmetricBuffers``).  The world is laid
out as the reference's ``("data", "model")`` mesh, the model axis last:
global rank ``d * tp_size + m`` is rank m of data group d.  A rank's
model-axis collectives go through its data group's model-axis subgroup,
its data-axis collectives (``comm.data_all_gather``,
``comm.data_all_reduce``) through its model rank's data-axis subgroup.
The distributed embedding bag, the DLRM forward, its engine and its
training flow take either context, and so do the LM's serving paths
(``lm.forward``, prefill, decode, ``generate``, ``ContinuousBatcher``:
each rank holds its rows of the vocabulary, its experts and its slice of
the decode cache, ``utils/convert.lm_params_for_rank``) and its train
step and ``Trainer`` (the rank collectives carry the gradient back to
each rank's share).  With a data axis, a data group runs its share of a
batch over its model axis (:meth:`ProcessContext.model_axis`) and the
results come back whole over the data axis.  The train state's placement
(``launch/specs.py``) cuts leaves over both axes by specs, one entry a
dim (:func:`cut_index`, :func:`cut_shape`, :func:`whole_shape`).
The backends:

  * ``"gloo"`` -- on the CPU, and on the card, where several ranks may
    share one device (the one-sided puts then cross processes on it);
  * ``"nccl"`` -- one rank per card: NCCL refuses two ranks on one
    device, so a group that would put two there raises (use gloo).
"""
from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShardingConfig


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    tp_size: int                        # ranks of the model axis
    dp_size: int = 1                    # data-parallel groups
    config: ShardingConfig = ShardingConfig()

    def __post_init__(self):
        if self.tp_size < 1 or self.dp_size < 1:
            raise ValueError(f"tp_size and dp_size must be >= 1, got "
                             f"{self.tp_size} and {self.dp_size}")

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """The data axis, when there is one (``dp_size > 1``)."""
        return ("data",) if self.dp_size > 1 else ()

    def dp_for(self, dim: int) -> Optional[Tuple[str, ...]]:
        """The dp axes usable to shard a dim of this size (divisibility);
        None when the dim stays replicated over the data axis."""
        if self.dp_axes and dim % self.dp_size == 0:
            return self.dp_axes
        return None

    def tp_for(self, dim: int) -> Optional[str]:
        """The model axis when it divides a dim of this size, else None
        (the dim stays replicated over the ranks)."""
        return "model" if dim % self.tp_size == 0 else None

    def dp_groups(self, dim: int) -> int:
        """How many groups a batch of ``dim`` rows is split into: ``dp_size``
        when it divides, else 1 (every group would score the same replicated
        batch)."""
        return self.dp_size if self.dp_for(dim) else 1


def make_context(tp_size: int, dp_size: int = 1,
                 sharding: Optional[ShardingConfig] = None
                 ) -> ParallelContext:
    """A simulated ``(dp_size, tp_size)`` mesh: the last axis is the model
    axis, the data axis exists when ``dp_size > 1`` -- as the reference's
    ``make_context`` infers the axes of a ``("data", "model")`` or a
    ``("model",)`` mesh -- with the mesh knobs ``sharding``."""
    return ParallelContext(tp_size=tp_size, dp_size=dp_size,
                           config=sharding or ShardingConfig())


# ---------------------------------------------------------------------------
# One rank per process
# ---------------------------------------------------------------------------

PROCESS_BACKENDS = ("gloo", "nccl")
# a group's collectives and run_ranks give up after this long: a rank
# that dies fails the run instead of hanging it
DEFAULT_TIMEOUT_S = 600.0
_MIN_SYMMETRIC_BYTES = 1 << 20


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessContext:
    """One rank of a ``(dp_size, world)`` mesh of processes, the model
    axis last: this process's model-axis ``rank`` of ``world`` ranks, its
    ``device``, the ``torch.distributed`` ``group`` of its data group's
    model axis (None: the default group, when the model axis is the
    whole world), and, with a data axis (``dp_size > 1``), its data group
    ``dp_rank`` and the ``data_group`` of the ranks that hold its model
    rank in every data group.  ``rank``/``world``/``group`` are the model
    axis's, so every reader of a rank's share (its table shard, its rows
    of the vocabulary, its experts, its slice of the decode cache) reads
    the same share in every data group.

    :meth:`symmetric` holds the rank's symmetric buffers of the one-sided
    exchanges on a card, built and grown collectively over the model
    axis; :meth:`close` frees them."""

    group: Any
    rank: int
    world: int
    device: torch.device
    config: ShardingConfig = ShardingConfig()
    dp_size: int = 1
    dp_rank: int = 0
    data_group: Any = None
    _buffers: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                                  repr=False)
    _views: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                                repr=False)

    def __post_init__(self):
        if not 0 <= self.dp_rank < self.dp_size:
            raise ValueError(f"dp_rank {self.dp_rank} is not a data group "
                             f"of {self.dp_size}")

    @property
    def tp_size(self) -> int:
        return self.world

    @property
    def global_rank(self) -> int:
        """This rank in the world: ``dp_rank * world + rank``."""
        return self.dp_rank * self.world + self.rank

    # ParallelContext's queries
    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return ("data",) if self.dp_size > 1 else ()

    def dp_for(self, dim: int) -> Optional[Tuple[str, ...]]:
        if self.dp_axes and dim % self.dp_size == 0:
            return self.dp_axes
        return None

    def tp_for(self, dim: int) -> Optional[str]:
        return "model" if dim % self.world == 0 else None

    def dp_groups(self, dim: int) -> int:
        return self.dp_size if self.dp_for(dim) else 1

    def data_rows(self, dim: int) -> slice:
        """This data group's rows of a batch of ``dim``: ``[d dim/dp, (d +
        1) dim/dp)`` when ``dp_size`` divides it, else all of them (every
        group runs the whole batch, as :meth:`dp_groups` says)."""
        n = self.dp_groups(dim)
        if n == 1:
            return slice(None)
        b = dim // n
        return slice(self.dp_rank * b, (self.dp_rank + 1) * b)

    def model_axis(self) -> "ProcessContext":
        """The context a data group's share of a batch runs under: this
        rank of its data group's model axis, with no data axis -- the same
        group, rank, device, knobs and symmetric buffers.  Itself without
        a data axis; one view per context otherwise, so
        :func:`same_model_axis` holds between them."""
        if self.dp_size == 1:
            return self
        view = self._views.get("model")
        if view is None:
            view = self._views["model"] = dataclasses.replace(
                self, dp_size=1, dp_rank=0, data_group=None, _views={})
        return view

    def symmetric(self, name: str, nbytes: int):
        """The symmetric buffers ``name`` ("send" or "recv") of at least
        ``nbytes`` on every rank.  Collective: every rank asks at the same
        point for the same size (the ranks run the same exchanges in
        lockstep); a larger size replaces the buffers, at the next power
        of two."""
        from repro_torch.kernels.onesided_a2a import SymmetricBuffers, fence

        bufs = self._buffers.get(name)
        if bufs is not None and bufs.nbytes >= nbytes:
            return bufs
        if bufs is not None:
            fence(self.group, self.device)   # no rank still reads them
            bufs.close()
        size = max(_MIN_SYMMETRIC_BYTES, 1 << (int(nbytes) - 1).bit_length())
        bufs = self._buffers[name] = SymmetricBuffers(
            self.group, self.rank, self.world, self.device, size)
        return bufs

    def close(self) -> None:
        """Collective: free the symmetric buffers."""
        if self._buffers:
            from repro_torch.kernels.onesided_a2a import fence

            fence(self.group, self.device)
            for bufs in self._buffers.values():
                bufs.close()
            self._buffers.clear()


def same_model_axis(a: ProcessContext, b: ProcessContext) -> bool:
    """Whether two contexts are one rank of one model axis: the same
    context, or a context and its :meth:`ProcessContext.model_axis`."""
    return a is b or a.model_axis() is b.model_axis()


def data_split(ctx, batch: int) -> Optional[Tuple[slice, ProcessContext]]:
    """(this data group's rows of a batch of ``batch``, the model-axis
    context they run under) under a ``ProcessContext`` whose data groups
    split the batch (``dp_size`` divides it); None otherwise: no context,
    simulated ranks, no data axis, or every group runs the whole
    batch."""
    if isinstance(ctx, ProcessContext) and ctx.dp_groups(batch) > 1:
        return ctx.data_rows(batch), ctx.model_axis()
    return None


# ---------------------------------------------------------------------------
# A leaf's piece under a spec
# ---------------------------------------------------------------------------
#
# A spec (``launch/specs.py``) places a leaf over the ``("data", "model")``
# mesh as the reference's ``PartitionSpec`` does, as a plain tuple with one
# entry per dim: None (whole), ``"model"`` (cut over the model axis) or
# ``("data",)`` (cut over the data axis).

def spec_axis(entry) -> Optional[str]:
    """``"model"``, ``"data"`` or None: the axis one entry of a spec cuts
    its dim over."""
    if entry is None:
        return None
    if entry in ("model", "data"):
        return entry
    if tuple(entry) == ("data",):
        return "data"
    raise ValueError(f"a spec entry is None, 'model' or ('data',), got "
                     f"{entry!r}")


def axis_ranks(ctx: "ProcessContext", axis: str) -> Tuple[int, int]:
    """(ranks, this rank's index) along ``axis`` of ``ctx``."""
    if axis == "model":
        return ctx.world, ctx.rank
    return ctx.dp_size, ctx.dp_rank


def cut_index(spec, shape, ctx, *, dp_rank: Optional[int] = None,
              rank: Optional[int] = None, what: str = "a leaf") -> tuple:
    """The index of this rank's piece (or of model rank ``rank`` of data
    group ``dp_rank``) of a leaf of ``shape`` placed by ``spec``: along a
    dim cut over an axis of k ranks, the rank's ``1/k`` slice of it.
    Raises ``ValueError`` naming ``what`` when the spec does not fit the
    shape or an axis does not divide its dim."""
    if len(spec) != len(shape):
        raise ValueError(f"{what}: a spec of {len(spec)} entries for a "
                         f"leaf of shape {tuple(shape)}")
    idx = []
    for entry, n in zip(spec, shape):
        axis = spec_axis(entry)
        if axis is None:
            idx.append(slice(None))
            continue
        k, r = axis_ranks(ctx, axis)
        want = dp_rank if axis == "data" else rank
        r = r if want is None else want
        if n % k:
            raise ValueError(f"{what}: the {axis} axis's {k} ranks do not "
                             f"divide a dim of {n} (shape {tuple(shape)}, "
                             f"spec {tuple(spec)})")
        b = n // k
        idx.append(slice(r * b, (r + 1) * b))
    return tuple(idx)


def cut_shape(spec, shape, ctx, what: str = "a leaf") -> Tuple[int, ...]:
    """The shape of a rank's piece of a leaf of ``shape`` under
    ``spec``."""
    return tuple(len(range(n)[s]) for n, s in
                 zip(shape, cut_index(spec, shape, ctx, what=what)))


def whole_shape(spec, piece_shape, ctx) -> Tuple[int, ...]:
    """The shape of the leaf of which a rank's piece has ``piece_shape``
    under ``spec``."""
    return tuple(n * (axis_ranks(ctx, spec_axis(e))[0] if spec_axis(e)
                      else 1) for e, n in zip(spec, piece_shape))


def _default_device() -> torch.device:
    """``cuda:{local_rank % device_count}``; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device(f"cuda:{local % torch.cuda.device_count()}")


def _check_nccl(devices: Sequence[torch.device]) -> None:
    """NCCL takes one rank per card: a CPU rank, or two ranks on one
    device, raise (gloo runs both)."""
    if any(d.type != "cuda" for d in devices):
        raise ValueError("backend 'nccl' runs ranks on cards only; use "
                         "backend='gloo' for CPU ranks")
    if len(set(devices)) < len(devices):
        raise ValueError(
            f"backend 'nccl' takes one rank per card, and {len(devices)} "
            f"ranks would share {len(set(devices))} device(s) (NCCL "
            f"refuses two ranks on one device); use backend='gloo' to "
            f"share a card")


def _mesh_groups(tp_size: int, dp: int, timeout_s: float, kw: dict):
    """(this rank's model-axis group, its data-axis group): every rank
    creates every group, in the same order -- the dp model-axis groups,
    then the tp_size data-axis groups -- as ``new_group`` requires."""
    d, m = divmod(dist.get_rank(), tp_size)
    timeout = timedelta(seconds=timeout_s)
    model = [dist.new_group([g * tp_size + j for j in range(tp_size)],
                            timeout=timeout, **kw) for g in range(dp)]
    data = [dist.new_group([g * tp_size + j for g in range(dp)],
                           timeout=timeout, **kw) for j in range(tp_size)]
    return model[d], data[m]


def make_process_context(tp_size: Optional[int] = None,
                         dp_size: Optional[int] = None, *, device=None,
                         sharding: Optional[ShardingConfig] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S
                         ) -> ProcessContext:
    """This process's rank of a ``(dp_size, tp_size)`` mesh of the
    initialised default group's ranks, the model axis last, as the
    reference's ``("data", "model")`` mesh: global rank ``d * tp_size +
    m`` is rank m of data group d.  ``tp_size`` None: the world over
    ``dp_size``; ``dp_size`` None: the world over ``tp_size`` (both None:
    one model axis of the whole world).  ``tp_size`` must divide the
    world and ``tp_size * dp_size`` equal it (``ValueError``).  With a
    data axis every rank creates every model-axis and data-axis subgroup
    (collective; with NCCL on the rank's device), their collectives
    giving up after ``timeout_s``.  On ``device`` (None:
    ``cuda:{LOCAL_RANK % device_count}``, raising without a card), with
    the mesh knobs ``sharding``."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: start "
                           "the ranks with run_ranks, or call "
                           "init_process_group first")
    world = dist.get_world_size()
    if tp_size is None:
        tp_size = world // (dp_size or 1)
    if tp_size < 1 or world % tp_size:
        raise ValueError(f"tp_size {tp_size} != the group's {world} ranks, "
                         f"nor divides them into data groups")
    dp = world // tp_size
    if dp_size is not None and dp_size != dp:
        raise ValueError(f"tp_size {tp_size} x dp_size {dp_size} != the "
                         f"group's {world} ranks")
    dev = _default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for "
                               f"device={dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    nccl = dist.get_backend() == "nccl"
    if nccl and (dev.type != "cuda" or world > torch.cuda.device_count()):
        _check_nccl([dev] * world)
    group = data_group = None
    if dp > 1:
        group, data_group = _mesh_groups(
            tp_size, dp, timeout_s, {"device_id": dev} if nccl else {})
    d, m = divmod(dist.get_rank(), tp_size)
    return ProcessContext(group=group, rank=m, world=tp_size, device=dev,
                          config=sharding or ShardingConfig(), dp_size=dp,
                          dp_rank=d, data_group=data_group)


def _rank_main(index: int, fn: Callable, world: int, dp_size: int,
               backend: str, devices: Sequence[str], store: str,
               result: str, timeout_s: float,
               sharding: Optional[ShardingConfig], box: list) -> None:
    """One rank's process: join the group through the file store, run
    ``fn(ctx, *box[0])``, and keep rank 0's result.

    The arguments come in a list that is emptied when ``fn`` returns: a
    CUDA tensor received through CUDA IPC keeps its sender's memory
    until the receiver drops it, and the process ends by ``os._exit``,
    which drops nothing."""
    device = torch.device(devices[index])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=index,
        world_size=world, timeout=timedelta(seconds=timeout_s),
        **({"device_id": device} if backend == "nccl" else {}))
    try:
        ctx = make_process_context(world // dp_size, dp_size, device=device,
                                   sharding=sharding, timeout_s=timeout_s)
        out = fn(ctx, *box.pop())
        gc.collect()
        ctx.close()
        if index == 0:
            torch.save(out, result)
    except BaseException:
        # stamped (perf_counter is the system-wide monotonic clock on
        # Linux), so the parent can tell the first failure from the others
        # it brings down
        with open(os.path.join(os.path.dirname(result),
                               f"error_{index}"), "w") as f:
            f.write(f"{time.perf_counter()!r}\n{traceback.format_exc()}")
        raise
    finally:
        box.clear()
        dist.destroy_process_group()


def _first_error(tmp: str) -> Optional[Tuple[int, str]]:
    """(rank, traceback) of the earliest error a rank recorded in
    ``tmp``, or None."""
    errors = []
    for name in os.listdir(tmp):
        if name.startswith("error_"):
            with open(os.path.join(tmp, name)) as f:
                stamp, _, text = f.read().partition("\n")
            errors.append((float(stamp), int(name[6:]), text))
    if not errors:
        return None
    _, rank, text = min(errors)
    return rank, text


def run_ranks(fn: Callable, world: int, *, backend: str, device=None,
              args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S,
              sharding: Optional[ShardingConfig] = None, dp_size: int = 1):
    """Run ``fn(ctx, *args)`` on ``world`` ranks, one process each, and
    return global rank 0's result.  The ranks form a ``(dp_size, world /
    dp_size)`` mesh (:func:`make_process_context`; ``dp_size`` must divide
    ``world``), and each rank's ``ctx`` carries the mesh knobs
    ``sharding``.

    The processes start with the ``spawn`` method and meet through a
    ``FileStore`` in a temporary directory (no network).  Each rank's
    device is ``device`` when given ("cpu", or one card every rank
    shares), else ``cuda:{rank % device_count}``, raising without a card.
    ``args`` go to every rank (CUDA tensors through CUDA IPC, which the
    caller keeps alive until the call returns; each rank drops them when
    ``fn`` returns, so that the caller frees their memory when it drops
    them too); the result goes back through ``torch.save``, so return
    CPU tensors and plain values.  A
    rank that raises or dies fails the run: the other ranks are stopped,
    and the first rank's error is raised here.  The group's collectives,
    and the whole run, give up after ``timeout_s``."""
    if backend not in PROCESS_BACKENDS:
        raise ValueError(f"backend must be one of {PROCESS_BACKENDS}, got "
                         f"{backend!r}")
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if dp_size < 1 or world % dp_size:
        raise ValueError(f"dp_size {dp_size} does not divide the world of "
                         f"{world} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "ranks on the CPU")
        n = torch.cuda.device_count()
        devices = [torch.device(f"cuda:{r % n}") for r in range(world)]
    else:
        devices = [torch.device(device)] * world
        if devices[0].type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device is available for "
                               f"device={device}")
    if backend == "nccl":
        _check_nccl(devices)
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    tmp = tempfile.mkdtemp(prefix="run_ranks_")
    try:
        result = os.path.join(tmp, "result.pt")
        procs = mp.start_processes(
            _rank_main, args=(fn, world, dp_size, backend,
                              [str(d) for d in devices],
                              os.path.join(tmp, "store"), result, timeout_s,
                              sharding, [tuple(args)]),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not procs.join(timeout=0.5):
                if time.monotonic() > deadline:
                    for p in procs.processes:
                        if p.is_alive():
                            p.kill()
                    raise TimeoutError(f"run_ranks: the {world} ranks did "
                                       f"not finish within {timeout_s} s")
        except ProcessException as e:
            first = _first_error(tmp)
            if first is None:
                raise
            raise RuntimeError(f"run_ranks: rank {first[0]} failed first:"
                               f"\n{first[1]}") from e
        return torch.load(result, weights_only=False)
    finally:
        if torch.cuda.is_initialized():
            # free what the ranks released of the CUDA tensors they were
            # sent (once the caller drops them too)
            torch.cuda.ipc_collect()
        shutil.rmtree(tmp, ignore_errors=True)
