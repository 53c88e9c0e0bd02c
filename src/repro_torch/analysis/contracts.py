"""Kernel & collective contract auditor for PyTorch programs.

The counterpart of ``repro.analysis.contracts``.  The paper's structural
claims are launch/traffic INVARIANTS -- one fused gather+pool launch per
forward, no collectives on the cached hot path, an in-place slot-pool
scatter, no host sync on a serving path -- and this module states them
once, declaratively:

  * :class:`KernelContract` -- what a hot entry point promises: launch
    bounds, the allowed collectives, arguments written in place, a
    float-width ceiling (no silent f64 upcast), and a host-transfer ban.
  * :func:`audit` -- runs ``fn(*args)`` ONCE, eagerly, takes a
    :class:`Census` of that call and judges it against a contract.

Where the reference walks a traced jaxpr, the port observes one run:

  * **launches** -- a ``TorchDispatchMode`` never sees a kernel of this
    port: the wrappers launch through ``ctypes``, which dispatches
    nothing.  So every kernel wrapper counts its own calls, on both
    devices (``CALL_COUNTS`` beside ``LAUNCH_COUNTS`` in
    ``repro_torch.kernels.embedding_gather``, ``.onesided_a2a`` and
    ``.flash_attention``), and the census reads their deltas.  On the
    card it also reads the ``LAUNCH_COUNTS`` deltas and, where asked
    (``device_kernel=``), the ``torch.profiler`` device-kernel events of
    that name: one fused forward must be one TBE kernel on the device.
  * **collectives** -- the ``CollectiveEvent`` op names of
    ``repro_torch.core.comm``, through an event sink installed for the
    call.
  * **float width, host transfers, allocations** -- a
    ``TorchDispatchMode`` census of every aten op: its outputs' float
    dtypes; ``aten._local_scalar_dense`` (``.item()``, ``bool()`` of a
    tensor) and any copy between a CUDA and a CPU tensor; and every new
    tensor as large as an argument the contract says is written in place.
    On the card the call also runs under
    ``torch.cuda.set_sync_debug_mode("error")``, which catches the syncs
    a dispatch mode cannot see (the copy inside ``torch.as_tensor``), and
    its peak of allocated device memory is read.

``in_place_argnums`` is the reference's ``donate_argnums``: where XLA
aliases a donated buffer, PyTorch writes the tensor where it lies, so the
argument's ``data_ptr()`` and storage size must be unchanged after the
call and no new tensor as large as it may be allocated.  ``min_launches``
/ ``max_launches`` are the reference's ``min/max_pallas_calls``.

Not ported: ``audit_hlo``, ``parse_collectives`` and ``donated_argnums``
read XLA HLO and StableHLO, which a PyTorch program does not have.

Hot modules ATTACH contracts (``KERNEL_CONTRACTS`` dicts in
``kernels/ops.py``, ``cache/cached_bag.py``, ``core/embedding_bag.py``,
``serving/engine.py``, ``cache/tiers.py``); the tests, ``chip_smoke.py``
and ``python -m repro_torch.analysis --contracts`` audit against them.
This module imports no module of the port at import time, so the hot
modules can import it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# the modules whose wrappers launch the port's kernels
KERNEL_MODULES = ("repro_torch.kernels.embedding_gather",
                  "repro_torch.kernels.onesided_a2a",
                  "repro_torch.kernels.flash_attention")
# the TBE gather+pool kernel's name in a profile
TBE_KERNEL = "tbe_gather_pool_kernel"
# aten ops that copy; one between a CUDA and a CPU tensor is a host
# transfer
_COPY_OPS = frozenset({"_to_copy", "copy_", "_copy_from",
                       "_copy_from_and_resize"})


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """What one hot entry point promises, declaratively.

    ``min/max_launches`` bound the kernel launches of one call (the
    reference's ``min/max_pallas_calls``: the fused TBE paths promise
    exactly one; the in-place scatter promises zero).
    ``allowed_collectives`` whitelists ``CollectiveEvent`` op names
    (``all_to_all``, ``all_gather``, ``reduce_scatter``, ``all_reduce``,
    ``permute``, ``fetch_rows``); anything else is a violation.
    ``in_place_argnums`` lists arguments that MUST be written where they
    lie (the reference's ``donate_argnums``).  ``max_float_bits`` caps
    every op output's float width (64 never passes by default -- no
    silent f64 upcast; 16 for bf16-only paths).
    """

    name: str
    min_launches: int = 1
    max_launches: int = 1
    allowed_collectives: Tuple[str, ...] = ()
    in_place_argnums: Tuple[int, ...] = ()
    max_float_bits: int = 32
    forbid_host_transfers: bool = True
    note: str = ""


@dataclasses.dataclass
class Census:
    """What one call did.  ``calls`` (kernel-wrapper calls) is taken on
    both devices; ``launches`` is non-zero only on the card, and
    ``device_kernels`` is taken only where asked (the card, a profile)."""

    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    device_kernels: Optional[int] = None
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    host_transfers: Dict[str, int] = dataclasses.field(default_factory=dict)
    float_dtypes: set = dataclasses.field(default_factory=set)
    ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    # new tensors as large as an in-place argument: (op, bytes)
    large_allocs: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)
    device: str = "cpu"

    @property
    def kernel_calls(self) -> int:
        return sum(self.calls.values())

    @property
    def kernel_launches(self) -> int:
        return sum(self.launches.values())


@dataclasses.dataclass
class AuditReport:
    """The verdict: a census plus every contract violation found."""

    contract: KernelContract
    violations: List[str]
    census: Optional[Census] = None

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_if_failed(self) -> "AuditReport":
        if self.violations:
            raise ContractViolation(self.contract.name, self.violations)
        return self


class ContractViolation(AssertionError):
    """Raised by :meth:`AuditReport.raise_if_failed` -- an AssertionError
    so test asserts keep their failure semantics."""

    def __init__(self, name: str, violations: Sequence[str]):
        self.contract_name = name
        self.violations = list(violations)
        lines = "\n  - ".join(violations)
        super().__init__(f"kernel contract {name!r} violated:\n  - {lines}")


# ---------------------------------------------------------------------------
# The census
# ---------------------------------------------------------------------------

def _bump(counts: Dict[str, int], key: str) -> None:
    counts[key] = counts.get(key, 0) + 1


class _OpCensus(TorchDispatchMode):
    """Every aten op of the call: its name, its outputs' float dtypes,
    host transfers, and new outputs of at least ``watch_bytes``."""

    def __init__(self, census: Census, watch_bytes: Optional[int]):
        super().__init__()
        self.census = census
        self.watch_bytes = watch_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.census
        name = func.overloadpacket.__name__
        _bump(c.ops, name)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if name == "_local_scalar_dense":
            _bump(c.host_transfers, "aten._local_scalar_dense (.item(), "
                                    "bool() of a tensor)")
        if name in _COPY_OPS:
            kinds = {t.device.type for t in ins + outs}
            if "cpu" in kinds and "cuda" in kinds:
                _bump(c.host_transfers, f"aten.{name} between CUDA and CPU")
        for t in outs:
            if t.is_floating_point():
                c.float_dtypes.add(str(t.dtype).replace("torch.", ""))
        if self.watch_bytes is not None:
            mine = {t.untyped_storage().data_ptr() for t in ins}
            for t in outs:
                st = t.untyped_storage()
                if st.data_ptr() not in mine and \
                        st.nbytes() >= self.watch_bytes:
                    c.large_allocs.append((f"aten.{name}", st.nbytes()))
        return out


def _kernel_modules():
    import importlib

    return [importlib.import_module(m) for m in KERNEL_MODULES]


def _counts(mods, attr: str) -> Dict[str, int]:
    return {k: v for m in mods for k, v in getattr(m, attr).items()}


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _tensors(tree):
    """Every tensor in nested dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


@contextlib.contextmanager
def _sync_errors(on: bool):
    """``torch.cuda.set_sync_debug_mode("error")`` for the block."""
    if not on:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _profiled_kernels(prof, kernel: str) -> Tuple[int, int]:
    """(launches of device kernels named ``kernel``, all device events)."""
    from torch.autograd import DeviceType

    ran = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0
           and not e.key.startswith("Activity Buffer")]
    return (sum(e.count for e in ran if kernel in e.key),
            sum(e.count for e in ran))


# Profiles of one call taken before its device-kernel count is read as
# zero; the profiler now and then records no device event of a call.
_PROFILE_TRIES = 3


def _profile(on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def summarize(fn, args: Sequence, contract: Optional[KernelContract] = None,
              *, device_kernel: Optional[str] = None) -> Census:
    """Run ``fn(*args)`` once and take its :class:`Census`.

    ``contract`` says which arguments to watch for in-place writes and
    whether the card's sync errors are on.  ``device_kernel`` (card only)
    profiles the call and counts device kernels of that name; the
    profiler now and then records no device event of a call at all, and
    then (only then) the call is profiled again, up to
    :data:`_PROFILE_TRIES` times in all, for that count alone."""
    from repro_torch.core import comm

    contract = contract or KernelContract(name="summary")
    args = tuple(args)
    cuda = any(t.is_cuda for t in _tensors(args))
    census = Census(device="cuda" if cuda else "cpu")
    watch = {i: (args[i].data_ptr(), args[i].untyped_storage().nbytes())
             for i in contract.in_place_argnums}
    watch_bytes = min((n for _, n in watch.values()), default=None)
    mods = _kernel_modules()
    calls0, launches0 = _counts(mods, "CALL_COUNTS"), \
        _counts(mods, "LAUNCH_COUNTS")
    profiling = cuda and device_kernel is not None
    if cuda:
        torch.cuda.synchronize()
    if cuda and watch:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    prev_sink = comm.set_event_sink(
        lambda ev: _bump(census.collectives, ev.op))
    try:
        with _profile(profiling) as prof:
            with _OpCensus(census, watch_bytes):
                with _sync_errors(cuda and contract.forbid_host_transfers):
                    try:
                        fn(*args)
                    except RuntimeError as e:
                        if "synchroniz" not in str(e):
                            raise
                        _bump(census.host_transfers,
                              "a synchronizing CUDA call under "
                              "set_sync_debug_mode('error'): "
                              + str(e).splitlines()[0])
            if cuda:
                torch.cuda.synchronize()
    finally:
        comm.set_event_sink(prev_sink)
    census.calls = _delta(_counts(mods, "CALL_COUNTS"), calls0)
    census.launches = _delta(_counts(mods, "LAUNCH_COUNTS"), launches0)
    if cuda and watch:
        peak = torch.cuda.max_memory_allocated() - base
        for i, (_, nbytes) in watch.items():
            if peak >= nbytes:
                census.large_allocs.append(
                    (f"device memory peak of the call (argnum {i})", peak))
    for i, (ptr, nbytes) in watch.items():
        if args[i].data_ptr() != ptr or \
                args[i].untyped_storage().nbytes() != nbytes:
            census.large_allocs.append((f"argnum {i} moved or resized",
                                        nbytes))
    if profiling:
        n, seen = _profiled_kernels(prof, device_kernel)
        for _ in range(_PROFILE_TRIES - 1):
            if seen:
                break
            with _profile(True) as again:
                fn(*args)
                torch.cuda.synchronize()
            n, seen = _profiled_kernels(again, device_kernel)
        census.device_kernels = n
    return census


def count_launches(fn, *args) -> int:
    """Kernel-wrapper calls of one ``fn(*args)`` (the reference's
    ``count_pallas_calls``)."""
    return summarize(fn, args).kernel_calls


def _bounds(contract: KernelContract) -> str:
    if contract.min_launches == contract.max_launches:
        return f"exactly {contract.max_launches}"
    return f"{contract.min_launches}..{contract.max_launches}"


def audit(fn, args: Sequence, contract: KernelContract, *,
          device_kernel: Optional[str] = None) -> AuditReport:
    """Run ``fn(*args)`` once and judge it against ``contract``.

    ``device_kernel`` (the card only; e.g. :data:`TBE_KERNEL`) also holds
    the profiler's count of device kernels of that name to the launch
    bounds."""
    census = summarize(fn, args, contract, device_kernel=device_kernel)
    violations: List[str] = []
    lo, hi = contract.min_launches, contract.max_launches
    for what, n, detail in (
            ("kernel-wrapper calls", census.kernel_calls, census.calls),
            ("kernel launches (LAUNCH_COUNTS)", census.kernel_launches,
             census.launches)):
        if (what == "kernel-wrapper calls" or census.device == "cuda") \
                and not lo <= n <= hi:
            violations.append(f"{what}: got {n} {detail}, contract "
                              f"requires {_bounds(contract)}")
    if census.device_kernels is not None and \
            not lo <= census.device_kernels <= hi:
        violations.append(
            f"device kernels {device_kernel!r} in the profile: got "
            f"{census.device_kernels}, contract requires "
            f"{_bounds(contract)}")

    allowed = set(contract.allowed_collectives)
    for op, count in sorted(census.collectives.items()):
        if op not in allowed:
            violations.append(
                f"forbidden collective {op!r} recorded {count}x "
                f"(allowed: {sorted(allowed) or 'none'})")

    if contract.forbid_host_transfers:
        for what, count in sorted(census.host_transfers.items()):
            violations.append(f"host transfer {what} {count}x on a "
                              f"serving path")

    for dtype in sorted(census.float_dtypes):
        bits = torch.finfo(getattr(torch, dtype)).bits
        if bits > contract.max_float_bits:
            violations.append(
                f"float dtype {dtype} ({bits} bits) exceeds the "
                f"{contract.max_float_bits}-bit ceiling (silent upcast)")

    for what, nbytes in census.large_allocs:
        violations.append(
            f"argnums {list(contract.in_place_argnums)} must be written in "
            f"place: {what} allocated or moved {nbytes} B (an out-of-place "
            f"update copies the whole tensor)")
    return AuditReport(contract, violations, census)


def repo_contracts() -> Dict[str, KernelContract]:
    """Every contract attached to a hot module, by qualified name."""
    from repro_torch.cache import cached_bag, tiers
    from repro_torch.core import embedding_bag
    from repro_torch.kernels import ops
    from repro_torch.serving import engine

    out: Dict[str, KernelContract] = {}
    for mod in (ops, cached_bag, embedding_bag, engine, tiers):
        for contract in getattr(mod, "KERNEL_CONTRACTS", {}).values():
            out[contract.name] = contract
    return out
