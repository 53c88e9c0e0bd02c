"""Atomic checkpoints of a state tree: the counterpart of
``repro.checkpoint.store``, in its layout, so a checkpoint written by
either package restores in the other.

Layout (one directory per step):

    <dir>/step_00000123/
        manifest.json        # step, paths, shapes, dtypes
        shard_p0.npz         # leaf_0, leaf_1, ... in the manifest's order
    <dir>/step_00000123.tmp.*/   # staging; renamed on completion

  * leaves in the reference's order and path strings
    (``utils/tree.flatten_with_paths``: dict keys sorted, a
    ``QuantizedTensor`` as ``.../0`` (q) and ``.../1`` (scale));
  * numpy has no bfloat16: a bf16 leaf is stored as its 16-bit pattern,
    void ``V2`` as the reference's ``np.savez`` writes it, the manifest
    saying ``bfloat16``; ``restore`` reads it back through the manifest;
  * ``save`` copies every leaf to the host before its writer starts
    (the train step updates the state in place), writes to a ``.tmp``
    directory and renames it, so a crash mid-save leaves the last
    checkpoint intact; ``keep`` drops the oldest after a write;
  * ``asynchronous=True`` writes on a thread; ``wait_all`` joins them;
  * with ``ctx`` (a ``ProcessContext``) every rank calls ``save`` with
    its own pieces of the state, and ``specs`` gives each leaf's spec by
    path (``launch/specs.py``: None, ``"model"`` or ``("data",)`` per
    dim): global rank 0 receives each cut leaf's pieces, one from the
    first rank that holds each (over the world's group), one at a time
    into one host buffer of the whole leaf (no rank holds more than its
    piece on its device), copies the others to the host, and alone
    writes -- the checkpoint one device writes.  ``restore`` with the
    context reads the whole state leaf by leaf on every rank and keeps
    this rank's piece of each.  The format is the whole state, so a
    checkpoint written under one placement restores under another, on
    simulated ranks or on one device, as the reference's ``restore(
    shardings=)`` reshards.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.parallel import cut_index, spec_axis, whole_shape
from repro_torch.utils.tree import flatten_with_paths

_PENDING: List[threading.Thread] = []
# one process writes every leaf: the reference's file of process 0
SHARD = "shard_p0.npz"


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def latest_step(base: str) -> Optional[int]:
    if not os.path.isdir(base):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(base)
             if n.startswith("step_") and ".tmp" not in n]
    return max(steps) if steps else None


def _numpy(t: torch.Tensor):
    """(numpy view, manifest dtype name) of the host tensor ``t``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _to_host(t: torch.Tensor):
    """(numpy copy, manifest dtype name) of ``t``."""
    return _numpy(t.detach().to("cpu", copy=True))


def _owners(spec, ctx):
    """[(global rank, index)] of the first rank holding each piece of a
    leaf under ``spec``: data group 0 along a data axis the spec does
    not cut, model rank 0 along a model axis it does not cut."""
    axes = {spec_axis(e) for e in spec}
    dps = range(ctx.dp_size) if "data" in axes else (0,)
    tps = range(ctx.world) if "model" in axes else (0,)
    return [(d * ctx.world + m, d, m) for d in dps for m in tps]


def _gathered_on_host(t: torch.Tensor, spec, ctx) -> Optional[torch.Tensor]:
    """Global rank 0: on the host, the whole leaf of which each rank's
    ``t`` is its piece under ``spec``, received from the first rank
    holding each piece, all of a leaf's pieces at once; every other rank
    sends its piece when it is that rank and gets None.  Over gloo the
    pieces go through the host, over NCCL through the card."""
    t = t.detach().contiguous()
    via = t.device if dist.get_backend() == "nccl" else torch.device("cpu")
    me = ctx.global_rank
    owners = _owners(spec, ctx)
    if me != 0:
        if any(g == me for g, _, _ in owners):
            dist.send(t.to(via), dst=0)
        return None
    shape = whole_shape(spec, tuple(t.shape), ctx)
    whole = torch.empty(shape, dtype=t.dtype)
    recv = []
    for g, d, m in owners:
        idx = cut_index(spec, shape, ctx, dp_rank=d, rank=m)
        if g == 0:
            whole[idx].copy_(t)
        else:
            buf = torch.empty(tuple(t.shape), dtype=t.dtype, device=via)
            recv.append((dist.irecv(buf, src=g), buf, idx))
    for work, buf, idx in recv:
        work.wait()
        whole[idx].copy_(buf)
    return whole


def _is_cut(spec) -> bool:
    return any(e is not None for e in spec)


def save(tree: Any, base: str, step: int, *, asynchronous: bool = False,
         keep: int = 3, ctx=None, specs: Optional[dict] = None) -> str:
    """Write ``tree`` for ``step``.  Returns the final directory path.

    With ``ctx`` (a ``ProcessContext``; collective over the world)
    ``tree`` is this rank's pieces, and ``specs`` each leaf's spec by
    path (a leaf without one is whole on every rank): global rank 0
    writes the whole state, every other rank writes nothing."""
    specs = specs or {}
    pairs = flatten_with_paths(tree)
    paths = [p for p, _ in pairs]
    host = []                                     # before the writer starts
    lead = ctx is None or ctx.global_rank == 0
    for path, t in pairs:
        spec = specs.get(path)
        if ctx is not None and spec is not None and _is_cut(spec):
            whole = _gathered_on_host(t, spec, ctx)
            if whole is not None:
                host.append(_numpy(whole))
        elif lead:
            host.append(_to_host(t))
    if not lead:
        return _step_dir(base, step)

    final = _step_dir(base, step)
    tmp = final + f".tmp.{os.getpid()}.{threading.get_ident()}.{id(tree)}"

    def _write():
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, SHARD),
                 **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
        manifest = {
            "step": step,
            "paths": paths,
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [dt for _, dt in host],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(base)
                       if n.startswith("step_") and ".tmp" not in n)
        for s in steps[:-keep]:
            shutil.rmtree(_step_dir(base, s), ignore_errors=True)

    if asynchronous:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        _PENDING.append(t)
    else:
        _write()
    return final


def wait_all() -> None:
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def restore(template: Any, base: str, step: Optional[int] = None, *,
            ctx=None, specs: Optional[dict] = None) -> Any:
    """Fill ``template`` (a state tree of tensors) in place from the
    checkpoint of ``step`` (default: the newest) and return it.  Paths
    and shapes must match the template's; each leaf is cast to the
    template's dtype on its device.  One device and simulated ranks take
    the whole state.  With ``ctx`` (a ``ProcessContext``) ``template`` is
    this rank's pieces, as in :func:`save`: each leaf with a spec in
    ``specs`` is read whole on the host and this rank's piece copied in
    -- the reference's ``restore(shardings=)``, whatever placement wrote
    the checkpoint."""
    specs = specs or {}
    step = step if step is not None else latest_step(base)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {base}")
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    pairs = flatten_with_paths(template)
    paths = [p for p, _ in pairs]
    if paths != manifest["paths"]:
        diff = set(manifest["paths"]) ^ set(paths)
        raise ValueError(f"checkpoint/template tree mismatch: {diff}")
    with np.load(os.path.join(d, SHARD)) as data:
        for i, (path, tmpl) in enumerate(pairs):
            a = data[f"leaf_{i}"]
            spec = specs.get(path)
            cut = ctx is not None and spec is not None and _is_cut(spec)
            want = whole_shape(spec, tuple(tmpl.shape), ctx) if cut else \
                tuple(tmpl.shape)
            if tuple(a.shape) != want:
                raise ValueError(f"shape mismatch at {path}: {a.shape} vs "
                                 f"{want}")
            if cut:
                a = a[cut_index(spec, want, ctx, what=path)]
            a = np.array(a, copy=True, order="C")
            if manifest["dtypes"][i] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            with torch.no_grad():
                tmpl.copy_(t.to(tmpl.dtype))
    return template
