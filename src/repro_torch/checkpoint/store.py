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
    its own share of the state, and ``sharded`` names the leaves cut
    over the ranks along ``utils/convert.SHARD_AXIS``: model rank 0 of
    data group 0 (global rank 0) receives each such leaf's shares from
    its data group's ranks one at a time into one host buffer of the
    whole leaf (no rank holds more than its share on its device), copies
    the others to the host, and alone writes -- the checkpoint one
    device writes; the other data groups hold the same state and send
    nothing.  ``restore`` with the context reads the whole state leaf by
    leaf on every rank and keeps this rank's part of each cut leaf.
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

from repro_torch.utils.convert import SHARD_AXIS
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


def _global(ctx, rank: int) -> int:
    """The global rank of model rank ``rank`` of this rank's data
    group."""
    return rank if ctx.group is None else dist.get_global_rank(ctx.group,
                                                                rank)


def _gathered_on_host(t: torch.Tensor, ctx) -> Optional[torch.Tensor]:
    """Rank 0: on the host, the whole leaf of which each rank's ``t`` is
    its share along ``SHARD_AXIS``, received one share at a time; every
    other rank sends its share and gets None.  Over gloo the shares go
    through the host, over NCCL through one share's buffer on the card."""
    t = t.detach().contiguous()
    via = t.device if dist.get_backend(ctx.group) == "nccl" \
        else torch.device("cpu")
    if ctx.rank != 0:
        dist.send(t.to(via), dst=_global(ctx, 0), group=ctx.group)
        return None
    n = t.shape[SHARD_AXIS]
    shape = list(t.shape)
    shape[SHARD_AXIS] *= ctx.world
    whole = torch.empty(shape, dtype=t.dtype)
    whole.narrow(SHARD_AXIS, 0, n).copy_(t)
    buf = torch.empty(tuple(t.shape), dtype=t.dtype, device=via)
    for r in range(1, ctx.world):
        dist.recv(buf, src=_global(ctx, r), group=ctx.group)
        whole.narrow(SHARD_AXIS, r * n, n).copy_(buf)
    return whole


def save(tree: Any, base: str, step: int, *, asynchronous: bool = False,
         keep: int = 3, ctx=None, sharded: frozenset = frozenset()) -> str:
    """Write ``tree`` for ``step``.  Returns the final directory path.

    With ``ctx`` (a ``ProcessContext``; collective) ``tree`` is this
    rank's share, and ``sharded`` the paths of its leaves cut over the
    ranks along ``SHARD_AXIS`` (the rest replicated): global rank 0
    writes the whole state from data group 0's shares, every other rank
    writes nothing."""
    if ctx is not None and ctx.dp_rank != 0:
        return _step_dir(base, step)
    pairs = flatten_with_paths(tree)
    paths = [p for p, _ in pairs]
    host = []                                     # before the writer starts
    for path, t in pairs:
        if ctx is not None and path in sharded:
            whole = _gathered_on_host(t, ctx)
            if whole is not None:
                host.append(_numpy(whole))
        elif ctx is None or ctx.rank == 0:
            host.append(_to_host(t))
    if ctx is not None and ctx.rank != 0:
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
            ctx=None, sharded: frozenset = frozenset()) -> Any:
    """Fill ``template`` (a state tree of tensors) in place from the
    checkpoint of ``step`` (default: the newest) and return it.  Paths
    and shapes must match the template's; each leaf is cast to the
    template's dtype on its device.  One device: the reference's
    ``shardings`` (an elastic reshard onto a mesh) has no counterpart;
    simulated ranks share the card and its whole tensors.  With ``ctx``
    (a ``ProcessContext``) ``template`` is this rank's share, as in
    :func:`save`: each leaf of ``sharded`` is read whole on the host and
    this rank's part along ``SHARD_AXIS`` copied in."""
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
            want = list(tmpl.shape)
            cut = ctx is not None and path in sharded
            if cut:
                want[SHARD_AXIS] *= ctx.world
            if list(a.shape) != want:
                raise ValueError(f"shape mismatch at {path}: {a.shape} vs "
                                 f"{tuple(want)}")
            if cut:
                n = tmpl.shape[SHARD_AXIS]
                a = a[(slice(None),) * SHARD_AXIS
                      + (slice(ctx.rank * n, (ctx.rank + 1) * n),)]
            a = np.array(a, copy=True, order="C")
            if manifest["dtypes"][i] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            with torch.no_grad():
                tmpl.copy_(t.to(tmpl.dtype))
    return template
