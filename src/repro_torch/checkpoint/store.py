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
  * ``asynchronous=True`` writes on a thread; ``wait_all`` joins them.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

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


def _to_host(t: torch.Tensor):
    """(numpy copy, manifest dtype name) of ``t``."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save(tree: Any, base: str, step: int, *, asynchronous: bool = False,
         keep: int = 3) -> str:
    """Write ``tree`` for ``step``.  Returns the final directory path."""
    pairs = flatten_with_paths(tree)
    paths = [p for p, _ in pairs]
    host = [_to_host(t) for _, t in pairs]        # before the writer starts

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


def restore(template: Any, base: str, step: Optional[int] = None) -> Any:
    """Fill ``template`` (a state tree of tensors) in place from the
    checkpoint of ``step`` (default: the newest) and return it.  Paths
    and shapes must match the template's; each leaf is cast to the
    template's dtype on its device.  One device: the reference's
    ``shardings`` (an elastic reshard onto a mesh) has no counterpart
    before ROADMAP Queue 1 item 13.6."""
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
            if tuple(a.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch at {path}: {a.shape} vs "
                                 f"{tuple(tmpl.shape)}")
            a = np.array(a, copy=True, order="C")
            if manifest["dtypes"][i] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            with torch.no_grad():
                tmpl.copy_(t.to(tmpl.dtype))
    return template
