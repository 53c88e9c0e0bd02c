"""AdamW on parameter trees: the counterpart of ``repro.optim.adamw``, with
its arithmetic (global-norm clipping, bias correction in f32, decoupled
weight decay on every leaf with ``ndim >= 2``, the layer-stacked norm
weights ``(n, d)`` included, as in the reference), in place.

``tc.optimizer_state_dtype`` selects the moments: float32, bfloat16, or
int8 (``optim/quant.py``: "sym" for m, "log" for v).  The update writes
the parameters and moments in place under ``torch.no_grad`` (the
reference donates them), and walks each leaf in slices of whole rows of
its last axis, at most :data:`CHUNK_ELEMS` elements each: the blocks of
the int8 moments run along that axis, so a slice quantizes to the
codes of the whole, and the f32 temporaries stay a slice's size (one of
granite-8b's (36, 4096, 14336) FFN stacks in f32 is 8.46 GB).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import comm
from repro_torch.optim.quant import (
    QuantizedTensor,
    dequantize_blockwise,
    quantize_blockwise,
    zeros_quantized,
)
from repro_torch.utils.tree import flatten_with_paths, leaves, map_leaves

# the f32 elements of one slice of the update and of the global norm
CHUNK_ELEMS = 1 << 25
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_dtype(dt: str) -> None:
    if dt not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"optimizer_state_dtype must be float32, bfloat16 "
                         f"or int8, got {dt!r}")


def adamw_init(params, tc: TrainConfig) -> Dict[str, Any]:
    """``{"m", "v"}`` trees of zero moments like ``params`` and ``"step"``
    0 (int32), on the parameters' device."""
    dt = tc.optimizer_state_dtype
    _check_dtype(dt)

    def zeros(mode):
        def make(p):
            if dt == "int8":
                return zeros_quantized(p.shape, mode, device=p.device)
            return torch.zeros(p.shape, dtype=_DTYPES[dt], device=p.device)
        return make

    first = leaves(params)[0]
    return {"m": map_leaves(zeros("sym"), params),
            "v": map_leaves(zeros("log"), params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def cosine_schedule(step, tc: TrainConfig) -> torch.Tensor:
    """Linear warmup to ``tc.learning_rate``, then a cosine to 0 at
    ``tc.total_steps``; f32, as the reference's."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / max(1, tc.warmup_steps), max=1.0)
    t = torch.clamp((step - tc.warmup_steps) /
                    max(1, tc.total_steps - tc.warmup_steps), 0.0, 1.0)
    return tc.learning_rate * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def _row_slices(shape) -> Iterator[Tuple[int, int]]:
    """(first, last) row ranges over the rows of the last axis, at most
    :data:`CHUNK_ELEMS` elements each (at least one row)."""
    last = shape[-1] if len(shape) else 1
    rows = math.prod(shape) // last if last else 0
    step = max(1, CHUNK_ELEMS // max(1, last))
    for a in range(0, rows, step):
        yield a, min(rows, a + step)


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1] if t.dim() else 1)


def _square_sums(x: torch.Tensor) -> Iterator[torch.Tensor]:
    r = _rows(x)
    for a, b in _row_slices(x.shape):
        yield r[a:b].float().square().sum()


def _axis_sum(x: torch.Tensor, axes, ctx) -> torch.Tensor:
    """``x`` summed over each of ``axes`` ("model", "data") of ``ctx``."""
    for axis in axes:
        x = comm.all_reduce(x, ctx=ctx) if axis == "model" else \
            comm.data_all_reduce(x, ctx=ctx)
    return x


def global_norm(tree, *, ctx=None, sharded=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, by slices: the
    reference's ``sum(square(x.astype(f32)))``.  (The CPU's f32
    ``vector_norm`` of a 2**25-element slice drifts far from the exact
    value, so the card's clip differed from the CPU's; ``sum`` is
    pairwise on the CPU and a tree on the card.)

    With ``ctx`` (a ``ProcessContext``), the whole model's norm over the
    mesh: ``sharded`` maps the path of each leaf that is this rank's
    piece of a leaf cut over the mesh to the axes it is cut over
    (``("model",)``, ``("data",)`` or both); each one's sum of squares
    (its slices in order) is all-reduced over those axes, the leaves cut
    over the same axes in one collective an axis, and enters the total in
    its leaf's place, while a leaf whole on every rank enters as above,
    once.  Only the cut leaves' sums differ from one device's, in their
    order of addition.  A leaf counts once: a gradient the data axis does
    not cut is the same in every data group (summed over it by the train
    step), and is summed over no axis it is whole along."""
    total = None
    pairs = flatten_with_paths(tree)
    sharded = sharded or {}
    whole = {}
    if ctx is not None and sharded:
        groups: Dict[tuple, list] = {}
        for p, x in pairs:
            if sharded.get(p):
                groups.setdefault(tuple(sharded[p]), []).append(
                    (p, sum(_square_sums(x))))
        for axes, mine in groups.items():
            summed = _axis_sum(torch.stack([v for _, v in mine]), axes, ctx)
            whole.update(zip([p for p, _ in mine], summed.unbind(0)))
    for path, x in pairs:
        for sq in ([whole[path]] if path in whole else _square_sums(x)):
            total = sq if total is None else total + sq
    return torch.sqrt(total)


class _Moment:
    """Slices of one moment leaf: read as f32, write back encoded."""

    def __init__(self, enc, mode: str):
        self.enc, self.mode = enc, mode
        if isinstance(enc, QuantizedTensor):
            nb = enc.q.shape[-2]
            self.q = enc.q.reshape(-1, nb, enc.q.shape[-1])
            self.scale = enc.scale.reshape(-1, nb)
            self.last = enc.shape[-1] if enc.shape else 1
        else:
            self.rows = _rows(enc)

    def read(self, a: int, b: int) -> torch.Tensor:
        if isinstance(self.enc, QuantizedTensor):
            return dequantize_blockwise(QuantizedTensor(
                self.q[a:b], self.scale[a:b], (b - a, self.last), self.mode))
        return self.rows[a:b].float()

    def write(self, a: int, b: int, x: torch.Tensor) -> None:
        if isinstance(self.enc, QuantizedTensor):
            t = quantize_blockwise(x, self.mode)
            self.q[a:b].copy_(t.q)
            self.scale[a:b].copy_(t.scale)
        else:
            self.rows[a:b].copy_(x)


@torch.no_grad()
def adamw_update(grads, state, params, tc: TrainConfig, *, ctx=None,
                 sharded=None, columns=None):
    """One step: clip by the global norm, AdamW with bias correction,
    decay on ``ndim >= 2`` leaves.  Writes ``params`` and ``state`` (``m``,
    ``v``, ``step``) in place; returns ``(params, state, {"grad_norm",
    "lr"})``, the metrics 0-dim f32 tensors.  With ``ctx`` (a
    ``ProcessContext``) the parameters are this rank's pieces,
    ``sharded`` the axes each gradient leaf is cut over by path: the clip
    takes the whole model's norm (:func:`global_norm`), and each rank
    updates its own pieces.  ``columns`` maps the path of a parameter
    whose gradient and moments are whole along a last dim the parameter
    is cut on (an int8 moment's blocks run along it) to (first, count):
    the rank updates the moments' whole rows and writes the parameter's
    columns of them."""
    _check_dtype(tc.optimizer_state_dtype)
    step = state["step"]
    gnorm = global_norm(grads, ctx=ctx, sharded=sharded)
    clip = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = cosine_schedule(step, tc)
    b1, b2 = tc.beta1, tc.beta2
    stepf = step.float() + 1.0
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    columns = columns or {}
    paths = [path for path, _ in flatten_with_paths(params)]
    for path, p, g, m_enc, v_enc in zip(paths, leaves(params), leaves(grads),
                                        leaves(state["m"]),
                                        leaves(state["v"])):
        pr, gr = _rows(p), _rows(g)
        ms, vs = _Moment(m_enc, "sym"), _Moment(v_enc, "log")
        cols = columns.get(path)
        for a, b in _row_slices(g.shape):
            gs = gr[a:b].float() * clip
            m = b1 * ms.read(a, b) + (1 - b1) * gs
            v = b2 * vs.read(a, b) + (1 - b2) * gs * gs
            mh = m / bc1
            vh = v / bc2
            delta = mh / (torch.sqrt(vh) + tc.eps)
            if cols is not None:
                delta = delta.narrow(1, cols[0], cols[1])
            if p.dim() >= 2:
                delta = delta + tc.weight_decay * pr[a:b].float()
            pr[a:b].copy_((pr[a:b].float() - lr * delta).to(p.dtype))
            ms.write(a, b, m)
            vs.write(a, b, v)
    step.add_(1)
    return params, state, {"grad_norm": gnorm, "lr": lr}
