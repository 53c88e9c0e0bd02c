"""Small helpers over nested-dict trees of tensors (no pytree library):
the reference's leaf order and path strings, and a map over leaves.

The reference flattens with ``jax.tree_util``: dict keys sorted, a
``QuantizedTensor`` two children keyed 0 (``q``) and 1 (``scale``), and
a path joined with ``/``.  Here a dataclass (the port's
``QuantizedTensor``) is one node whose children are its tensor fields
in field order, keyed 0, 1, ...  :func:`flatten_with_paths` gives the same
order and strings, so a checkpoint manifest reads the same from either
package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, tensor), ...]`` in the reference's leaf order."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten_with_paths(tree[k], join(k))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in flatten_with_paths(v, join(i))]
    if dataclasses.is_dataclass(tree):
        kids = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
        return [(join(i), t) for i, t in
                enumerate(t for t in kids if isinstance(t, torch.Tensor))]
    return [(prefix, tree)]


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (tensors and whole
    ``QuantizedTensor`` s) and the matching leaves of ``rest``, in a tree
    of ``tree``'s shape."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree: Any) -> List[Any]:
    """The leaves (tensors and whole ``QuantizedTensor`` s) in the
    reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]
