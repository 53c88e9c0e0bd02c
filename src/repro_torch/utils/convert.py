"""Carry weights and batches across from numpy into the port.

The reference's ``init_params`` pytree, turned into numpy arrays (for
example with ``jax.tree_util.tree_map(np.asarray, params)``), has the
layout the port uses -- ``{"tables", "bottom": [{"w", "b"}, ...],
"top": [...]}`` with ``(in, out)`` weights applied as ``x @ w + b`` -- so
the conversion copies each array, without a transpose.  The same holds
for the reference's LM ``init_params`` (``lm_params_from_numpy``): stacked
``(num_layers, ...)`` blocks, ``(in, out)`` weights.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.jagged import JaggedBatch
from repro_torch.utils.device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (the source may be read-only)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes: numpy has no bf16
        return torch.tensor(a.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_numpy(params: Dict[str, Any], *,
                      device=None) -> Dict[str, Any]:
    """DLRM parameters as numpy arrays -> the port's tensors on ``device``
    (None: the card)."""
    device = resolve_device(device)

    def mlp(layers):
        return [{"w": _tensor(layer["w"], device),
                 "b": _tensor(layer["b"], device)} for layer in layers]

    return {"tables": _tensor(params["tables"], device),
            "bottom": mlp(params["bottom"]),
            "top": mlp(params["top"])}


def lm_params_from_numpy(params: Dict[str, Any], *,
                         device=None) -> Dict[str, Any]:
    """LM parameters (the reference's ``lm.init_params`` tree as numpy
    arrays, nested dicts) -> the same tree of tensors on ``device`` (None:
    the card).  bfloat16 arrays (``ml_dtypes``) pass through float32,
    which holds every bfloat16 value exactly."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, device)

    return conv(params)


def batch_from_numpy(dense: np.ndarray, indices: np.ndarray,
                     lengths: np.ndarray,
                     weights: Optional[np.ndarray] = None, *,
                     device=None) -> Tuple[torch.Tensor, JaggedBatch]:
    """A numpy ``(dense (B, F), indices (T, B, L), lengths (T, B))`` batch
    -> ``(dense tensor, JaggedBatch)`` on ``device`` (None: the card)."""
    device = resolve_device(device)
    return _tensor(dense, device), JaggedBatch(
        indices=_tensor(indices, device), lengths=_tensor(lengths, device),
        weights=None if weights is None else _tensor(weights, device))
