"""Carry weights and batches across from numpy into the port.

The reference's ``init_params`` pytree, turned into numpy arrays (for
example with ``jax.tree_util.tree_map(np.asarray, params)``), has the
layout the port uses -- ``{"tables", "bottom": [{"w", "b"}, ...],
"top": [...]}`` with ``(in, out)`` weights applied as ``x @ w + b`` -- so
the conversion copies each array, without a transpose.  The same holds
for the reference's LM ``init_params`` (``lm_params_from_numpy``): stacked
``(num_layers, ...)`` blocks, ``(in, out)`` weights; and for its train
state (``train_state_from_numpy``), int8 moments included.

``lm_params_for_rank`` cuts converted LM parameters down to one rank's
when each rank of the model axis is a process, ``lm_train_state_for_rank``
a whole train state (its moments too), each by a spec tree
(``launch/specs.py``: the reference's placement) or, without one, by the
cuts every rank holds whatever the placement, which ``rank_sharded``
names.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.embedding_bag import shard_for_rank
from repro_torch.core.jagged import JaggedBatch
from repro_torch.core.parallel import cut_index, cut_shape
from repro_torch.launch import specs as S
from repro_torch.models.lm import embedding_bag_config
from repro_torch.optim.quant import QuantizedTensor
from repro_torch.utils.device import resolve_device

def rank_sharded(path: str, cfg) -> bool:
    """Whether the leaf at ``path`` (of LM parameters or a train state,
    as ``utils/tree.flatten_with_paths`` names it) is cut over the model
    axis whatever the placement (``launch/specs.rank_cut``): the
    vocabulary table (when row-sharded) and the expert stacks, with
    their moments -- what :func:`lm_params_for_rank` and
    :func:`lm_train_state_for_rank` cut with no spec given."""
    return S.rank_cut_leaf(path, cfg)


def token_slice_leaf(path: str) -> bool:
    """Whether the parameter at ``path`` is replicated over the ranks but
    used by each rank on its own tokens only -- an MoE layer's router and
    shared experts (``models/moe.moe_ffn_ep_rank``) -- so that its
    gradient is the sum of the ranks'."""
    parts = S.param_names(path)
    return "moe" in parts and (parts[-1] == "router" or "shared" in parts)


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


def _is_cut(idx: tuple) -> bool:
    return any(s != slice(None) for s in idx)


def lm_params_for_rank(params: Dict[str, Any], cfg, ctx,
                       specs=None) -> Dict[str, Any]:
    """This rank's LM parameters under ``ctx`` (a ``ProcessContext``),
    from the whole ones (``lm.init_params(..., tp_size=ctx.world)`` or
    :func:`lm_params_from_numpy`), on ``ctx.device``: each leaf's piece
    under ``specs`` (a parameter spec tree, ``launch/specs.
    param_spec_tree`` under ``ctx``), its own copy; with ``specs`` None
    the cuts every rank holds whatever the placement
    (``launch/specs.rank_cut_tree``):

      * ``"embed"``: the rank's rows of the padded vocabulary, a
        ``RankShard`` of the row-wise sharded bag
        (``lm.embedding_bag_config``), its own copy; whole under
        ``vocab_sharding="replicated"``.  A tied head keeps the whole
        table as ``"head"`` (``(d, Vp)``);
      * every MoE stack's ``gate``/``up``/``down``: the rank's
        ``num_experts / world`` experts, ``[r el, (r + 1) el)`` along the
        expert axis, its own copy;
      * every other leaf as given (moved to ``ctx.device`` when it is
        elsewhere): attention and dense FFN weights, norms, the head, the
        routers and the shared experts, the encoder, the projector.

    The result holds no reference to a whole leaf it cuts (a tied head
    aside, which is the whole table): a tensor received through CUDA IPC
    keeps its sender's memory until every receiver drops it.  Raises
    ``ValueError`` when the ranks do not divide the experts or a cut
    dim."""
    E = ctx.world
    dev = ctx.device
    if cfg.is_moe and cfg.num_experts % E:
        raise ValueError(f"{cfg.num_experts} experts do not divide over {E} "
                         f"ranks")
    if specs is None:
        specs = S.rank_cut_tree(S.param_spec_tree(params, cfg, ctx), cfg)
    flat = S.flatten_specs(specs)

    def own(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(tuple(t.shape), dtype=t.dtype, device=dev)
        out.copy_(t)
        return out

    def conv(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = conv(v, path)
                continue
            idx = cut_index(flat[path], tuple(v.shape), ctx, what=path)
            out[k] = own(v[idx]) if _is_cut(idx) else v.to(dev)
        return out

    out = conv({k: v for k, v in params.items() if k != "embed"})
    embed = params["embed"]
    if cfg.tie_embeddings:
        out["head"] = embed[0].T.to(dev)
    idx = cut_index(flat["embed"], tuple(embed.shape), ctx, what="embed")
    if cfg.vocab_sharding == "replicated":
        out["embed"] = own(embed[idx]) if _is_cut(idx) else embed.to(dev)
    else:
        if idx[0] != slice(None) or idx[2] != slice(None):
            raise ValueError("embed: a row-sharded vocabulary is cut along "
                             "its rows only")
        out["embed"] = shard_for_rank(embed, embedding_bag_config(cfg, E),
                                      ctx)
    return out


def lm_train_state_for_rank(state: Dict[str, Any], cfg, ctx,
                            specs=None) -> Dict[str, Any]:
    """This rank's LM train state under ``ctx`` (a ``ProcessContext``)
    from the whole one (``train/step.init_train_state`` at ``tp_size =
    ctx.world``, or :func:`train_state_from_numpy`): each leaf's piece
    under ``specs`` (a state spec tree, ``launch/specs.state_spec_tree``
    under ``ctx``: the placement), its own copy; with ``specs`` None the
    cuts every rank holds whatever the placement (its rows of the
    vocabulary and its experts, and their moments).  ``"params"`` as
    :func:`lm_params_for_rank` cuts them; other leaves moved to
    ``ctx.device`` (the same tensors when already there).  An int8
    moment's codes and scales are cut by their own specs, whole along
    the blocks (``optim/quant.py``: blocks run along the last axis), so
    a rank's piece of the codes and scales is the whole moment's, and
    the cut is exact."""
    dev = ctx.device
    if specs is None:
        pspecs = S.param_spec_tree(state["params"], cfg, ctx)
        specs = S.rank_cut_tree({"params": pspecs, "opt": S.opt_spec_tree(
            pspecs, state["opt"])}, cfg)

    def cut(t: torch.Tensor, spec, path) -> torch.Tensor:
        idx = cut_index(spec, tuple(t.shape), ctx, what=path)
        if not _is_cut(idx):
            return t.to(dev)
        part = t[idx]
        out = torch.empty(tuple(part.shape), dtype=t.dtype, device=dev)
        out.copy_(part)
        return out

    def conv(tree, sp, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}"
            if isinstance(v, dict):
                out[k] = conv(v, sp[k], path)
            elif isinstance(v, QuantizedTensor):
                s = sp[k]
                shape = cut_shape(tuple(s.scale[:-1]) + (None,), v.shape,
                                  ctx, what=path)
                out[k] = dataclasses.replace(
                    v, q=cut(v.q, s.q, path + "/0"),
                    scale=cut(v.scale, s.scale, path + "/1"), shape=shape)
            else:
                out[k] = cut(v, sp[k], path)
        return out

    opt, ospecs = state["opt"], specs["opt"]
    return {"params": lm_params_for_rank(state["params"], cfg, ctx,
                                         specs["params"]),
            "opt": {"m": conv(opt["m"], ospecs["m"], "opt/m"),
                    "v": conv(opt["v"], ospecs["v"], "opt/v"),
                    "step": opt["step"].to(dev)}}


def train_state_from_numpy(state: Dict[str, Any], *,
                           device=None) -> Dict[str, Any]:
    """The reference's LM train state ``{"params", "opt": {"m", "v",
    "step"}}`` as numpy (for example ``jax.tree_util.tree_map(np.asarray,
    state)``, which keeps each ``QuantizedTensor`` with numpy ``q`` and
    ``scale``) -> the port's state on ``device`` (None: the card): the
    same trees of tensors, an int8 moment as the port's
    ``QuantizedTensor``."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if hasattr(tree, "q") and hasattr(tree, "scale"):
            return QuantizedTensor(_tensor(tree.q, device),
                                   _tensor(tree.scale, device),
                                   tuple(tree.shape), tree.mode)
        return _tensor(tree, device)

    return conv(state)


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
