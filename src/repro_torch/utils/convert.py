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
a whole train state (its moments too); ``rank_sharded`` names the leaves
they cut.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.embedding_bag import shard_for_rank
from repro_torch.core.jagged import JaggedBatch
from repro_torch.models.lm import embedding_bag_config
from repro_torch.optim.quant import QuantizedTensor
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_with_paths

# the MoE leaves sharded over the model axis along their expert axis, as
# the reference's ``_moe_apply`` slices them; the router and the shared
# experts stay whole
EXPERT_LEAVES = ("gate", "up", "down")
# every leaf a rank holds a share of is cut along this axis: the padded
# vocabulary's rows of the (1, Vp, d) table, the experts of an
# (n_layers, E_x, ...) stack
SHARD_AXIS = 1


def _param_path(path: str) -> list:
    """A parameter's path parts from a path of a parameter tree or of a
    train state (``params/...``, ``opt/m/...``, ``opt/v/...``; an int8
    moment's ``.../0`` codes and ``.../1`` scales)."""
    parts = path.split("/")
    if parts[0] == "params":
        return parts[1:]
    if parts[0] == "opt" and len(parts) > 1 and parts[1] in ("m", "v"):
        parts = parts[2:]
        return parts[:-1] if parts and parts[-1] in ("0", "1") else parts
    return parts


def rank_sharded(path: str, cfg) -> bool:
    """Whether the leaf at ``path`` (of LM parameters or a train state,
    as ``utils/tree.flatten_with_paths`` names it) is cut over the ranks
    by :func:`lm_params_for_rank` / :func:`lm_train_state_for_rank`,
    along :data:`SHARD_AXIS`: the vocabulary table (when row-sharded) and
    the expert stacks, with their moments."""
    parts = _param_path(path)
    if parts == ["embed"]:
        return cfg.vocab_sharding != "replicated"
    return (cfg.is_moe and len(parts) >= 2 and parts[-2] == "moe"
            and parts[-1] in EXPERT_LEAVES)


def rank_sharded_paths(tree, cfg) -> frozenset:
    """The paths of ``tree``'s leaves (LM parameters, their gradients or a
    train state) that are cut over the ranks (:func:`rank_sharded`)."""
    return frozenset(p for p, _ in flatten_with_paths(tree)
                     if rank_sharded(p, cfg))


def token_slice_leaf(path: str) -> bool:
    """Whether the parameter at ``path`` is replicated over the ranks but
    used by each rank on its own tokens only -- an MoE layer's router and
    shared experts (``models/moe.moe_ffn_ep_rank``) -- so that its
    gradient is the sum of the ranks'."""
    parts = _param_path(path)
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


def lm_params_for_rank(params: Dict[str, Any], cfg, ctx) -> Dict[str, Any]:
    """This rank's LM parameters under ``ctx`` (a ``ProcessContext``),
    from the whole ones (``lm.init_params(..., tp_size=ctx.world)`` or
    :func:`lm_params_from_numpy`), on ``ctx.device``:

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

    The result holds no reference to the whole expert stacks or the whole
    table (a tied head aside): a tensor received through CUDA IPC keeps
    its sender's memory until every receiver drops it.  Raises
    ``ValueError`` when the ranks do not divide the experts or the
    table's rows."""
    E, r = ctx.world, ctx.rank
    dev = ctx.device
    if cfg.is_moe and cfg.num_experts % E:
        raise ValueError(f"{cfg.num_experts} experts do not divide over {E} "
                         f"ranks")
    el = cfg.num_experts // E if cfg.is_moe else 0

    def own(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(tuple(t.shape), dtype=t.dtype, device=dev)
        out.copy_(t)
        return out

    def conv(tree, moe=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = conv(v, moe=k == "moe")
            elif moe and k in EXPERT_LEAVES:        # (layers, E_x, ...)
                out[k] = own(v[:, r * el:(r + 1) * el])
            else:
                out[k] = v.to(dev)
        return out

    out = conv({k: v for k, v in params.items() if k != "embed"})
    embed = params["embed"]
    if cfg.tie_embeddings:
        out["head"] = embed[0].T.to(dev)
    if cfg.vocab_sharding == "replicated":
        out["embed"] = embed.to(dev)
    else:
        out["embed"] = shard_for_rank(embed, embedding_bag_config(cfg, E),
                                      ctx)
    return out


def lm_train_state_for_rank(state: Dict[str, Any], cfg,
                            ctx) -> Dict[str, Any]:
    """This rank's LM train state under ``ctx`` (a ``ProcessContext``)
    from the whole one (``train/step.init_train_state`` at ``tp_size =
    ctx.world``, or :func:`train_state_from_numpy`): ``"params"`` as
    :func:`lm_params_for_rank` cuts them, and every moment of a cut leaf
    (:func:`rank_sharded`) cut the same way along :data:`SHARD_AXIS`,
    its own copy; the other moments and ``"step"`` moved to
    ``ctx.device`` (the same tensors when already there).  An int8
    moment's codes and scales are cut alike: its blocks run along the
    last axis only (``optim/quant.py``), so a rank's rows of the codes
    and scales are the whole moment's rows, and the cut is exact."""
    E, r, dev = ctx.world, ctx.rank, ctx.device

    def cut(t: torch.Tensor) -> torch.Tensor:
        n = t.shape[SHARD_AXIS] // E
        part = t.narrow(SHARD_AXIS, r * n, n)
        out = torch.empty(tuple(part.shape), dtype=t.dtype, device=dev)
        out.copy_(part)
        return out

    def conv(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}"
            if isinstance(v, dict):
                out[k] = conv(v, path)
            elif isinstance(v, QuantizedTensor):
                sharded = rank_sharded(path, cfg)
                shape = list(v.shape)
                if sharded:
                    shape[SHARD_AXIS] //= E
                move = cut if sharded else (lambda t: t.to(dev))
                out[k] = dataclasses.replace(v, q=move(v.q),
                                             scale=move(v.scale),
                                             shape=tuple(shape))
            else:
                out[k] = cut(v) if rank_sharded(path, cfg) else v.to(dev)
        return out

    opt = state["opt"]
    return {"params": lm_params_for_rank(state["params"], cfg, ctx),
            "opt": {"m": conv(opt["m"], "opt/m"),
                    "v": conv(opt["v"], "opt/v"),
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
