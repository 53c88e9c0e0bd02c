"""Where each leaf of the LM train state lies on a ``(data, model)`` mesh:
the counterpart of the state rules of ``repro.launch.specs``
(``param_spec_tree``, ``opt_spec_tree``, ``state_spec_tree``), rule for
rule, and what a rank of a mesh of processes makes of them
(:class:`Placement`).

A spec is a plain tuple per leaf, one entry per dim, the reference's
``PartitionSpec`` entries: None (whole), ``"model"`` (cut over the model
axis) or ``("data",)`` (cut over the data axis).  The policy, the
reference's:

  * the embedding table (1, Vp, d): its rows over the model axis;
  * the head (d, Vp): ``(dp, tp)``, each where its axis divides the dim;
  * column-parallel weights (``wq``/``wk``/``wv``/``gate``/``up``/...):
    the last dim over the model axis, dim -2 over the data axis (FSDP)
    when it is at least 1024;
  * row-parallel weights (``wo``/``down``/``out_proj``/...): dim -2 over
    the model axis, the last over the data axis when it is at least 1024;
  * MoE experts (n, E, d, f): ``(None, tp, dp, None)``;
  * norms, scalars and the ``_REPLICATED`` names whole;
  * on a small model (``d_model <= 2048``) whose heads the model axis does
    not divide, the attention projections lose their model cut;
  * ``ShardingConfig.fsdp`` False drops every data cut;
  * the moments follow their parameter, but an int8 moment is whole along
    the last dim: ``optim/quant.py``'s blocks run along it.

Where the reference names a data axis of one device (the mesh ``(1,
n)``) the port writes None: an axis of one rank cuts nothing.

The reference's ``cache_spec_tree``, ``input_specs``, ``batch_structs``
and ``batch_specs`` feed its dry run, which the port does not have
(ROADMAP Queue 1 item 13.8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.parallel import axis_ranks, spec_axis
from repro_torch.optim.quant import QuantizedTensor

_ROW_PARALLEL = {"wo", "down", "out_proj", "cv", "w_o", "w_uq", "dt_proj",
                 "w_B", "fc2"}
_REPLICATED = {"router", "mu", "mu_c", "w0", "u", "ln_w", "ln_b", "conv_w",
               "conv_b", "A_log", "D", "dt_bias", "q_norm", "kv_norm",
               "enc_pos", "w_A", "scale"}
# an MoE layer's expert stacks (n, E, ...), run expert-parallel
EXPERT_LEAVES = ("gate", "up", "down")


def leaf_spec(names: Tuple[str, ...], shape, cfg: ModelConfig,
              ctx) -> tuple:
    """The spec of the parameter at ``names`` (its path's keys) of
    ``shape``: the reference's ``param_spec_tree`` rule."""
    fsdp = ctx.config.fsdp

    def dp_for(dim: int):
        return ctx.dp_for(dim) if fsdp else None

    # sub-head cuts of a small model's attention projections: the
    # reference replicates them (its note: GSPMD would add an all-reduce
    # per score matmul)
    small_d = cfg.d_model <= 2048
    q_heads_ok = cfg.num_heads % ctx.tp_size == 0 or not small_d
    kv_heads_ok = cfg.num_kv_heads % ctx.tp_size == 0 or not small_d
    name = names[-1]
    nd = len(shape)
    if name == "embed":
        return (None, ctx.tp_for(shape[1]), None)
    if name == "head":
        return (dp_for(shape[0]), ctx.tp_for(shape[1]))
    if name in _REPLICATED or nd <= 1 or ("projector" in names
                                          and name == "fc1"):
        return (None,) * nd
    if "moe" in names and name in EXPERT_LEAVES and nd == 4:
        return (None, ctx.tp_for(shape[1]), dp_for(shape[2]), None)
    if name in ("w", "b"):                       # norms inside stacks
        return (None,) * nd
    if name == "wq" and not q_heads_ok:
        return (None,) * (nd - 2) + (dp_for(shape[-2]), None)
    if name in ("wk", "wv") and not kv_heads_ok:
        return (None,) * (nd - 2) + (dp_for(shape[-2]), None)
    if name == "wo" and not q_heads_ok:
        return (None,) * (nd - 2) + (None, dp_for(shape[-1]))
    spec = [None] * nd
    if name in _ROW_PARALLEL:
        spec[-2] = ctx.tp_for(shape[-2])
        spec[-1] = dp_for(shape[-1]) if shape[-1] >= 1024 else None
    else:                                        # column-parallel default
        spec[-1] = ctx.tp_for(shape[-1])
        if shape[-2] >= 1024:
            spec[-2] = dp_for(shape[-2])
    return tuple(spec)


def _map_with_names(fn, tree, names=()):
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (k,))
                for k, v in tree.items()}
    return fn(names, tree)


def param_spec_tree(params, cfg: ModelConfig, ctx) -> Dict[str, Any]:
    """The spec of every leaf of ``params`` (a tree of whole leaves, or
    of anything with a ``shape``: ``lm.init_params(None, cfg,
    device="meta")`` makes one without memory), a tree of ``params``'
    shape.  ``ctx`` is a ``ParallelContext`` or ``ProcessContext``: its
    ``dp_for``/``tp_for`` decide divisibility, its ``config.fsdp`` the
    data cuts."""
    return _map_with_names(
        lambda names, leaf: leaf_spec(names, tuple(leaf.shape), cfg, ctx),
        params)


def _moment_spec(spec: tuple, leaf):
    if isinstance(leaf, QuantizedTensor):
        base = list(spec) + [None] * 10
        qdim = leaf.q.dim()
        return QuantizedTensor(q=tuple(base[: qdim - 2]) + (None, None),
                               scale=tuple(base[: qdim - 2]) + (None,),
                               shape=leaf.shape, mode=leaf.mode)
    return spec


def opt_spec_tree(param_specs, opt_template) -> Dict[str, Any]:
    """The moments' specs: their parameter's, an int8 moment's codes and
    scales whole along the blocks (the reference's trailing Nones); the
    step whole."""
    def build(specs, moments):
        if isinstance(specs, dict):
            return {k: build(specs[k], moments[k]) for k in specs}
        return _moment_spec(specs, moments)

    return {"m": build(param_specs, opt_template["m"]),
            "v": build(param_specs, opt_template["v"]),
            "step": ()}


def state_spec_tree(cfg: ModelConfig, tc: TrainConfig, ctx,
                    dtype=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(template, specs) for the whole train state: the template on the
    ``meta`` device (shapes and dtypes, no memory), as the reference's
    ``jax.eval_shape`` of ``init_train_state``, at the vocabulary padded
    to the model axis."""
    from repro_torch.train.step import init_train_state

    template = init_train_state(None, cfg, tc, tp_size=ctx.tp_size,
                                dtype=dtype, device="meta")
    pspecs = param_spec_tree(template["params"], cfg, ctx)
    return template, {"params": pspecs,
                      "opt": opt_spec_tree(pspecs, template["opt"])}


def flatten_specs(tree, prefix: str = "") -> Dict[str, tuple]:
    """``{path: spec}`` in ``utils/tree.flatten_with_paths``'s path
    strings: an int8 moment's codes at ``.../0``, its scales at
    ``.../1``."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten_specs(tree[k], join(k)))
        return out
    if isinstance(tree, QuantizedTensor):
        return {join(0): tree.q, join(1): tree.scale}
    return {prefix: tuple(tree)}


def param_names(path: str) -> Tuple[str, ...]:
    """A parameter's path keys from a path of a parameter tree or of a
    train state (``params/...``, ``opt/m/...``, ``opt/v/...``; an int8
    moment's ``.../0`` codes and ``.../1`` scales)."""
    parts = path.split("/")
    if parts[0] == "params":
        return tuple(parts[1:])
    if parts[0] == "opt" and len(parts) > 1 and parts[1] in ("m", "v"):
        parts = parts[2:]
        return tuple(parts[:-1] if parts and parts[-1] in ("0", "1")
                     else parts)
    return tuple(parts)


def rank_cut(path: str, spec: tuple, cfg: ModelConfig) -> tuple:
    """The entries of a state leaf's ``spec`` that the computation itself
    runs cut, None elsewhere: the model entry of the vocabulary's rows
    (the row-wise sharded bag, ``vocab_sharding="row"``) and of an expert
    stack's experts (expert parallelism), and of their moments.  A rank
    of the model axis holds these cuts whatever the placement; every
    other entry is a placement's, gathered before use."""
    if not rank_cut_leaf(path, cfg):
        return (None,) * len(spec)
    return tuple(e if spec_axis(e) == "model" else None for e in spec)


def rank_cut_leaf(path: str, cfg: ModelConfig) -> bool:
    """Whether the state leaf at ``path`` is one :func:`rank_cut` keeps
    a model cut of: the row-sharded vocabulary or an expert stack (or one
    of their moments)."""
    names = param_names(path)
    return (names == ("embed",) and cfg.vocab_sharding == "row") or (
        len(names) >= 2 and names[-2] == "moe"
        and names[-1] in EXPERT_LEAVES)


def rank_cut_tree(specs, cfg: ModelConfig, prefix: str = ""):
    """``specs`` (a state's, or a parameter tree's) keeping only the
    :func:`rank_cut` entries: what a rank holds with no placement (its
    rows of the vocabulary, its experts)."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(specs, dict):
        return {k: rank_cut_tree(v, cfg, join(k)) for k, v in specs.items()}
    if isinstance(specs, QuantizedTensor):
        return dataclasses.replace(
            specs, q=rank_cut(join(0), specs.q, cfg),
            scale=rank_cut(join(1), specs.scale, cfg))
    return rank_cut(prefix, specs, cfg)


def moment_specs(tree, prefix: str = "") -> Dict[str, Any]:
    """``{parameter path: its moments' spec}`` of a moment spec tree
    (:func:`opt_spec_tree`'s ``"m"``): a tuple, or an int8 moment's
    ``QuantizedTensor`` of the codes' and scales' specs."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(moment_specs(v, path) if isinstance(v, dict)
                   else {path: v})
    return out


def grad_spec(moment_spec) -> tuple:
    """The layout a parameter's gradient is kept in: its moments' (an
    int8 moment's scales' entries over the parameter's leading dims, the
    last dim whole)."""
    if isinstance(moment_spec, QuantizedTensor):
        return tuple(moment_spec.scale[:-1]) + (None,)
    return tuple(moment_spec)


@dataclasses.dataclass(frozen=True)
class LeafPlacement:
    """One parameter's placement on a rank: its ``spec``; ``gather``,
    the axis (``"model"``, ``"data"`` or None) each dim is all-gathered
    over before use (the spec less its :func:`rank_cut`); ``grad``, the
    axis each dim of the gradient's (and the moments') layout stays cut
    over among those (an int8 moment is whole along the last dim)."""
    spec: tuple
    gather: tuple
    grad: tuple

    @property
    def gathered(self) -> bool:
        return any(e is not None for e in self.gather)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A rank's train state under a state spec tree: the parameters'
    :class:`LeafPlacement` by path and every state leaf's spec by its
    ``flatten_with_paths`` path (``params/...``, ``opt/m/...``, ...), under
    ``ctx`` (a ``ProcessContext``)."""
    ctx: Any
    cfg: ModelConfig
    params: Dict[str, LeafPlacement]
    state: Dict[str, tuple]

    @classmethod
    def of(cls, specs: Dict[str, Any], cfg: ModelConfig,
           ctx) -> "Placement":
        """From a state spec tree (:func:`state_spec_tree`'s, or its
        :func:`rank_cut_tree`)."""
        pflat = flatten_specs(specs["params"])
        mspecs = moment_specs(specs["opt"]["m"])
        params = {}
        for path, spec in pflat.items():
            cut = rank_cut(f"params/{path}", spec, cfg)
            gather = tuple(None if c is not None else spec_axis(e)
                           for e, c in zip(spec, cut))
            gspec = grad_spec(mspecs.get(path, spec))
            params[path] = LeafPlacement(
                spec=spec, gather=gather,
                grad=tuple(spec_axis(e) if g is not None else None
                           for e, g in zip(gspec, gather)))
        state = {f"params/{p}": s for p, s in pflat.items()}
        state.update(flatten_specs(specs["opt"], "opt"))
        return cls(ctx=ctx, cfg=cfg, params=params, state=state)

    def grad_shape(self, path: str, piece_shape) -> Tuple[int, ...]:
        """The shape of a rank's gradient of the parameter at ``path``
        whose piece has ``piece_shape``: the piece's, but whole along a
        dim the gradient's layout keeps whole (:attr:`LeafPlacement.grad`)."""
        lp = self.params[path]
        return tuple(n * axis_ranks(self.ctx, g)[0]
                     if g is not None and k is None else n
                     for n, g, k in zip(piece_shape, lp.gather, lp.grad))

    def cuts(self, path: str) -> Tuple[str, ...]:
        """The axes a rank's gradient of the parameter at ``path`` is cut
        over (its rank cut and the kept placement entries), in mesh order:
        what the global norm sums its squares over."""
        lp = self.params[path]
        cut = rank_cut(f"params/{path}", lp.spec, self.cfg)
        axes = {spec_axis(e) for e in lp.grad + cut if e is not None}
        return tuple(a for a in ("model", "data") if a in axes)

    def columns(self, path: str, last: int) -> Optional[Tuple[int, int]]:
        """(first, count) of the parameter's piece, ``last`` wide, along
        the last dim of its gradient, when the gradient is whole along a
        last dim the piece is cut on (an int8 moment's); None
        otherwise."""
        lp = self.params[path]
        if lp.gather[-1] is None or lp.grad[-1] is not None:
            return None
        _, r = axis_ranks(self.ctx, lp.gather[-1])
        return r * last, last
