"""DLRM -- bottom MLP, pooled embedding lookup, dot interaction, top MLP.

The counterpart of ``repro.models.dlrm``.  With a ``ParallelContext`` the
pooling runs the distributed embedding bag over the context's simulated
model axis (``core/embedding_bag.pooled_lookup_sharded``); with a
``ProcessContext`` this process is one rank of the axis: it pools over its
own shard, the dense MLPs are replicated, the batch is replicated over the
model axis, and every rank returns the same (B,) logits (the reference's
``out_specs=P(dp, None, None)``).  With a data axis whose ``dp_size``
divides B, data group d pools and scores rows ``[d B/dp, (d + 1) B/dp)``
over its model axis and the logits come back whole over the data axis;
otherwise every group scores the whole batch.  Under grad each rank's
shard trains (:func:`bce_loss`, :func:`sum_over_data`).
Parameters are a plain dict of tensors in the reference's layout,
``{"tables": (T, R, D), "bottom": [{"w": (in, out), "b": (out,)}, ...],
"top": [...]}``, applied as ``x @ w + b``, so weights carry across from the
JAX ``init_params`` pytree without a transpose (``utils.convert``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.core import comm
from repro_torch.core import embedding_bag as eb
from repro_torch.core.jagged import JaggedBatch
from repro_torch.core.parallel import (ParallelContext, ProcessContext,
                                       data_split, same_model_axis)
from repro_torch.utils.device import resolve_device


def _mlp_init(generator: torch.Generator, dims, dtype: torch.dtype,
              device: torch.device) -> List[Dict[str, torch.Tensor]]:
    layers = []
    for i, o in zip(dims[:-1], dims[1:]):
        w = torch.empty((i, o), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=generator)
        layers.append({"w": (w * i ** -0.5).to(dtype),
                       "b": torch.zeros((o,), dtype=dtype, device=device)})
    return layers


def _mlp_apply(layers: List[Dict[str, torch.Tensor]], x: torch.Tensor, *,
               final_act: bool = False) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def init_params(generator: torch.Generator, cfg: DLRMConfig, *, device=None,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (None: the card): tables ~ N(0, 1/D) in ``cfg.dtype``, MLP
    weights truncated-normal scaled by ``fan_in ** -0.5``, zero biases."""
    device = resolve_device(device)
    return {
        "tables": eb.init_tables(generator, cfg.embedding_config(),
                                 device=device),
        "bottom": _mlp_init(generator,
                            (cfg.num_dense_features,) + cfg.bottom_mlp,
                            dtype, device),
        "top": _mlp_init(generator, (cfg.interaction_dim,) + cfg.top_mlp,
                         dtype, device),
    }


def dot_interaction(dense_vec: torch.Tensor,
                    pooled: torch.Tensor) -> torch.Tensor:
    """dense (B, D), pooled (B, T, D) -> (B, D + (T+1)T/2) features; the
    pairs in ``triu_indices(T + 1, k=1)`` order, as in the reference."""
    B, T, D = pooled.shape
    feats = torch.cat([dense_vec[:, None, :], pooled], dim=1)   # (B, N, D)
    gram = torch.bmm(feats, feats.transpose(1, 2))              # (B, N, N)
    n = T + 1
    iu, ju = torch.triu_indices(n, n, 1, device=gram.device)
    return torch.cat([dense_vec, gram[:, iu, ju]], dim=1)


def _batch_rows(batch: JaggedBatch, rows: slice) -> JaggedBatch:
    return JaggedBatch(
        batch.indices[:, rows], batch.lengths[:, rows],
        None if batch.weights is None else batch.weights[:, rows])


def _pooled_sharded(tables, batch: JaggedBatch, ecfg,
                    ctx: ParallelContext | ProcessContext) -> torch.Tensor:
    """The distributed pooled lookup: the tables sharded per
    ``ecfg.sharding`` over the context's model axis (unless they already
    are), the batch split over its data-parallel groups, which run one
    after another.  Under a ``ProcessContext``, this rank's shard (stacked
    tables are sharded on the call)."""
    if isinstance(ctx, ProcessContext):
        if not isinstance(tables, eb.RankShard):
            tables = eb.shard_for_rank(tables, ecfg, ctx)
        if not same_model_axis(tables.ctx, ctx):
            raise ValueError("the rank's shard was made under another "
                             "ProcessContext")
        return eb.pooled_lookup_sharded(tables, batch, ecfg)
    if not isinstance(tables, eb.ShardedTables):
        tables = eb.shard_tables(tables, ecfg, ctx.tp_size)
    if tables.num_shards != ctx.tp_size:
        raise ValueError(f"tables sharded over {tables.num_shards} ranks, "
                         f"the context's model axis has {ctx.tp_size}")
    groups = ctx.dp_groups(batch.batch_size)
    if groups == 1:
        return eb.pooled_lookup_sharded(tables, batch, ecfg)
    size = batch.batch_size // groups
    return torch.cat([eb.pooled_lookup_sharded(tables, _batch_rows(
        batch, slice(g * size, (g + 1) * size)), ecfg)
        for g in range(groups)])


def forward(params, dense: torch.Tensor, batch: JaggedBatch,
            cfg: DLRMConfig,
            ctx: Optional[ParallelContext | ProcessContext] = None
            ) -> torch.Tensor:
    """dense (B, num_dense), batch: sparse lookups -> CTR logit (B,).

    ``params["tables"]`` is the stacked (T, R, D) tables or the tiered
    cache's flat slot pool (then ``batch`` holds slot ids).  With a
    ``ctx`` the pooling runs the distributed embedding bag, over
    ``params["tables"]`` sharded per ``cfg.sharding`` (stacked tables are
    sharded on the call; an engine passes the ``ShardedTables`` it built
    once; a rank of a ``ProcessContext`` its ``RankShard``).  Under a
    ``ProcessContext`` whose data groups split the batch, this data
    group's rows through its model axis, the (B,) logits gathered over
    the data axis."""
    ecfg = cfg.embedding_config()
    split = data_split(ctx, batch.batch_size)
    if split is not None:
        rows, model = split
        logit = forward(params, dense[rows], _batch_rows(batch, rows), cfg,
                        model)
        return comm.data_all_gather(logit, ctx=ctx)
    if ctx is None:
        pooled = eb.pooled_lookup_local(params["tables"], batch, ecfg)
    else:
        pooled = _pooled_sharded(params["tables"], batch, ecfg, ctx)
    bot = _mlp_apply(params["bottom"], dense, final_act=True)   # (B, D)
    feats = dot_interaction(bot, pooled.to(bot.dtype))
    return _mlp_apply(params["top"], feats)[:, 0]


def bce_loss(params, dense, batch: JaggedBatch, labels: torch.Tensor,
             cfg: DLRMConfig,
             ctx: Optional[ParallelContext | ProcessContext] = None
             ) -> torch.Tensor:
    """The mean binary cross-entropy of the logits of :func:`forward`
    over the batch.  Under grad it trains whatever needs a gradient: the
    tables (stacked, sharded, or a rank's ``RankShard`` whose ``local``
    is a leaf) and the MLP leaves.  Under a ``ProcessContext`` every rank
    of a data group scores the group's rows from the pooled vectors its
    ranks hold alike, and the logits come back whole over the data axis,
    so every rank computes the same loss, the whole batch's mean.  Within
    a data group there is nothing to sum: the MLPs' gradients are the
    group's rows' on every rank of it, and each rank's shard gets its
    rows of the tables' gradient (``core/comm.py``'s rank collectives
    under grad).  Across data groups that split the batch, each holds its
    rows' share of every gradient (the shards are replicated over the
    data axis): :func:`sum_over_data` sums them before the update, so
    that every group takes the same step.  The one-sided all-to-all
    pipeline (``rw_impl="a2a", rw_backend="onesided"``) has no
    derivative, as in the reference: with tables that need a gradient it
    raises ``RuntimeError``, on simulated ranks and processes alike."""
    logit = forward(params, dense, batch, cfg, ctx)
    z = torch.nn.functional.logsigmoid(logit)
    zn = torch.nn.functional.logsigmoid(-logit)
    return -torch.mean(labels * z + (1.0 - labels) * zn)


def sum_over_data(grads, batch_size: int,
                  ctx: Optional[ParallelContext | ProcessContext] = None
                  ) -> List[torch.Tensor]:
    """The whole batch's gradients of :func:`bce_loss`'s leaves (the MLP
    leaves, a rank's table shard), from ``grads`` of a batch of
    ``batch_size``: under a ``ProcessContext`` whose data groups split it,
    each group's are its rows' share, summed here over the data axis (one
    all-reduce a leaf, the same sum on every rank); otherwise ``grads``
    are the whole batch's already."""
    grads = list(grads)
    if data_split(ctx, batch_size) is None:
        return grads
    with torch.no_grad():
        return [comm.data_all_reduce(g, ctx=ctx) for g in grads]
