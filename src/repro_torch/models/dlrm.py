"""DLRM -- bottom MLP, pooled embedding lookup, dot interaction, top MLP.

The counterpart of ``repro.models.dlrm``.  With a ``ParallelContext`` the
pooling runs the distributed embedding bag over the context's simulated
model axis (``core/embedding_bag.pooled_lookup_sharded``).
Parameters are a plain dict of tensors in the reference's layout,
``{"tables": (T, R, D), "bottom": [{"w": (in, out), "b": (out,)}, ...],
"top": [...]}``, applied as ``x @ w + b``, so weights carry across from the
JAX ``init_params`` pytree without a transpose (``utils.convert``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.core import embedding_bag as eb
from repro_torch.core.jagged import JaggedBatch
from repro_torch.core.parallel import ParallelContext
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


def _pooled_sharded(tables, batch: JaggedBatch, ecfg,
                    ctx: ParallelContext) -> torch.Tensor:
    """The distributed pooled lookup: the tables sharded per
    ``ecfg.sharding`` over the context's model axis (unless they already
    are), the batch split over its data-parallel groups, which run one
    after another."""
    if not isinstance(tables, eb.ShardedTables):
        tables = eb.shard_tables(tables, ecfg, ctx.tp_size)
    if tables.num_shards != ctx.tp_size:
        raise ValueError(f"tables sharded over {tables.num_shards} ranks, "
                         f"the context's model axis has {ctx.tp_size}")
    groups = ctx.dp_groups(batch.batch_size)
    if groups == 1:
        return eb.pooled_lookup_sharded(tables, batch, ecfg)
    parts = []
    for g in range(groups):
        size = batch.batch_size // groups
        sl = slice(g * size, (g + 1) * size)
        parts.append(eb.pooled_lookup_sharded(tables, JaggedBatch(
            batch.indices[:, sl], batch.lengths[:, sl],
            None if batch.weights is None else batch.weights[:, sl]),
            ecfg))
    return torch.cat(parts)


def forward(params, dense: torch.Tensor, batch: JaggedBatch,
            cfg: DLRMConfig,
            ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """dense (B, num_dense), batch: sparse lookups -> CTR logit (B,).

    ``params["tables"]`` is the stacked (T, R, D) tables or the tiered
    cache's flat slot pool (then ``batch`` holds slot ids).  With a
    ``ctx`` the pooling runs the distributed embedding bag, over
    ``params["tables"]`` sharded per ``cfg.sharding`` (stacked tables are
    sharded on the call; an engine passes the ``ShardedTables`` it built
    once)."""
    ecfg = cfg.embedding_config()
    if ctx is None:
        pooled = eb.pooled_lookup_local(params["tables"], batch, ecfg)
    else:
        pooled = _pooled_sharded(params["tables"], batch, ecfg, ctx)
    bot = _mlp_apply(params["bottom"], dense, final_act=True)   # (B, D)
    feats = dot_interaction(bot, pooled.to(bot.dtype))
    return _mlp_apply(params["top"], feats)[:, 0]


def bce_loss(params, dense, batch: JaggedBatch, labels: torch.Tensor,
             cfg: DLRMConfig,
             ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    logit = forward(params, dense, batch, cfg, ctx)
    z = torch.nn.functional.logsigmoid(logit)
    zn = torch.nn.functional.logsigmoid(-logit)
    return -torch.mean(labels * z + (1.0 - labels) * zn)
