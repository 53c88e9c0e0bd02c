"""DLRM -- bottom MLP, pooled embedding lookup, dot interaction, top MLP.

The counterpart of the single-device path of ``repro.models.dlrm``.
Parameters are a plain dict of tensors in the reference's layout,
``{"tables": (T, R, D), "bottom": [{"w": (in, out), "b": (out,)}, ...],
"top": [...]}``, applied as ``x @ w + b``, so weights carry across from the
JAX ``init_params`` pytree without a transpose (``utils.convert``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.core import embedding_bag as eb
from repro_torch.core.jagged import JaggedBatch
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


def forward(params, dense: torch.Tensor, batch: JaggedBatch,
            cfg: DLRMConfig) -> torch.Tensor:
    """dense (B, num_dense), batch: sparse lookups -> CTR logit (B,).

    ``params["tables"]`` is the stacked (T, R, D) tables or the tiered
    cache's flat slot pool (then ``batch`` holds slot ids)."""
    pooled = eb.pooled_lookup_local(params["tables"], batch,
                                    cfg.embedding_config())
    bot = _mlp_apply(params["bottom"], dense, final_act=True)   # (B, D)
    feats = dot_interaction(bot, pooled.to(bot.dtype))
    return _mlp_apply(params["top"], feats)[:, 0]


def bce_loss(params, dense, batch: JaggedBatch, labels: torch.Tensor,
             cfg: DLRMConfig) -> torch.Tensor:
    logit = forward(params, dense, batch, cfg)
    z = torch.nn.functional.logsigmoid(logit)
    zn = torch.nn.functional.logsigmoid(-logit)
    return -torch.mean(labels * z + (1.0 - labels) * zn)
