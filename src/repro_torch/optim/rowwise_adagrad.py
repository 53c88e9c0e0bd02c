"""Row-wise Adagrad -- the industry-standard embedding-table optimizer.

The counterpart of ``repro.optim.rowwise_adagrad``, with its arithmetic:
one accumulator scalar per embedding ROW (not per element), state (T, R)
for (T, R, D) stacked tables, a D-fold memory saving that matters when
the tables are the model (DLRM).  The accumulators only grow where the
gradient is non-zero, and a row whose gradient is exactly zero comes out
bitwise unchanged (its step ``lr / (sqrt(accum) + eps) * 0`` is 0).

The update is dense, as the reference's: at full width (26 x 10**6 x 128
f32) it holds the tables, the gradient and two more tensors of their size
at its peak.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rowwise_adagrad_init(tables: torch.Tensor) -> torch.Tensor:
    """tables (T, R, D) -> accumulator (T, R) f32 on the tables' device."""
    return torch.zeros(tables.shape[:-1], dtype=torch.float32,
                       device=tables.device)


@torch.no_grad()
def rowwise_adagrad_update(tables: torch.Tensor, accum: torch.Tensor,
                           grads: torch.Tensor, *, lr: float = 0.01,
                           eps: float = 1e-8
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update; returns ``(new tables, new accum)``, both new tensors.

    ``grads`` (T, R, D) is zero on untouched rows.  In f32:
    ``accum += mean(grads**2, -1)``, ``scale = lr / (sqrt(accum) + eps)``,
    ``tables - scale[..., None] * grads``, then cast to the tables'
    dtype."""
    g = grads.to(torch.float32)
    g2 = torch.mean(torch.square(g), dim=-1)                 # (T, R)
    accum = accum + g2
    scale = lr / (torch.sqrt(accum) + eps)
    new_tables = tables.to(torch.float32) - scale[..., None] * g
    return new_tables.to(tables.dtype), accum
