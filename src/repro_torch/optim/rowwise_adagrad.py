"""Row-wise Adagrad -- the industry-standard embedding-table optimizer.

The counterpart of ``repro.optim.rowwise_adagrad``, with its arithmetic:
one accumulator scalar per embedding ROW (not per element), state (T, R)
for (T, R, D) stacked tables, a D-fold memory saving that matters when
the tables are the model (DLRM).  The accumulators only grow where the
gradient is non-zero, and a row whose gradient is exactly zero comes out
bitwise unchanged (its step ``lr / (sqrt(accum) + eps) * 0`` is 0).

The update is dense, as the reference's, and walks the rows in the
slices of ``optim/adamw.py`` (at most 2**25 elements): each row's mean
and step are its own, so a slice computes what the whole does, and at
full width (26 x 10**6 x 128 f32) it holds the tables, the gradient and
the new tables, and f32 temporaries of a slice's size.

When each rank is a process, the tables are this rank's ``RankShard``
(``core/embedding_bag.shard_for_rank``): each rank updates its own shard
and its own accumulator (the shard's rows).  A column shard holds ``D/E``
of each row's ``D`` columns, and the reference's mean runs over all D: the
per-row sums of squares are all-reduced over the ranks (the group's
order) before the division by D.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import comm
from repro_torch.optim.adamw import _row_slices


def rowwise_adagrad_init(tables) -> torch.Tensor:
    """tables (T, R, D), or a rank's ``RankShard`` -> accumulator (T, R)
    f32 (the shard's rows) on the tables' device."""
    local = getattr(tables, "local", tables)
    return torch.zeros(local.shape[:-1], dtype=torch.float32,
                       device=local.device)


@torch.no_grad()
def rowwise_adagrad_update(tables, accum: torch.Tensor,
                           grads: torch.Tensor, *, lr: float = 0.01,
                           eps: float = 1e-8) -> Tuple[object, torch.Tensor]:
    """One update; returns ``(new tables, new accum)``, both new tensors
    (a ``RankShard`` in, a new ``RankShard`` of the new rows out).

    ``grads`` (T, R, D) is zero on untouched rows (a shard's: its rows,
    columns or tables).  In f32: ``accum += mean(grads**2, -1)``,
    ``scale = lr / (sqrt(accum) + eps)``, ``tables - scale[..., None] *
    grads``, then cast to the tables' dtype.  For a column shard the mean
    is the all-reduced sum of squares over the full D, divided by D."""
    shard = tables if hasattr(tables, "local") else None
    if shard is not None:
        tables = shard.local.detach()
    D = tables.shape[-1]
    rows_t, rows_g = tables.reshape(-1, D), grads.reshape(-1, D)
    slices = list(_row_slices(tables.shape))
    column = shard is not None and shard.sharding == "column"
    g2 = torch.empty(rows_t.shape[0], dtype=torch.float32,
                     device=rows_t.device)
    for a, b in slices:
        sq = torch.square(rows_g[a:b].to(torch.float32))
        g2[a:b] = sq.sum(dim=-1) if column else torch.mean(sq, dim=-1)
        del sq
    if column:                  # the sums over this rank's D/E columns
        g2 = comm.all_reduce(g2, ctx=shard.ctx) / shard.shape[-1]
    accum = accum + g2.view(accum.shape)
    scale = (lr / (torch.sqrt(accum) + eps)).reshape(-1)
    new_tables = torch.empty_like(tables)
    out = new_tables.view(-1, D)
    for a, b in slices:
        out[a:b] = (rows_t[a:b].to(torch.float32) - scale[a:b, None]
                    * rows_g[a:b].to(torch.float32)).to(tables.dtype)
    if shard is not None:
        return dataclasses.replace(shard, local=new_tables), accum
    return new_tables, accum
