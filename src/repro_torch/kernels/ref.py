"""Plain PyTorch oracles for the embedding-bag kernels.

The counterparts of ``repro.kernels.ref``: the references the CUDA kernel
is held against on the card, and the plain versions that CPU tensors take.
Ids must lie in the table wherever the length mask is on; padding slots may
hold any id that indexes the table (``-1`` wraps to the last row) and
contribute zero.
"""
from __future__ import annotations

from typing import Optional

import torch


def _pool_rows(rows: torch.Tensor, lengths: Optional[torch.Tensor],
               weights: Optional[torch.Tensor], combiner: str,
               out_dtype: torch.dtype) -> torch.Tensor:
    """The shared pooling tail: mask, weighted-sum einsum, combiner, cast.

    ``rows`` is ``(..., L, D)``, ``lengths`` ``(...)`` and ``weights``
    ``(..., L)``.  ONE definition on purpose: the stacked ``(T, R, D)``
    oracle and the flat ``(N, D)`` oracle (the slot-pool layout) run the
    same pooling program on same-shaped gathers, so equal row payloads
    pool to bitwise-equal outputs.
    """
    L = rows.shape[-2]
    if lengths is None:
        mask = torch.ones(rows.shape[:-1], dtype=torch.float32,
                          device=rows.device)
    else:
        mask = (torch.arange(L, device=rows.device)
                < lengths[..., None]).to(torch.float32)
    w = mask if weights is None else mask * weights.to(torch.float32)
    out = torch.einsum("...ld,...l->...d", rows.to(torch.float32), w)
    if combiner == "mean":
        out = out / w.sum(dim=-1, keepdim=True).clamp_min(1.0)
    elif combiner != "sum":
        raise ValueError(f"unknown combiner {combiner!r}")
    return out.to(out_dtype)


def _table_ids(num_tables: int, device) -> torch.Tensor:
    return torch.arange(num_tables, device=device)[:, None, None]


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None,
                      weights: Optional[torch.Tensor] = None, *,
                      combiner: str = "sum") -> torch.Tensor:
    """Gather + pool, ``(R, D) x (B, L) -> (B, D)`` in the table dtype."""
    rows = table[indices.long()]                             # (B, L, D)
    return _pool_rows(rows, lengths, weights, combiner, table.dtype)


def _owned_weights(table_rows, row_offset, indices, weights):
    """Row-wise shard ownership: table-local ids and weights zeroed for
    ids outside ``[row_offset, row_offset + table_rows)``."""
    local = indices.long() - int(row_offset)
    owned = (local >= 0) & (local < table_rows)
    w = owned.to(torch.float32)
    if weights is not None:
        w = w * weights.to(torch.float32)
    return torch.where(owned, local, 0), w


def embedding_bag_masked_ref(table_shard: torch.Tensor, row_offset,
                             indices: torch.Tensor,
                             lengths: Optional[torch.Tensor] = None,
                             weights: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Row-wise-parallel partial pool: only rows this shard owns count;
    summing over shards gives the full embedding bag."""
    safe, w = _owned_weights(table_shard.shape[0], row_offset, indices,
                             weights)
    return _pool_rows(table_shard[safe], lengths, w, "sum",
                      table_shard.dtype)


def embedding_bag_batched_ref(tables: torch.Tensor, indices: torch.Tensor,
                              lengths: Optional[torch.Tensor] = None,
                              weights: Optional[torch.Tensor] = None, *,
                              combiner: str = "sum") -> torch.Tensor:
    """Table-batched oracle: ``(T, R, D) x (T, B, L) -> (T, B, D)``."""
    rows = tables[_table_ids(tables.shape[0], tables.device),
                  indices.long()]                            # (T, B, L, D)
    return _pool_rows(rows, lengths, weights, combiner, tables.dtype)


def embedding_bag_batched_flat_ref(flat_tables: torch.Tensor,
                                   row_offsets: torch.Tensor,
                                   indices: torch.Tensor,
                                   lengths: Optional[torch.Tensor] = None,
                                   weights: Optional[torch.Tensor] = None,
                                   *, combiner: str = "sum") -> torch.Tensor:
    """Table-batched oracle over a FLAT ragged row space: table ``t``'s rows
    start at ``flat_tables[row_offsets[t]]``.  Runs the same gather shape
    and :func:`_pool_rows` program as :func:`embedding_bag_batched_ref`."""
    rows = flat_tables[row_offsets.long()[:, None, None]
                       + indices.long()]                     # (T, B, L, D)
    return _pool_rows(rows, lengths, weights, combiner, flat_tables.dtype)


def embedding_bag_masked_batched_ref(table_shards: torch.Tensor, row_offset,
                                     indices: torch.Tensor,
                                     lengths: Optional[torch.Tensor] = None,
                                     weights: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """Table-batched RW-partial oracle (see embedding_bag_masked_ref)."""
    safe, w = _owned_weights(table_shards.shape[1], row_offset, indices,
                             weights)
    rows = table_shards[_table_ids(table_shards.shape[0],
                                   table_shards.device), safe]
    return _pool_rows(rows, lengths, w, "sum", table_shards.dtype)


def embedding_onehot_ref(table: torch.Tensor, indices: torch.Tensor,
                         lengths: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One-hot-matmul formulation, ``onehot(indices) @ table`` summed over
    L: a cross-check of the gather formulation."""
    L = indices.shape[-1]
    oh = torch.nn.functional.one_hot(indices.long(), table.shape[0]).to(
        table.dtype)                                         # (B, L, R)
    if lengths is not None:
        mask = (torch.arange(L, device=indices.device)
                < lengths[:, None]).to(table.dtype)
        oh = oh * mask[:, :, None]
    return torch.einsum("blr,rd->bd", oh, table)
