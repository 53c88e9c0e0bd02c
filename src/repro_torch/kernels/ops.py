"""Public embedding-bag ops over the TBE gather+pool kernel.

The counterparts of ``repro.kernels.ops``.  There is no ``mode``: every op
goes through the wrappers of :mod:`repro_torch.kernels.embedding_gather`,
which dispatch on the tensors' device -- the CUDA kernel on the card, the
plain version on the CPU, an error anywhere else.

``embedding_bag_batched`` keeps ``fused``: True is ONE TBE launch for all
T tables, False is T single-table launches -- the unfused baseline of the
paper's #tables sweep, which must stay T launches.

Around the kernel, as in the reference: the length mask times the optional
weights gives the effective weights, the mean combiner divides by
``max(sum w, 1)`` and the result is cast back to the table dtype.  Ids of
masked slots are replaced by 0 before the gather (requests may pad beyond
``lengths`` with anything, ``-1`` included, and torch indexing raises on
ids out of range where jnp clamps them).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.embedding_gather import (
    gather_pool,
    gather_pool_tbe,
    gather_pool_tbe_flat,
)


def _mask(indices: torch.Tensor,
          lengths: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Bool length mask, rank-generic ((B, L)/(B,) or (T, B, L)/(T, B));
    None when every slot is live."""
    if lengths is None:
        return None
    L = indices.shape[-1]
    return torch.arange(L, device=indices.device) < lengths[..., None]


def _effective_weights(indices, lengths, weights) -> torch.Tensor:
    """Padding/length mask times optional weights, f32."""
    mask = _mask(indices, lengths)
    eff = (torch.ones(indices.shape, dtype=torch.float32,
                      device=indices.device)
           if mask is None else mask.to(torch.float32))
    if weights is not None:
        eff = eff * weights.to(torch.float32)
    return eff


def _safe_ids(indices, lengths) -> torch.Tensor:
    """Contiguous int32 ids with every masked slot's id replaced by 0."""
    mask = _mask(indices, lengths)
    if mask is not None:
        indices = torch.where(mask, indices, 0)
    return indices.to(torch.int32).contiguous()


def _premask_rw(table_rows: int, row_offset, indices, lengths,
                weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """RW pre-masking: out-of-shard GLOBAL ids go to (local row 0, weight
    0), so one gather kernel serves the single-device and row-wise paths."""
    local = indices.long() - int(row_offset)
    owned = (local >= 0) & (local < table_rows)
    safe = torch.where(owned, local, 0).to(torch.int32).contiguous()
    eff_w = _effective_weights(indices, lengths, weights) \
        * owned.to(torch.float32)
    return safe, eff_w


def _check_combiner(combiner: str) -> None:
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")


def _combine(out: torch.Tensor, eff_w: torch.Tensor, combiner: str,
             dtype: torch.dtype) -> torch.Tensor:
    """Mean divides by ``max(sum w, 1)``; then the cast to the table dtype."""
    if combiner == "mean":
        out = out / eff_w.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return out.to(dtype)


# --- single table ------------------------------------------------------------

def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None,
                  weights: Optional[torch.Tensor] = None, *,
                  combiner: str = "sum") -> torch.Tensor:
    """Pooled embedding lookup, ``(R, D) x (B, L) -> (B, D)``."""
    _check_combiner(combiner)
    eff_w = _effective_weights(indices, lengths, weights)
    out = gather_pool(table, _safe_ids(indices, lengths), eff_w)
    return _combine(out, eff_w, combiner, table.dtype)


def embedding_bag_rw_partial(table_shard: torch.Tensor, row_offset,
                             indices: torch.Tensor,
                             lengths: Optional[torch.Tensor] = None,
                             weights: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Row-wise-parallel partial pool: ``indices`` are GLOBAL ids; rows
    outside ``[row_offset, row_offset + R)`` contribute zero, so summing
    over shards gives the full pooled output."""
    safe, eff_w = _premask_rw(table_shard.shape[0], row_offset, indices,
                              lengths, weights)
    return gather_pool(table_shard, safe, eff_w).to(table_shard.dtype)


# --- table-batched -------------------------------------------------------------

def _per_table(tables, safe, eff_w) -> torch.Tensor:
    """Unfused baseline: one single-table launch per table (T launches)."""
    return torch.stack([gather_pool(tables[t], safe[t], eff_w[t])
                        for t in range(tables.shape[0])])


def embedding_bag_batched(tables: torch.Tensor, indices: torch.Tensor,
                          lengths: Optional[torch.Tensor] = None,
                          weights: Optional[torch.Tensor] = None, *,
                          combiner: str = "sum",
                          fused: bool = True) -> torch.Tensor:
    """Pooled lookup over ALL tables, ``(T,R,D) x (T,B,L) -> (T,B,D)``.

    ``fused=True`` is one TBE launch for every table; ``fused=False`` is T
    single-table launches."""
    _check_combiner(combiner)
    eff_w = _effective_weights(indices, lengths, weights)
    safe = _safe_ids(indices, lengths)
    out = (gather_pool_tbe(tables, safe, eff_w) if fused
           else _per_table(tables, safe, eff_w))
    return _combine(out, eff_w, combiner, tables.dtype)


def embedding_bag_batched_flat(flat_tables: torch.Tensor,
                               row_offsets: torch.Tensor,
                               indices: torch.Tensor,
                               lengths: Optional[torch.Tensor] = None,
                               weights: Optional[torch.Tensor] = None, *,
                               combiner: str = "sum") -> torch.Tensor:
    """Pooled lookup over a FLAT ragged row space -> (T, B, D):
    ``out[t, b] = pool_l flat_tables[row_offsets[t] + indices[t, b, l]]``.

    The entry point of the tiered cache's ``(sum S_t, D)`` slot pool.
    Always one fused launch: a ragged pool has no rectangle to split per
    table."""
    _check_combiner(combiner)
    eff_w = _effective_weights(indices, lengths, weights)
    out = gather_pool_tbe_flat(
        flat_tables, row_offsets.to(torch.int32).contiguous(),
        _safe_ids(indices, lengths), eff_w)
    return _combine(out, eff_w, combiner, flat_tables.dtype)


def _flat_rows(tables: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``(rows, D)`` view over the storage of ``(T, R, D)`` tables whose
    rows are contiguous, and the ``(T,)`` int32 row of each table's first
    row in it.  A row shard of stacked tables (rows ``[a, b)`` of every
    table) is such a strided view, so it is read in place; any other layout
    is copied first."""
    T, R, D = tables.shape
    if tables.stride(2) != 1 or tables.stride(1) != D \
            or tables.stride(0) % max(D, 1):
        tables = tables.contiguous()
    step = tables.stride(0) // max(D, 1)
    flat = tables.as_strided(((T - 1) * step + R, D), (D, 1))
    starts = torch.arange(T, device=tables.device, dtype=torch.int32) * step
    return flat, starts


def embedding_bag_rw_partial_batched(table_shards: torch.Tensor, row_offset,
                                     indices: torch.Tensor,
                                     lengths: Optional[torch.Tensor] = None,
                                     weights: Optional[torch.Tensor] = None,
                                     *, fused: bool = True) -> torch.Tensor:
    """Table-batched row-wise-parallel partial pool -> (T, B, D): the
    batched :func:`embedding_bag_rw_partial`, one fused launch (or T).

    ``table_shards`` may be the strided view of a row shard of stacked
    ``(T, R, D)`` tables: the fused launch reads it in place through the
    flat TBE entry, with per-table offsets into the tables' storage."""
    safe, eff_w = _premask_rw(table_shards.shape[1], row_offset, indices,
                              lengths, weights)
    if fused:
        flat, starts = _flat_rows(table_shards)
        out = gather_pool_tbe_flat(flat, starts, safe, eff_w)
    else:
        out = _per_table(table_shards, safe, eff_w)
    return out.to(table_shards.dtype)
