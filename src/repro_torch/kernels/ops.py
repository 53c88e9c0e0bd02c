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

Every op is differentiable in the tables and the weights, on both devices:
the wrappers are called through three ``torch.autograd.Function``s, the
counterparts of the reference's ``custom_vjp``s (``_pooled_lookup_pallas``,
``_pooled_lookup_tbe``, ``_pooled_lookup_tbe_flat``).  Their forward is the
wrapper, so an op that nothing differentiates returns the wrapper's output
bitwise, after the same launches; their backward is stock torch, as the
reference's is XLA: ``index_add_`` (the gather's transpose) of ``w * g``
into the flat row space, and ``<row, g>`` for the weights only when asked.
A masked slot (id 0, weight 0) adds +-0.0 to row 0 of its table.  On the
card ``index_add_`` adds with atomics, so the order of a row's terms, and
its last bits, vary from run to run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

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


# --- the differentiable lookups --------------------------------------------

def _rows_grad(n_rows: int, flat_idx: torch.Tensor, eff_w: torch.Tensor,
               g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """d rows ``(n_rows, D)``: each slot's ``w * g`` added into row
    ``flat_idx`` (a scatter-add, the transpose of the kernel's gather), in
    f32, then cast to the rows' dtype."""
    D = g.shape[-1]
    contrib = (eff_w[..., None] * g[..., None, :]).reshape(-1, D)
    d_rows = torch.zeros((n_rows, D), dtype=torch.float32, device=g.device)
    return d_rows.index_add_(0, flat_idx, contrib).to(dtype)


def _weights_grad(flat: torch.Tensor, flat_idx: torch.Tensor,
                  eff_w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d eff_w ``[..., l] = <flat[flat_idx[..., l]], g[...]>`` in f32."""
    rows = flat[flat_idx].reshape(*eff_w.shape, flat.shape[-1])
    return torch.einsum("...ld,...d->...l", rows.to(torch.float32), g)


class _PooledLookup(torch.autograd.Function):
    """One table through :func:`gather_pool`: ``(R, D) x (B, L) -> (B, D)``
    f32 (the reference's ``_pooled_lookup_pallas``)."""

    @staticmethod
    def forward(ctx, table, indices, eff_w):
        ctx.save_for_backward(table, indices, eff_w)
        return gather_pool(table, indices, eff_w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        table, indices, eff_w = ctx.saved_tensors
        flat_idx = indices.long().reshape(-1)
        d_table = d_w = None
        if ctx.needs_input_grad[0]:
            d_table = _rows_grad(table.shape[0], flat_idx, eff_w, g,
                                 table.dtype)
        if ctx.needs_input_grad[2]:
            d_w = _weights_grad(table, flat_idx, eff_w, g)
        return d_table, None, d_w


class _PooledLookupTBE(torch.autograd.Function):
    """Stacked ``(T, R, D)`` tables through :func:`gather_pool_tbe`, one
    launch (the reference's ``_pooled_lookup_tbe``); the backward adds
    into the ``(T * R, D)`` row space at ``t * R + id``."""

    @staticmethod
    def forward(ctx, tables, indices, eff_w):
        ctx.save_for_backward(tables, indices, eff_w)
        return gather_pool_tbe(tables, indices, eff_w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        tables, indices, eff_w = ctx.saved_tensors
        T, R, D = tables.shape
        offs = torch.arange(T, device=indices.device)[:, None, None] * R
        flat_idx = (indices.long() + offs).reshape(-1)
        d_tables = d_w = None
        if ctx.needs_input_grad[0]:
            d_tables = _rows_grad(T * R, flat_idx, eff_w, g,
                                  tables.dtype).view(T, R, D)
        if ctx.needs_input_grad[2]:
            d_w = _weights_grad(tables.reshape(T * R, D), flat_idx, eff_w,
                                g)
        return d_tables, None, d_w


class _PooledLookupTBEFlat(torch.autograd.Function):
    """A flat ragged ``(N, D)`` row space through
    :func:`gather_pool_tbe_flat`, one launch (the reference's
    ``_pooled_lookup_tbe_flat``); the backward adds into it at
    ``row_offsets[t] + id``."""

    @staticmethod
    def forward(ctx, flat_tables, row_offsets, indices, eff_w):
        ctx.save_for_backward(flat_tables, row_offsets, indices, eff_w)
        return gather_pool_tbe_flat(flat_tables, row_offsets, indices, eff_w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        flat_tables, row_offsets, indices, eff_w = ctx.saved_tensors
        offs = row_offsets.long()[:, None, None]
        flat_idx = (indices.long() + offs).reshape(-1)
        d_flat = d_w = None
        if ctx.needs_input_grad[0]:
            d_flat = _rows_grad(flat_tables.shape[0], flat_idx, eff_w, g,
                                flat_tables.dtype)
        if ctx.needs_input_grad[3]:
            d_w = _weights_grad(flat_tables, flat_idx, eff_w, g)
        return d_flat, None, None, d_w


_pooled_lookup = _PooledLookup.apply
_pooled_lookup_tbe = _PooledLookupTBE.apply
_pooled_lookup_tbe_flat = _PooledLookupTBEFlat.apply


# --- single table ------------------------------------------------------------

def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None,
                  weights: Optional[torch.Tensor] = None, *,
                  combiner: str = "sum") -> torch.Tensor:
    """Pooled embedding lookup, ``(R, D) x (B, L) -> (B, D)``."""
    _check_combiner(combiner)
    eff_w = _effective_weights(indices, lengths, weights)
    out = _pooled_lookup(table, _safe_ids(indices, lengths), eff_w)
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
    return _pooled_lookup(table_shard, safe, eff_w).to(table_shard.dtype)


# --- table-batched -------------------------------------------------------------

def _per_table(tables, safe, eff_w) -> torch.Tensor:
    """Unfused baseline: one single-table launch per table (T launches).
    ``unbind`` keeps the backward one stack of the T table gradients (T
    ``tables[t]`` selects would each scatter into a dense (T, R, D))."""
    return torch.stack([_pooled_lookup(table, ids, w) for table, ids, w
                        in zip(tables.unbind(0), safe, eff_w)])


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
    out = (_pooled_lookup_tbe(tables, safe, eff_w) if fused
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
    out = _pooled_lookup_tbe_flat(
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
    if tables.is_contiguous():
        # a view autograd takes back as one: a rank's own shard, a leaf
        # under training, gets its gradient without an as_strided scatter
        return (tables.view(T * R, D),
                torch.arange(T, device=tables.device, dtype=torch.int32) * R)
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
        out = _pooled_lookup_tbe_flat(flat, starts, safe, eff_w)
    else:
        out = _per_table(table_shards, safe, eff_w)
    return out.to(table_shards.dtype)


# ---------------------------------------------------------------------------
# Kernel contracts (audited by repro_torch.analysis)
# ---------------------------------------------------------------------------

from repro_torch.analysis.contracts import KernelContract  # noqa: E402

# The paper's structural claims for this module, as declarative specs:
# tests, chip_smoke.py and `python -m repro_torch.analysis --contracts`
# audit against THESE objects.
KERNEL_CONTRACTS = {
    "tbe_fused": KernelContract(
        name="kernels.ops.embedding_bag_batched[fused]",
        note="ALL T tables' gather+pool execute in ONE TBE launch "
             "(flattened (T*R, D) row space, table t at row t * R)"),
    "tbe_flat": KernelContract(
        name="kernels.ops.embedding_bag_batched_flat",
        note="the flat (sum S_t, D) slot-pool TBE stays one launch"),
    "rw_partial_fused": KernelContract(
        name="kernels.ops.embedding_bag_rw_partial_batched[fused]",
        note="the row-wise-sharded partial pool stays one launch; "
             "reduction across shards happens OUTSIDE the kernel"),
}
