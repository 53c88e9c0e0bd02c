"""The embedding bag: config, tables, pooled lookups -- local and sharded.

The counterpart of ``repro.core.embedding_bag``.  ``pooled_lookup_local``
runs every table through ONE fused TBE launch (``cfg.fused``), over the
stacked ``(T, R, D)`` tables or over the tiered cache's flat ``(sum S_t,
D)`` slot pool.

The distributed strategies of the paper (§4.1-4.3) run over a model axis
of E ranks simulated in one process on one device (``core/parallel.py``,
``core/comm.py``): the tables are sharded once (:func:`shard_tables`, the
counterpart of ``table_pspec``), and each rank's body -- ``_rw_a2a``'s
phases 1-2, ``_rw_allgather``'s partial, ``_cw``, ``_tw`` -- runs once per
rank over that rank's shard, with per-rank values stacked on a leading
rank axis between the collectives:

  * ``sharding="row"``, ``rw_impl="allgather"``: every rank pools the rows
    it owns of the replicated batch (one fused TBE launch per rank, the
    shard read in place), then one all-reduce (or reduce-scatter);
  * ``sharding="row"``, ``rw_impl="a2a"``, the PAPER-FAITHFUL pipeline:
    phase 1 buckets each rank's lookups by owner into fixed-capacity
    buffers and exchanges them with three all-to-alls; phase 2 gathers and
    segment-sums on the owner (stock torch ops, as the reference's is XLA);
    phase 3 reduce-scatters the partials back to the requesting rank.
    Lookups over a bucket's capacity are dropped and counted, padding
    included, as in the reference;
  * ``"column"``, ``"table"``: each rank pools its column slice / its
    tables of the whole batch, then an all-gather; ``"replicated"``: the
    local lookup.

``rw_backend`` picks the transport of the collectives: ``"bulk"`` (stock
torch ops, the NCCL analogue) or ``"onesided"`` (the chunk-put kernel, the
NVSHMEM analogue).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import KernelContract
from repro_torch.core import comm
from repro_torch.core.cache_config import CacheConfig
from repro_torch.core.jagged import JaggedBatch
from repro_torch.kernels import ops as kops
from repro_torch.utils.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHARDINGS = ("row", "column", "table", "replicated")
RW_IMPLS = ("allgather", "a2a")


@dataclasses.dataclass(frozen=True)
class EmbeddingBagConfig:
    num_tables: int
    rows_per_table: int
    dim: int
    combiner: str = "sum"            # sum | mean
    dtype: str = "float32"           # float32 | bfloat16
    sharding: str = "row"            # row | column | table | replicated
    rw_impl: str = "allgather"       # allgather | a2a (paper-faithful)
    rw_backend: str = "bulk"         # bulk (NCCL analogue) | onesided
    capacity_factor: float = 2.0     # a2a bucket capacity multiplier
    emulate_rs_with_a2a: bool = False  # the paper's reduce-scatter workaround
    # fused: ONE TBE launch for all T tables; False launches the
    # single-table kernel T times (the #tables baseline)
    fused: bool = True
    # rs_dtype: the partial pooled vectors' dtype through the phase-3
    # reduce-scatter / all-reduce (bfloat16 halves its bytes)
    rs_dtype: str = "float32"        # float32 | bfloat16
    # hot_rows: rows [0, hot_rows) are served from a replica by
    # pooled_lookup_hot and skip the distributed pipeline
    hot_rows: int = 0
    # the tiered cache's knobs; always a CacheConfig after construction
    cache: Optional[CacheConfig] = None

    def __post_init__(self):
        if self.cache is None:
            object.__setattr__(self, "cache", CacheConfig())
        for name, value, allowed in (
                ("dtype", self.dtype, tuple(DTYPES)),
                ("rs_dtype", self.rs_dtype, tuple(DTYPES)),
                ("sharding", self.sharding, SHARDINGS),
                ("rw_impl", self.rw_impl, RW_IMPLS),
                ("rw_backend", self.rw_backend, comm.BACKENDS)):
            if value not in allowed:
                raise ValueError(
                    f"{name} must be one of {allowed}, got {value!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def table_bytes(self) -> int:
        return (self.num_tables * self.rows_per_table * self.dim
                * self.torch_dtype.itemsize)


def init_tables(generator: torch.Generator, cfg: EmbeddingBagConfig, *,
                device=None) -> torch.Tensor:
    """(T, R, D) stacked tables ~ N(0, 1/D) drawn from ``generator``, which
    must live on ``device`` (None: the card)."""
    device = resolve_device(device)
    tables = torch.randn((cfg.num_tables, cfg.rows_per_table, cfg.dim),
                         generator=generator, dtype=torch.float32,
                         device=device)
    return tables.mul_(cfg.dim ** -0.5).to(cfg.torch_dtype)


# (device, offsets) -> a flat pool's (T,) int32 slot offsets on the device:
# each geometry's offsets are copied from the host once, so a lookup over
# the pool moves nothing between host and device after its first
_POOL_OFFSETS: dict = {}


def _pool_offsets(cfg: "EmbeddingBagConfig",
                  device: torch.device) -> torch.Tensor:
    offsets = cfg.cache.slot_offsets(cfg.num_tables,
                                     cfg.rows_per_table)[:-1]
    offsets = offsets.astype(np.int32)
    key = (device, offsets.tobytes())
    out = _POOL_OFFSETS.get(key)
    if out is None:
        out = _POOL_OFFSETS[key] = torch.as_tensor(offsets, device=device)
    return out


def pooled_lookup_local(tables: torch.Tensor, batch: JaggedBatch,
                        cfg: EmbeddingBagConfig) -> torch.Tensor:
    """Tables x JaggedBatch -> (B, T, D), no communication.

    ``tables`` is the stacked ``(T, R, D)`` tensor (ids are row ids) or the
    tiered cache's FLAT ``(sum S_t, D)`` slot pool (ids are table-local
    slot ids); the 2-D case takes its per-table offsets from ``cfg.cache``,
    the geometry the slot pool was sized with.  A flat pool is always one
    fused launch; stacked tables follow ``cfg.fused``."""
    if tables.dim() == 2:
        out = kops.embedding_bag_batched_flat(
            tables, _pool_offsets(cfg, tables.device),
            batch.indices, batch.lengths, batch.weights,
            combiner=cfg.combiner)
    else:
        out = kops.embedding_bag_batched(
            tables, batch.indices, batch.lengths, batch.weights,
            combiner=cfg.combiner, fused=cfg.fused)
    return out.transpose(0, 1)                               # (B, T, D)


# ---------------------------------------------------------------------------
# Sharded tables over the simulated model axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedTables:
    """The stacked tables sharded over ``num_shards`` simulated ranks.

    ``tables`` is the full ``(T, R, D)`` tensor for ``"row"``, ``"table"``
    and ``"replicated"`` -- their shards are views of it, read in place --
    and the ``(E, T, R, D/E)`` column copy for ``"column"``, whose shards
    are not contiguous in the stacked layout."""

    sharding: str
    num_shards: int
    tables: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.tables.dtype

    def shard(self, rank: int) -> torch.Tensor:
        """Rank ``rank``'s shard: ``(T, R/E, D)`` rows ``[rank * R/E,
        (rank + 1) * R/E)`` of every table (a strided view), ``(T, R,
        D/E)``, ``(T/E, R, D)`` or the full tables."""
        E = self.num_shards
        if self.sharding == "column":
            return self.tables[rank]
        if self.sharding == "row":
            rps = self.tables.shape[1] // E
            return self.tables[:, rank * rps:(rank + 1) * rps]
        if self.sharding == "table":
            tl = self.tables.shape[0] // E
            return self.tables[rank * tl:(rank + 1) * tl]
        return self.tables


def shard_tables(tables: torch.Tensor, cfg: EmbeddingBagConfig,
                 num_shards: int) -> ShardedTables:
    """Shard the stacked ``(T, R, D)`` tables over ``num_shards`` ranks per
    ``cfg.sharding`` -- the counterpart of ``table_pspec``.  Raises
    ``ValueError`` when the shard count does not divide R (row), D
    (column) or T (table), where the reference's ``shard_map`` fails.  Row
    and table shards are views; the column shards are one copy."""
    T, R, D = tables.shape
    E = num_shards
    if E < 1:
        raise ValueError(f"num_shards must be >= 1, got {E}")
    dims = {"row": ("R", R), "column": ("D", D), "table": ("T", T)}
    if cfg.sharding in dims:
        name, size = dims[cfg.sharding]
        if size % E:
            raise ValueError(
                f"{cfg.sharding}-wise sharding over {E} ranks needs {name} "
                f"({size}) divisible by {E}")
    tables = tables.contiguous()
    if cfg.sharding == "column":
        tables = tables.view(T, R, E, D // E).permute(2, 0, 1, 3) \
            .contiguous()
    return ShardedTables(cfg.sharding, E, tables)


def _rw_allgather(shards: ShardedTables, batch: JaggedBatch,
                  cfg: EmbeddingBagConfig, scatter_batch: bool
                  ) -> torch.Tensor:
    """Every rank pools the rows it owns of the replicated batch -- one
    fused TBE launch per rank over its shard, read in place -- then the
    partials are summed: one all-reduce -> (B, T, D), or with
    ``scatter_batch`` a reduce-scatter over the batch -> (E, B/E, T, D),
    rank r's pooled rows of its batch slice."""
    E = shards.num_shards
    T, R, D = shards.tables.shape
    rps = R // E
    parts = []
    for rank in range(E):
        part = kops.embedding_bag_rw_partial_batched(
            shards.shard(rank), rank * rps, batch.indices, batch.lengths,
            batch.weights, fused=cfg.fused)
        parts.append(part.transpose(0, 1))                   # (B, T, D)
    partial = torch.stack(parts)                             # (E, B, T, D)
    out_dtype = partial.dtype
    if cfg.rs_dtype != "float32":
        partial = partial.to(DTYPES[cfg.rs_dtype])
    if scatter_batch:
        B = partial.shape[1]
        if B % E:
            raise ValueError(f"scatter_batch needs the batch ({B}) "
                             f"divisible by {E} ranks")
        stacked = partial.reshape(E, E, B // E, T, D)
        return comm.reduce_scatter(
            stacked, backend=cfg.rw_backend,
            emulate_with_a2a=cfg.emulate_rs_with_a2a).to(out_dtype)
    return comm.all_reduce(partial, backend=cfg.rw_backend).to(out_dtype)


def _bucket_by_owner(flat_idx: torch.Tensor, flat_w: torch.Tensor,
                     flat_seg: torch.Tensor, num_shards: int, capacity: int,
                     rows_per_shard: int):
    """Phase-1 bucketing: fixed-capacity per-destination send buffers.

    ``(..., N)`` ids, weights and segment ids -> ``(..., E, C)`` send
    buffers and the ``(...)`` dropped counts.  As in the reference, the
    owner is ``clip(id // rows_per_shard, 0, E - 1)`` with floor division,
    so a padded slot (id -1, or id 0 with weight 0) counts against rank
    0's bucket: ``pos`` runs over every slot, live or not, and a live
    lookup past the capacity is dropped (weight 0) and counted.  A dropped
    or dead slot is written to slot ``size`` of a ``size + 1`` buffer and
    cut off."""
    E = num_shards
    dest = torch.div(flat_idx, rows_per_shard, rounding_mode="floor") \
        .clamp(0, E - 1).long()
    # stable within-destination position via cumulative one-hot counts,
    # taken along the innermost (contiguous) axis: a scan over an outer
    # axis of N runs with one thread per column on CUDA
    onehot = dest[..., None, :] == torch.arange(E, device=dest.device)[
        :, None]                                             # (..., E, N)
    pos = (onehot.cumsum(dim=-1) - 1).gather(-2, dest[..., None, :])[
        ..., 0, :]
    live = flat_w != 0.0
    keep = live & (pos < capacity)
    dropped = (live & (pos >= capacity)).sum(dim=-1)
    size = E * capacity
    slot = torch.where(keep, dest * capacity + pos, size)
    lead = tuple(flat_idx.shape[:-1])

    def put(values: torch.Tensor, fill) -> torch.Tensor:
        buf = torch.full(lead + (size + 1,), fill, dtype=values.dtype,
                         device=values.device)
        buf.scatter_(-1, slot, values)
        return buf[..., :size].contiguous().view(lead + (E, capacity))

    return put(flat_idx, 0), put(flat_w, 0.0), put(flat_seg, -1), dropped


def _rw_a2a(shards: ShardedTables, batch: JaggedBatch,
            cfg: EmbeddingBagConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper-faithful row-wise pipeline -> ((B, T, D) pooled, (E,)
    dropped lookups per rank).

    Each rank takes its own 1/E slice of the replicated batch (the paper's
    per-GPU mini-batch); phases 1-3 reassemble its pooled rows, and a tiled
    all-gather restores the whole batch.  Phase 1 (bucketing) runs batched
    over the rank axis, phase 2 once per rank over that rank's shard."""
    E = shards.num_shards
    tables = shards.tables
    T, R, D = tables.shape
    rps = R // E
    B, L = batch.batch_size, batch.max_pooling
    if B % E:
        raise ValueError(f"the a2a pipeline needs the batch ({B}) "
                         f"divisible by {E} ranks")
    Bl = B // E
    dev = tables.device

    def per_rank(x: torch.Tensor) -> torch.Tensor:
        """(T, B, L) -> (E, Bl, T, L): every rank's batch slice, in the
        reference's (b, t, l) flattening order."""
        return x.reshape(T, E, Bl, L).permute(1, 2, 0, 3)

    idx = per_rank(batch.indices.to(device=dev, dtype=torch.int32))
    eff_w = per_rank(batch.effective_weights().to(dev))      # (E, Bl, T, L)
    # segment id b * T + t and table id t of every slot, alike on all ranks
    b_ = torch.arange(Bl, device=dev, dtype=torch.int32)[:, None, None]
    t_ = torch.arange(T, device=dev, dtype=torch.int32)[None, :, None]
    seg = (b_ * T + t_).expand(Bl, T, L).reshape(-1)
    tab = t_.expand(Bl, T, L).reshape(-1)
    N = Bl * T * L
    capacity = min(max(1, int(N / E * cfg.capacity_factor)), N)

    # ---- phase 1: index permute (all-to-all) -------------------------------
    packed = idx.reshape(E, N) * T + tab          # (row, table) in one id
    send_p, send_w, send_seg, dropped = _bucket_by_owner(
        packed, eff_w.reshape(E, N), seg.expand(E, N), E, capacity,
        rps * T)                  # packed ids of one shard span rps * T
    recv_p = comm.all_to_all(send_p, backend=cfg.rw_backend)
    recv_w = comm.all_to_all(send_w, backend=cfg.rw_backend)
    recv_seg = comm.all_to_all(send_seg, backend=cfg.rw_backend)

    # ---- phase 2: local gather + pool (segment-sum), once per rank ---------
    flat = tables.view(T * R, D)
    origin = torch.arange(E, device=dev)[:, None].expand(E, capacity)
    partial = torch.empty((E, E, Bl * T, D), dtype=torch.float32,
                          device=dev)
    for rank in range(E):
        p, w = recv_p[rank], recv_w[rank]                    # (E, C)
        row = torch.div(p, T, rounding_mode="floor") - rank * rps
        valid = (w != 0.0) & (row >= 0) & (row < rps)
        # only the valid slots are gathered and summed: the reference adds
        # the others (weight 0) into a segment it then cuts off, which
        # would serialise the sort-based sum below on one hot segment
        live = valid.reshape(-1).nonzero().squeeze(1)
        row = row.reshape(-1)[live].long()
        tab = torch.remainder(p.reshape(-1)[live], T).long()
        # the shard's row (tab, row), addressed in place in the (T * R, D)
        # view of the stacked tables
        rows = flat[tab * R + rank * rps + row].to(torch.float32)
        contrib = rows * w.reshape(-1)[live][:, None]
        seg = origin.reshape(-1)[live] * (Bl * T) \
            + recv_seg[rank].reshape(-1)[live]
        # a sum in slot order per segment: index_put_ with accumulate
        # sorts stably on CUDA, and adds in order on the CPU
        sums = torch.zeros((E * Bl * T, D), dtype=torch.float32, device=dev)
        sums.index_put_((seg,), contrib, accumulate=True)
        partial[rank] = sums.view(E, Bl * T, D)

    # ---- phase 3: reduce-scatter back to the requesting rank ---------------
    if cfg.rs_dtype != "float32":
        partial = partial.to(DTYPES[cfg.rs_dtype])
    pooled = comm.reduce_scatter(
        partial, backend=cfg.rw_backend,
        emulate_with_a2a=cfg.emulate_rs_with_a2a).to(torch.float32)
    pooled = pooled.reshape(E, Bl, T, D).to(tables.dtype)
    if cfg.combiner == "mean":
        denom = eff_w.sum(dim=-1).clamp_min(1.0)[..., None]  # (E, Bl, T, 1)
        pooled = pooled / denom
    # restore the replicated batch (tiled all-gather)
    out = comm.all_gather(pooled, axis=0, tiled=True,
                          backend=cfg.rw_backend)            # (B, T, D)
    return out, dropped


def _cw(shards: ShardedTables, batch: JaggedBatch, cfg: EmbeddingBagConfig,
        keep_sharded: bool) -> torch.Tensor:
    """Every rank pools its column slice of the replicated batch: (E, B, T,
    D/E), or all-gathered along D -> (B, T, D)."""
    out = torch.stack([pooled_lookup_local(shards.shard(rank), batch, cfg)
                       for rank in range(shards.num_shards)])
    if keep_sharded:
        return out
    return comm.all_gather(out, axis=2, tiled=True)


def _tw(shards: ShardedTables, batch: JaggedBatch, cfg: EmbeddingBagConfig,
        keep_sharded: bool) -> torch.Tensor:
    """Every rank pools its T/E tables: (E, B, T/E, D), or all-gathered
    along the tables -> (B, T, D)."""
    E = shards.num_shards
    tl = cfg.num_tables // E
    sub_cfg = dataclasses.replace(cfg, num_tables=tl)
    outs = []
    for rank in range(E):
        sl = slice(rank * tl, (rank + 1) * tl)
        local = JaggedBatch(
            batch.indices[sl], batch.lengths[sl],
            None if batch.weights is None else batch.weights[sl])
        outs.append(pooled_lookup_local(shards.shard(rank), local, sub_cfg))
    out = torch.stack(outs)
    if keep_sharded:
        return out
    return comm.all_gather(out, axis=1, tiled=True)


def pooled_lookup_sharded(shards: ShardedTables, batch: JaggedBatch,
                          cfg: EmbeddingBagConfig, *,
                          scatter_batch: bool = False,
                          keep_sharded: bool = False) -> torch.Tensor:
    """Distributed pooled lookup over the simulated model axis; dispatches
    on ``cfg.sharding``.  Returns the (B, T, D) pooled embeddings every rank
    holds, or the per-rank results stacked on a leading rank axis when
    they stay sharded: ``scatter_batch`` (row, allgather) -> (E, B/E, T,
    D); ``keep_sharded`` -> (E, B, T, D/E) column, (E, B, T/E, D) table."""
    if shards.sharding != cfg.sharding:
        raise ValueError(f"tables sharded {shards.sharding!r}, config "
                         f"{cfg.sharding!r}")
    if cfg.sharding == "replicated":
        return pooled_lookup_local(shards.tables, batch, cfg)
    if cfg.sharding == "row":
        if cfg.rw_impl == "a2a":
            return _rw_a2a(shards, batch, cfg)[0]
        return _rw_allgather(shards, batch, cfg, scatter_batch)
    if cfg.sharding == "column":
        return _cw(shards, batch, cfg, keep_sharded)
    return _tw(shards, batch, cfg, keep_sharded)


def pooled_lookup_rw_a2a_with_stats(shards: ShardedTables,
                                    batch: JaggedBatch,
                                    cfg: EmbeddingBagConfig
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper-faithful row-wise pipeline, also returning the (E,)
    dropped-lookup counts, one per requesting rank."""
    if shards.sharding != "row":
        raise ValueError(f"the a2a pipeline runs over row shards, got "
                         f"{shards.sharding!r}")
    return _rw_a2a(shards, batch, cfg)


# ---------------------------------------------------------------------------
# Hot-row replication
# ---------------------------------------------------------------------------

def extract_hot_table(tables: torch.Tensor,
                      cfg: EmbeddingBagConfig) -> torch.Tensor:
    """(T, R, D) full tables -> the (T, hot_rows, D) replica of the hot
    rows, one copy made at load time."""
    return tables[:, :cfg.hot_rows].contiguous()


def pooled_lookup_hot(shards: ShardedTables, hot_table: torch.Tensor,
                      batch: JaggedBatch,
                      cfg: EmbeddingBagConfig) -> torch.Tensor:
    """Sharded pooled lookup with a replicated-hot short-circuit: lookups
    with id < ``cfg.hot_rows`` are pooled from the local replica and carry
    zero weight into the distributed pipeline.  Both partitions pool with
    ``sum``; ``mean`` divides their sum by the whole batch's
    denominators."""
    if cfg.combiner not in ("sum", "mean"):
        raise NotImplementedError(
            f"pooled_lookup_hot: combiner {cfg.combiner!r} is not supported"
            f" -- the hot/cold split needs an additive pooling")
    sum_cfg = dataclasses.replace(cfg, combiner="sum")
    hot = cfg.hot_rows
    eff = batch.effective_weights()                          # (T, B, L)
    is_hot = (batch.indices < hot).to(torch.float32)
    w_hot = eff * is_hot
    w_cold = eff * (1.0 - is_hot)
    safe = batch.indices.clamp(0, hot - 1)
    hot_out = kops.embedding_bag_batched(
        hot_table, safe, None, w_hot, fused=cfg.fused).transpose(0, 1)
    cold_batch = JaggedBatch(batch.indices, batch.lengths, w_cold)
    cold_out = pooled_lookup_sharded(shards, cold_batch, sum_cfg)
    out = hot_out.to(torch.float32) + cold_out.to(torch.float32)
    if cfg.combiner == "mean":
        out = out / eff.sum(dim=2).clamp_min(1.0).transpose(0, 1)[..., None]
    return out.to(shards.dtype)


def make_cache(tables: torch.Tensor, cfg: EmbeddingBagConfig, *,
               device=None):
    """Build the tiered cache for ``cfg.cache`` on ``device`` (None: the
    card): a flat slot pool there over the cold tier ``cfg.cache`` names."""
    from repro_torch.cache.cached_bag import CachedEmbeddingBag  # cache -> core

    return CachedEmbeddingBag(tables, cfg, device=device)


def pooled_lookup_cached(cache, batch: JaggedBatch) -> torch.Tensor:
    """(cache, JaggedBatch) -> (B, T, D): prefetch misses, then ONE fused
    TBE launch over the slot pool; bitwise-equal to
    :func:`pooled_lookup_local` over the full tables."""
    return cache.lookup(batch)


# ---------------------------------------------------------------------------
# Kernel contracts (audited by repro_torch.analysis)
# ---------------------------------------------------------------------------

KERNEL_CONTRACTS = {
    "pooled_lookup_local": KernelContract(
        name="core.embedding_bag.pooled_lookup_local",
        note="replicated-table lookup (2-D flat pool or 3-D stacked) "
             "stays ONE fused TBE launch regardless of layout"),
}
