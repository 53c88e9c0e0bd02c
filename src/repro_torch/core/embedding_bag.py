"""The single-device embedding bag: config, tables, pooled lookups.

The counterpart of the local path of ``repro.core.embedding_bag``:
``pooled_lookup_local`` runs every table through ONE fused TBE launch
(``cfg.fused``), over the stacked ``(T, R, D)`` tables or over the tiered
cache's flat ``(sum S_t, D)`` slot pool.  The sharded strategies (row,
column, table-wise) come with the distributed slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.cache_config import CacheConfig
from repro_torch.core.jagged import JaggedBatch
from repro_torch.kernels import ops as kops
from repro_torch.utils.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class EmbeddingBagConfig:
    num_tables: int
    rows_per_table: int
    dim: int
    combiner: str = "sum"            # sum | mean
    dtype: str = "float32"           # float32 | bfloat16
    # fused: ONE TBE launch for all T tables; False launches the
    # single-table kernel T times (the #tables baseline)
    fused: bool = True
    # the tiered cache's knobs; always a CacheConfig after construction
    cache: Optional[CacheConfig] = None

    def __post_init__(self):
        if self.cache is None:
            object.__setattr__(self, "cache", CacheConfig())
        if self.dtype not in DTYPES:
            raise ValueError(
                f"dtype must be one of {tuple(DTYPES)}, got {self.dtype!r}")

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


def pooled_lookup_local(tables: torch.Tensor, batch: JaggedBatch,
                        cfg: EmbeddingBagConfig) -> torch.Tensor:
    """Tables x JaggedBatch -> (B, T, D), no communication.

    ``tables`` is the stacked ``(T, R, D)`` tensor (ids are row ids) or the
    tiered cache's FLAT ``(sum S_t, D)`` slot pool (ids are table-local
    slot ids); the 2-D case takes its per-table offsets from ``cfg.cache``,
    the geometry the slot pool was sized with.  A flat pool is always one
    fused launch; stacked tables follow ``cfg.fused``."""
    if tables.dim() == 2:
        offsets = cfg.cache.slot_offsets(cfg.num_tables,
                                         cfg.rows_per_table)[:-1]
        out = kops.embedding_bag_batched_flat(
            tables, torch.as_tensor(offsets, dtype=torch.int32,
                                    device=tables.device),
            batch.indices, batch.lengths, batch.weights,
            combiner=cfg.combiner)
    else:
        out = kops.embedding_bag_batched(
            tables, batch.indices, batch.lengths, batch.weights,
            combiner=cfg.combiner, fused=cfg.fused)
    return out.transpose(0, 1)                               # (B, T, D)


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
