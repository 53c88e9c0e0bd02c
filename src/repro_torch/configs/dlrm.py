"""DLRM -- the paper's model configuration (Fig. 2 canonical architecture).

The counterpart of ``repro.configs.dlrm``: 13 dense features -> bottom MLP
(512, 256, 128); 26 sparse features -> 26 embedding tables of 1,000,000
rows x 128; dot-product feature interaction; top MLP (1024, 1024, 512,
256, 1).  ``CONFIG`` is the full-width inference configuration,
``smoke()`` the CPU test size.  ``sharding_plan`` carries a planner's
per-table slot pools into the engines, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.cache_config import CacheConfig
from repro_torch.core.embedding_bag import EmbeddingBagConfig


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    num_dense_features: int = 13
    num_sparse_features: int = 26        # == number of embedding tables
    embedding_dim: int = 128
    rows_per_table: int = 1_000_000
    pooling: int = 32                    # max lookups per table per sample
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    # the distributed embedding bag, with a ParallelContext
    sharding: str = "row"                # row | column | table | replicated
    rw_impl: str = "allgather"           # allgather | a2a (paper-faithful)
    rw_backend: str = "bulk"             # bulk | onesided
    dtype: str = "float32"
    fused: bool = True                   # ONE TBE launch for all tables
    cache: Optional[CacheConfig] = None  # tiered cache; CacheConfig() = off
    # planner -> engine round trip: a core.sharding_plan.ShardingPlan whose
    # "cached" placements size HETEROGENEOUS slot pools (one flat
    # (sum S_t, D) device pool; capacity and eviction per table).
    # Placements map to tables by POSITION (Placement.index), never by
    # name.  Tables the planner did not price as "cached" fall back to
    # cache.rows (or to pooling when cache.rows == 0).  Data, not
    # architecture: excluded from equality and hashing.
    sharding_plan: object = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.bottom_mlp[-1] != self.embedding_dim:
            raise ValueError(
                f"dot interaction needs bottom_mlp[-1] "
                f"({self.bottom_mlp[-1]}) == embedding_dim "
                f"({self.embedding_dim})")
        if self.cache is None:
            object.__setattr__(self, "cache", CacheConfig())

    def cache_rows_vector(self) -> Optional[Tuple[int, ...]]:
        """Per-table slot counts the tiered store should use, or None
        when no plan is attached (the uniform ``cache.rows`` path)."""
        if self.sharding_plan is None:
            return None
        fallback = self.cache.rows if self.cache.rows > 0 else self.pooling
        return tuple(self.sharding_plan.cache_rows_vector(
            self.num_sparse_features, default=fallback))

    def embedding_config(self) -> EmbeddingBagConfig:
        """The embedding bag's config; a plan's slot vector is folded into
        ``cache.rows_per_table``."""
        cache = self.cache
        per_table = self.cache_rows_vector()
        if per_table is not None:
            cache = dataclasses.replace(cache, rows_per_table=per_table)
        return EmbeddingBagConfig(
            num_tables=self.num_sparse_features,
            rows_per_table=self.rows_per_table,
            dim=self.embedding_dim,
            sharding=self.sharding,
            rw_impl=self.rw_impl,
            rw_backend=self.rw_backend,
            dtype=self.dtype,
            fused=self.fused,
            cache=cache,
        )

    @property
    def interaction_dim(self) -> int:
        """Width of the dot interaction: the bottom-MLP vector plus one
        product per pair of the T + 1 feature vectors."""
        n = self.num_sparse_features + 1
        return self.bottom_mlp[-1] + n * (n - 1) // 2


CONFIG = DLRMConfig()


def smoke() -> DLRMConfig:
    return DLRMConfig(
        num_dense_features=4,
        num_sparse_features=8,
        embedding_dim=16,
        rows_per_table=128,
        pooling=4,
        bottom_mlp=(32, 16),
        top_mlp=(64, 32, 1),
    )
