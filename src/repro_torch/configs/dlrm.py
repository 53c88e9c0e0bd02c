"""DLRM -- the paper's model configuration (Fig. 2 canonical architecture).

The counterpart of ``repro.configs.dlrm``: 13 dense features -> bottom MLP
(512, 256, 128); 26 sparse features -> 26 embedding tables of 1,000,000
rows x 128; dot-product feature interaction; top MLP (1024, 1024, 512,
256, 1).  ``CONFIG`` is the full-width inference configuration,
``smoke()`` the CPU test size.
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

    def __post_init__(self):
        if self.bottom_mlp[-1] != self.embedding_dim:
            raise ValueError(
                f"dot interaction needs bottom_mlp[-1] "
                f"({self.bottom_mlp[-1]}) == embedding_dim "
                f"({self.embedding_dim})")
        if self.cache is None:
            object.__setattr__(self, "cache", CacheConfig())

    def embedding_config(self) -> EmbeddingBagConfig:
        return EmbeddingBagConfig(
            num_tables=self.num_sparse_features,
            rows_per_table=self.rows_per_table,
            dim=self.embedding_dim,
            sharding=self.sharding,
            rw_impl=self.rw_impl,
            rw_backend=self.rw_backend,
            dtype=self.dtype,
            fused=self.fused,
            cache=self.cache,
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
