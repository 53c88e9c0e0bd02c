"""Audit fixtures for every attached kernel contract.

The counterpart of ``repro.analysis.fixtures``: one small setup per
contract in the port's ``KERNEL_CONTRACTS`` registries, at the
reference's shapes (the repo's smoke shapes), run on ``device`` -- the
CPU, where each kernel wrapper takes its plain version, or the card,
where it launches its kernel.  The reference traces ShapeDtypeStructs;
the port runs each fixture once on random inputs from a fixed seed.

Each fixture mirrors the call site it guards, so a regression that adds a
launch, a collective, a host transfer or an out-of-place scatter fails
here the way it would fail in serving.  ``device_kernel`` (the card
only) also counts the TBE kernel's device events in a profile.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.analysis.contracts import AuditReport, audit


def _gen(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _ids(g, hi, shape, device) -> torch.Tensor:
    return torch.randint(0, hi, shape, generator=g, device=device,
                         dtype=torch.int32)


def audit_tbe_fused(device="cpu", device_kernel=None) -> AuditReport:
    from repro_torch.kernels import ops as kops

    T, R, D, B, L = 4, 64, 16, 8, 4
    g = _gen(device)
    args = (torch.randn((T, R, D), generator=g, device=device),
            _ids(g, R, (T, B, L), device),
            torch.rand((T, B, L), generator=g, device=device))
    return audit(
        lambda t, i, w: kops.embedding_bag_batched(t, i, None, w,
                                                   fused=True),
        args, kops.KERNEL_CONTRACTS["tbe_fused"],
        device_kernel=device_kernel)


def audit_tbe_flat(device="cpu", device_kernel=None) -> AuditReport:
    from repro_torch.kernels import ops as kops

    T, D, B, L, S = 4, 16, 8, 4, 32
    g = _gen(device)
    args = (torch.randn((T * S, D), generator=g, device=device),
            torch.arange(T, dtype=torch.int32, device=device) * S,
            _ids(g, S, (T, B, L), device),
            torch.rand((T, B, L), generator=g, device=device))
    return audit(
        lambda p, o, i, w: kops.embedding_bag_batched_flat(p, o, i, None,
                                                           w),
        args, kops.KERNEL_CONTRACTS["tbe_flat"],
        device_kernel=device_kernel)


def audit_rw_partial_fused(device="cpu", device_kernel=None) -> AuditReport:
    from repro_torch.kernels import ops as kops

    T, R_shard, D, B, L = 4, 8, 16, 8, 4
    g = _gen(device)
    args = (torch.randn((T, R_shard, D), generator=g, device=device),
            _ids(g, 4 * R_shard, (T, B, L), device))
    return audit(
        lambda t, i: kops.embedding_bag_rw_partial_batched(t, 0, i,
                                                           fused=True),
        args, kops.KERNEL_CONTRACTS["rw_partial_fused"],
        device_kernel=device_kernel)


def audit_cached_device_lookup(device="cpu",
                               device_kernel=None) -> AuditReport:
    from repro_torch.cache import cached_bag
    from repro_torch.cache.cached_bag import CachedEmbeddingBag
    from repro_torch.core.cache_config import CacheConfig
    from repro_torch.core.embedding_bag import EmbeddingBagConfig

    T, D, S, R = 4, 16, 32, 128
    cfg = EmbeddingBagConfig(num_tables=T, rows_per_table=R, dim=D,
                             cache=CacheConfig(rows=S))
    bag = CachedEmbeddingBag(torch.zeros((T, R, D)), cfg, device=device)
    g = _gen(device)
    args = (bag.pool, _ids(g, S, (T, 8, 4), device),
            torch.rand((T, 8, 4), generator=g, device=device))
    return audit(
        lambda p, i, w: bag.device_lookup(p, i, None, w),
        args, cached_bag.KERNEL_CONTRACTS["device_lookup"],
        device_kernel=device_kernel)


def audit_pooled_lookup_local(device="cpu",
                              device_kernel=None) -> AuditReport:
    from repro_torch.core import embedding_bag as eb
    from repro_torch.core.jagged import JaggedBatch

    T, R, D, B, L = 4, 64, 16, 8, 4
    cfg = eb.EmbeddingBagConfig(num_tables=T, rows_per_table=R, dim=D)
    g = _gen(device)
    args = (torch.randn((T, R, D), generator=g, device=device),
            _ids(g, R, (T, B, L), device),
            _ids(g, L + 1, (T, B), device))
    return audit(
        lambda t, i, ln: eb.pooled_lookup_local(
            t, JaggedBatch(indices=i, lengths=ln), cfg),
        args, eb.KERNEL_CONTRACTS["pooled_lookup_local"],
        device_kernel=device_kernel)


def audit_scatter_rows(device="cpu", device_kernel=None) -> AuditReport:
    """The slot-pool scatter in place.  On the card the pool is larger
    than the reference's 64 rows, so that its size stands well clear of
    the allocator's 512-byte rounding of the small operands."""
    from repro_torch.cache import tiers

    S = 64 if torch.device(device).type == "cpu" else 8192
    D, M = 16, 8
    g = _gen(device)
    args = (torch.zeros((S, D), device=device),
            torch.randperm(S, generator=g, device=device)[:M],
            torch.randn((M, D), generator=g, device=device))
    return audit(tiers._scatter_rows, args,
                 tiers.KERNEL_CONTRACTS["scatter_rows"],
                 device_kernel=device_kernel)


def audit_tiered_forward(device="cpu", device_kernel=None) -> AuditReport:
    """The serving program over the flat slot pool: DLRM forward +
    sigmoid.  A pool geometry's slot offsets reach the card on its first
    forward and stay there (``core.embedding_bag._pool_offsets``), as the
    cached bag's do at construction, so the fixture serves one batch
    before the audited one: the contract is the steady state."""
    from repro_torch.configs import dlrm as dlrm_cfg
    from repro_torch.core.cache_config import CacheConfig
    from repro_torch.core.jagged import JaggedBatch
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.serving import engine

    cache_rows, batch = 32, 8
    cfg = dataclasses.replace(dlrm_cfg.smoke(),
                              cache=CacheConfig(rows=cache_rows))
    T, D, L = cfg.num_sparse_features, cfg.embedding_dim, cfg.pooling
    g = _gen(device)
    params = dlrm_mod.init_params(g, cfg, device=device)
    params["tables"] = torch.randn((T * cache_rows, D), generator=g,
                                   device=device)
    args = (params,
            torch.randn((batch, cfg.num_dense_features), generator=g,
                        device=device),
            JaggedBatch(_ids(g, cache_rows, (T, batch, L), device),
                        _ids(g, L + 1, (T, batch), device)))

    def serve(p, d, b):
        with torch.no_grad():
            return torch.sigmoid(dlrm_mod.forward(p, d, b, cfg, None))

    serve(*args)
    return audit(serve, args, engine.KERNEL_CONTRACTS["tiered_forward"],
                 device_kernel=device_kernel)


ALL_FIXTURES = (
    audit_tbe_fused,
    audit_tbe_flat,
    audit_rw_partial_fused,
    audit_cached_device_lookup,
    audit_pooled_lookup_local,
    audit_scatter_rows,
    audit_tiered_forward,
)


def run_all(device="cpu",
            device_kernel: Optional[str] = None) -> List[AuditReport]:
    """Audit every attached contract against its fixture on ``device``;
    ``device_kernel`` (the card only) adds the profiler's count of that
    device kernel to every audit."""
    return [fixture(device, device_kernel) for fixture in ALL_FIXTURES]
