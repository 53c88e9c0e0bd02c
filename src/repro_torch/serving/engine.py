"""DLRM CTR scoring engine -- the port's serving entry point.

The counterpart of ``DLRMEngine`` in ``repro.serving.engine``: requests
queue up, ``flush`` pads up to ``batch_size`` of them to fixed shapes and
runs one forward whose embedding pooling is one fused TBE kernel launch
for all tables (``cfg.fused``).  With ``cfg.cache.enabled`` the tables live
behind the tiered cache: ``flush`` first prefetches the micro-batch's
working set into the device slot pool, and a micro-batch whose working set
overflows the pool is split in half until it fits.  With a
``ParallelContext`` the pooling runs the distributed embedding bag over the
context's simulated model axis; the engine shards the tables once, at
construction.

Float32 products run in full float32 on the card (TF32 off), as in the
reference.  The pipelined engine (``pipeline_depth >= 2``) and telemetry
come with later slices of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cache.manager import CacheCapacityError
from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.core.embedding_bag import make_cache, shard_tables
from repro_torch.core.jagged import JaggedBatch
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class CTRRequest:
    """One scoring request: dense features + per-table sparse lookups."""
    rid: int
    dense: np.ndarray          # (num_dense_features,)
    indices: np.ndarray        # (T, L) table-local row ids (padded)
    lengths: np.ndarray        # (T,) valid lookups per table


class DLRMEngine:
    """Micro-batching CTR inference over the DLRM forward on ``device``
    (None: the card; the parameters must live there), distributed over
    ``ctx``'s simulated model axis when one is given."""

    def __init__(self, params, cfg: DLRMConfig, batch_size: int,
                 ctx: Optional[ParallelContext] = None, *, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full-fp32 MLP products, like the reference's
            torch.backends.cuda.matmul.allow_tf32 = False
        on = params["bottom"][0]["w"].device
        if on.type != self.device.type:
            raise ValueError(f"parameters are on {on}, the engine on "
                             f"{self.device}")
        self.params, self.cfg, self.ctx = params, cfg, ctx
        self.batch_size = batch_size
        self.queue: List[CTRRequest] = []
        self.cache = None
        if cfg.cache.enabled and ctx is not None:
            raise NotImplementedError(
                "DLRMEngine: the tiered cache path scores on a single "
                "serving device (an enabled cfg.cache with a "
                "ParallelContext is not supported) -- a cluster-wide cold "
                "tier is cache.cold_tier='remote'")
        if ctx is not None:
            # the sharded tables, built once: row and table shards are
            # views of params["tables"], column shards one copy
            self.params = {**params, "tables": shard_tables(
                params["tables"], cfg.embedding_config(), ctx.tp_size)}
        if cfg.cache.enabled:
            slots = (cfg.cache.rows_per_table
                     if cfg.cache.rows_per_table is not None
                     else (cfg.cache.rows,))
            if min(slots) < cfg.pooling:
                raise ValueError(
                    f"cache rows ({min(slots)}) must be >= pooling "
                    f"({cfg.pooling}) so a single request's working set "
                    f"always fits the slot pool (CacheConfig.rows)")
            self.cache = make_cache(params["tables"], cfg.embedding_config(),
                                    device=self.device)
            # the cold tier now lives inside the cache (host memory, or the
            # remote tier's row shards): serving keeps no full tables
            self.params = {**params, "tables": None}

    def submit(self, req: CTRRequest) -> None:
        T = self.cfg.num_sparse_features
        L = self.cfg.pooling
        F = self.cfg.num_dense_features
        # validate every field here: flush() takes requests off the queue
        # only after scoring, but a bad one would fail its whole micro-batch
        if (req.dense.shape != (F,) or req.indices.shape != (T, L)
                or req.lengths.shape != (T,)):
            raise ValueError(
                f"request {req.rid}: want dense ({F},) / indices ({T}, {L})"
                f" / lengths ({T},), got {req.dense.shape} / "
                f"{req.indices.shape} / {req.lengths.shape}")
        if not np.issubdtype(req.indices.dtype, np.integer):
            raise TypeError(
                f"request {req.rid}: indices must be an integer dtype, "
                f"got {req.indices.dtype}")
        if not np.issubdtype(req.lengths.dtype, np.integer):
            raise TypeError(
                f"request {req.rid}: lengths must be an integer dtype, "
                f"got {req.lengths.dtype}")
        if not np.issubdtype(req.dense.dtype, np.floating):
            raise TypeError(
                f"request {req.rid}: dense must be a float dtype, "
                f"got {req.dense.dtype}")
        # value ranges, within-length slots only: padding beyond lengths
        # is arbitrary (sentinels like -1 are masked downstream)
        if req.lengths.size and (req.lengths.min() < 0
                                 or req.lengths.max() > L):
            raise ValueError(
                f"request {req.rid}: lengths must be in [0, {L}]")
        R = self.cfg.rows_per_table
        live = req.indices[np.arange(L) < req.lengths[:, None]]
        if live.size and (live.min() < 0 or live.max() >= R):
            raise ValueError(
                f"request {req.rid}: indices must be in [0, {R})")
        self.queue.append(req)

    def _pad_batch(self, todo: List[CTRRequest]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pad ``todo`` to the engine's fixed shapes: (B, F) dense,
        (T, B, L) indices, (T, B) lengths -- tail slots stay all-masked."""
        B = self.batch_size
        T, L = self.cfg.num_sparse_features, self.cfg.pooling
        F = self.cfg.num_dense_features
        dense = np.zeros((B, F), np.float32)
        idx = np.zeros((T, B, L), np.int32)
        lens = np.zeros((T, B), np.int32)
        for i, req in enumerate(todo):
            dense[i] = req.dense
            idx[:, i, :] = req.indices
            lens[:, i] = req.lengths
        return dense, idx, lens

    def flush(self) -> Dict[int, float]:
        """Score up to ``batch_size`` queued requests; returns rid -> pCTR."""
        if not self.queue:
            return {}
        # peek, don't pop: the cached path's prefetch can refuse the batch
        # (working set over the slot pool) and the requests must survive
        todo = self.queue[: self.batch_size]
        while True:
            dense, idx, lens = self._pad_batch(todo)
            params = self.params
            if self.cache is not None:
                # prefetch-at-flush: pin this micro-batch's rows in the slot
                # pool and score against the pool (ids become slot ids); a
                # refused working set splits the micro-batch -- a single
                # request always fits (cache rows >= pooling)
                try:
                    idx = self.cache.prefetch_arrays(idx, lens)
                except CacheCapacityError:
                    if len(todo) == 1:
                        raise
                    todo = todo[: len(todo) // 2]
                    continue
                params = {**self.params, "tables": self.cache.pool}
            break
        batch = JaggedBatch(
            indices=torch.as_tensor(idx, device=self.device),
            lengths=torch.as_tensor(lens, device=self.device))
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = dlrm_mod.forward(
                params, torch.as_tensor(dense, device=self.device), batch,
                self.cfg, self.ctx)
            p = torch.sigmoid(logits).cpu().numpy()
        if self.cache is not None:
            self.cache.stats.add_time("forward", time.perf_counter() - t0)
        self.queue = self.queue[len(todo):]
        return {req.rid: float(p[i]) for i, req in enumerate(todo)}

    def cache_stats(self):
        """The tiered cache's CacheStats (None when the cache is off)."""
        return None if self.cache is None else self.cache.stats

    def run_to_completion(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        while self.queue:
            out.update(self.flush())
        return out


def make_dlrm_engine(params, cfg: DLRMConfig, batch_size: int,
                     ctx: Optional[ParallelContext] = None, *,
                     device=None) -> DLRMEngine:
    """Build the engine ``cfg.cache.pipeline_depth`` selects: 1 is the
    serialized :class:`DLRMEngine`; the pipelined engine (>= 2) is not
    ported yet and raises."""
    if cfg.cache.pipeline_depth > 1:
        raise NotImplementedError(
            f"pipeline_depth={cfg.cache.pipeline_depth}: the pipelined "
            f"engine is not ported yet (ROADMAP, Queue 1, pipelined "
            f"serving); use pipeline_depth=1")
    return DLRMEngine(params, cfg, batch_size, ctx, device=device)
