"""Batched inference engines: the port's serving entry points.

LM serving (the counterpart of ``repro.serving.engine``'s LM half):
``generate`` is the simple API (one batch of prompts, greedy or
temperature sampling); ``ContinuousBatcher`` is the serving loop, a fixed
pool of cache slots at possibly different lengths.  Finished sequences
are evicted and queued requests admitted into free slots; one
``decode_step`` advances every slot.  Admission prefills the request
alone and writes its K/V straight into its slot of the shared cache (the
reference splices a separately prefilled, zero-padded cache); positions
past a slot's length hold stale rows, which decode attention masks.

DLRM CTR scoring: ``DLRMEngine``: requests queue up, ``flush`` pads up to
``batch_size`` of them to fixed shapes and runs one forward whose
embedding pooling is one fused TBE kernel launch for all tables
(``cfg.fused``).  With ``cfg.cache.enabled`` the tables live behind the
tiered cache: ``flush`` first prefetches the micro-batch's working set
into the device slot pool, and a micro-batch whose working set overflows
the pool is split in half until it fits.  With a ``ParallelContext`` the
pooling runs the distributed embedding bag over the context's simulated
model axis; the engine shards the tables once, at construction.

``PipelinedDLRMEngine`` (``cfg.cache.pipeline_depth >= 2``) serves the
same requests as a software pipeline over a ring of slot pools
(``repro_torch.pipeline``): the next micro-batch's admission, cold fetch,
scatter and operand staging run on a worker thread, on a side CUDA stream
on the card, while the current micro-batch's forward runs on the main
stream; events order the two streams.  Its scores are bitwise equal to
``DLRMEngine``'s.

Float32 products run in full float32 on the card (TF32 off), as in the
reference.  Telemetry comes with a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cache.manager import CacheCapacityError
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.core.embedding_bag import make_cache, shard_tables
from repro_torch.core.jagged import JaggedBatch
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import decode as dec
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import lm
from repro_torch.pipeline import (DoubleBufferedSlotPool, PipelineScheduler,
                                  PipelineTrace)
from repro_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------

def _mask_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """-inf on the padded vocabulary rows past ``vocab_size``."""
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
    return logits.masked_fill(pad, -torch.inf)


def _sample(logits: torch.Tensor, gen: Optional[torch.Generator],
            temperature: float) -> torch.Tensor:
    """Greedy at temperature 0, else one draw per row from ``gen``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def generate(params, cfg: ModelConfig, prompts, max_new: int, ctx=None, *,
             temperature: float = 0.0, seed: int = 0,
             device=None) -> torch.Tensor:
    """prompts (B, S) -> (B, max_new) generated ids (greedy by default) on
    ``device`` (None: the card; the parameters must live there)."""
    device = resolve_device(device)
    prompts = torch.as_tensor(prompts, device=device)
    B, S = prompts.shape
    gen = torch.Generator(device=device).manual_seed(seed)
    cache, hidden = dec.prefill(params, prompts, cfg, ctx,
                                max_len=S + max_new)
    logits = lm.lm_logits(params, hidden[:, -1:], cfg, ctx)[:, 0]
    tok = _sample(_mask_vocab(logits, cfg.vocab_size), gen, temperature)
    outs = [tok]
    for _ in range(max_new - 1):
        cache, h = dec.decode_step(params, cache, tok, cfg, ctx)
        lg = lm.lm_logits(params, h[:, None], cfg, ctx)[:, 0]
        tok = _sample(_mask_vocab(lg, cfg.vocab_size), gen, temperature)
        outs.append(tok)
    return torch.stack(outs, dim=1)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)


class ContinuousBatcher:
    """Slot-based continuous batching over one decode_step per step, on
    ``device`` (None: the card; the parameters must live there).

    The batch dimension of the shared cache is the slot pool.  Admission
    prefills the request alone, writing its K/V into its slot in place;
    eviction zeroes the slot's length.  One decode_step advances every
    slot, empty ones included, as in the reference.  ``timings`` keeps,
    on the host clock, each admission's ``(prompt length, seconds)`` and
    each decode step's seconds, both up to the token on the host."""

    def __init__(self, params, cfg: ModelConfig, num_slots: int,
                 max_len: int, ctx=None, eos_id: int = 1, *, device=None):
        lm._require_local(ctx)
        self.device = resolve_device(device)
        on = params["embed"].device
        if on.type != self.device.type:
            raise ValueError(f"parameters are on {on}, the batcher on "
                             f"{self.device}")
        self.params, self.cfg, self.ctx = params, cfg, ctx
        self.num_slots, self.max_len, self.eos = num_slots, max_len, eos_id
        self.cache = dec.init_cache(cfg, num_slots, max_len,
                                    dtype=params["embed"].dtype,
                                    device=self.device)
        self.slots: List[Optional[Request]] = [None] * num_slots
        self.tokens = torch.zeros((num_slots,), dtype=torch.int32,
                                  device=self.device)
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self.timings: Dict[str, list] = {"prefill": [], "decode": []}

    def submit(self, req: Request) -> None:
        n = len(req.prompt)
        if not 0 < n <= self.max_len:
            raise ValueError(f"request {req.rid}: prompt of {n} tokens, "
                             f"the slots hold 1 to {self.max_len}")
        self.queue.append(req)

    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        return lm.lm_logits(self.params, hidden[:, None], self.cfg)[:, 0]

    # -- internal ----------------------------------------------------------
    def _admit(self) -> None:
        for i in range(self.num_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                t0 = time.perf_counter()
                prompt = torch.as_tensor(req.prompt[None, :],
                                         device=self.device)
                kv = {k: v[:, i:i + 1]
                      for k, v in self.cache["blocks"].items()}
                hidden = dec._prefill_into(self.params, prompt, self.cfg, kv)
                self.cache["length"][i] = prompt.shape[1]
                lg = self._head(hidden[:, -1])
                first = int(torch.argmax(lg[0, : self.cfg.vocab_size]))
                self.timings["prefill"].append(
                    (prompt.shape[1], time.perf_counter() - t0))
                req.generated.append(first)
                self.tokens[i] = first
                self.slots[i] = req

    def _evict(self) -> None:
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if (len(req.generated) >= req.max_new or
                    (req.generated and req.generated[-1] == self.eos)):
                self.done[req.rid] = req
                self.slots[i] = None
                self.cache["length"][i] = 0

    def step(self) -> bool:
        """Admit, decode one token for all slots, evict finished."""
        self._admit()
        if not any(s is not None for s in self.slots):
            return False
        t0 = time.perf_counter()
        self.cache, hidden = dec.decode_step(self.params, self.cache,
                                             self.tokens, self.cfg)
        logits = _mask_vocab(self._head(hidden), self.cfg.vocab_size)
        self.tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        host = self.tokens.cpu().numpy()
        self.timings["decode"].append(time.perf_counter() - t0)
        for i, req in enumerate(self.slots):
            if req is not None:
                req.generated.append(int(host[i]))
        self._evict()
        return True

    def run_to_completion(self, max_steps: int = 10_000) -> Dict[int, Request]:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return self.done


# ---------------------------------------------------------------------------
# DLRM CTR scoring engine (fused-TBE consumer)
# ---------------------------------------------------------------------------

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
            self.cache = self._make_cache(params["tables"],
                                          cfg.embedding_config())
            # the cold tier now lives inside the cache (host memory, or the
            # remote tier's row shards): serving keeps no full tables
            self.params = {**params, "tables": None}

    def _make_cache(self, tables: torch.Tensor, ecfg):
        """The tiered cache over ``tables`` on the engine's device; the
        pipelined engine builds its ring of slot pools here instead."""
        return make_cache(tables, ecfg, device=self.device)

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


class PipelinedDLRMEngine(DLRMEngine):
    """DLRM scoring as a software pipeline over double-buffered pools.

    ``run_to_completion`` carves the queue into micro-batches and drives
    the ``admit -> fetch -> scatter -> forward -> swap`` scheduler
    (``repro_torch.pipeline``): batch k+1's cold fetch and pool scatter
    target the shadow buffer while batch k's fused-TBE forward reads the
    live one.  On the card the prefetch stages run on the scheduler's side
    stream and the forward on the caller's current stream, ordered by
    events.  Scores are BITWISE equal to the serialized
    :class:`DLRMEngine`'s: only the latency structure changes.

    ``flush`` stays the SERIALIZED path against the live buffer: it is
    both the one-micro-batch API and the pipeline's head-of-line fallback
    (a batch whose working set overflows the shadow buffer takes the
    inherited split-on-``CacheCapacityError`` loop).

    ``self.trace`` holds every stage's wall-clock span; the shared
    ``cache_stats()`` record carries the same prefetch/scatter/forward
    timers as the serialized engine's, plus the measured ``overlap_s``.
    """

    def __init__(self, params, cfg: DLRMConfig, batch_size: int,
                 ctx: Optional[ParallelContext] = None, *, device=None):
        if cfg.cache.pipeline_depth < 2:
            raise ValueError(
                f"PipelinedDLRMEngine needs pipeline_depth >= 2 (got "
                f"{cfg.cache.pipeline_depth}); depth 1 is the serialized "
                f"DLRMEngine -- use make_dlrm_engine to pick by config")
        if not cfg.cache.enabled:
            raise ValueError(
                "PipelinedDLRMEngine requires the tiered cache (an enabled "
                "cfg.cache: CacheConfig.rows > 0, formerly cache_rows): with "
                "fully device-resident tables there is no prefetch stage to "
                "overlap; a cfg.sharding_plan, the reference's other way "
                "in, is not ported yet (ROADMAP, Queue 1 item 8)")
        super().__init__(params, cfg, batch_size, ctx, device=device)
        self.trace = PipelineTrace(label="dlrm_pipelined")
        self.scheduler = PipelineScheduler(
            self.cache, forward=self._pipeline_forward,
            collect=self._pipeline_collect, fallback=self._pipeline_fallback,
            prestage=self._pipeline_prestage, trace=self.trace)

    def _make_cache(self, tables: torch.Tensor, ecfg):
        return DoubleBufferedSlotPool(tables, ecfg,
                                      depth=self.cfg.cache.pipeline_depth,
                                      device=self.device)

    # -- scheduler hooks -----------------------------------------------------

    def _pipeline_prestage(self, payload, remapped, lengths):
        """The forward's device operands (dense, slot ids, lengths); runs
        on the scheduler's worker, hidden under the in-flight forward."""
        _, dense = payload
        return (torch.as_tensor(dense, device=self.device),
                torch.as_tensor(remapped, device=self.device),
                torch.as_tensor(lengths, device=self.device))

    def _pipeline_forward(self, payload, remapped, lengths, pool, *,
                          staged):
        """Dispatch one micro-batch's forward over ``pool`` on the current
        stream, from the operands ``_pipeline_prestage`` staged; returns
        the device pCTRs."""
        dense, idx, lens = staged
        params = {**self.params, "tables": pool}
        with torch.no_grad():
            return torch.sigmoid(dlrm_mod.forward(
                params, dense, JaggedBatch(indices=idx, lengths=lens),
                self.cfg, self.ctx))

    def _pipeline_collect(self, payload, host_scores) -> Dict[int, float]:
        todo, _ = payload
        return {req.rid: float(host_scores[i])
                for i, req in enumerate(todo)}

    def _pipeline_fallback(self, payload) -> Dict[int, float]:
        """Serialized split flush for an overflowing micro-batch: requeue
        just this batch and reuse the inherited CacheCapacityError split
        loop against the LIVE buffer."""
        todo, _ = payload
        rest = self.queue
        self.queue = list(todo)
        try:
            scores: Dict[int, float] = {}
            while self.queue:
                scores.update(DLRMEngine.flush(self))
        finally:
            self.queue = rest
        return scores

    # -- pipelined serving ---------------------------------------------------

    def run_to_completion(self) -> Dict[int, float]:
        """Score the whole queue through the stage pipeline.

        If the pipeline dies mid-run (e.g. a cold-tier fetch failure, its
        residency already rolled back), every submitted request goes back
        on the queue: the raising call delivered no scores, so a retry
        scores them all (deterministically the same)."""
        batches, submitted = [], []
        while self.queue:
            todo = self.queue[: self.batch_size]
            self.queue = self.queue[len(todo):]
            submitted.extend(todo)
            dense, idx, lens = self._pad_batch(todo)
            batches.append(((todo, dense), idx, lens))
        out: Dict[int, float] = {}
        try:
            self.scheduler.run(batches, out)
        except BaseException:
            self.queue = submitted + self.queue
            raise
        return out


def make_dlrm_engine(params, cfg: DLRMConfig, batch_size: int,
                     ctx: Optional[ParallelContext] = None, *,
                     device=None) -> DLRMEngine:
    """Build the engine ``cfg.cache.pipeline_depth`` selects on ``device``
    (None: the card): 1 is the serialized :class:`DLRMEngine`, >= 2 the
    :class:`PipelinedDLRMEngine` over a ``pipeline_depth``-deep ring of
    slot pools."""
    cls = PipelinedDLRMEngine if cfg.cache.pipeline_depth > 1 else DLRMEngine
    return cls(params, cfg, batch_size, ctx, device=device)
