"""Batched inference engines: the port's serving entry points.

LM serving (the counterpart of ``repro.serving.engine``'s LM half):
``generate`` is the simple API (one batch of prompts, greedy or
temperature sampling); ``ContinuousBatcher`` is the serving loop, a fixed
pool of cache slots at possibly different lengths.  Finished sequences
are evicted and queued requests admitted into free slots; one
``decode_step`` advances every slot.  Admission prefills the request
alone and writes its cache rows (K/V, or MLA's latent ``c_kv``/``k_rope``)
and its whole states (Mamba's ``ssm_h``/``conv``, RWKV's ``S``/``x_tm``/
``x_cm``) straight into its slot of the shared cache (the reference
splices a separately prefilled, zero-padded cache); positions past a
slot's length hold stale rows, which decode attention masks, and an
evicted slot's states stay until the next admission overwrites them.

DLRM CTR scoring: ``DLRMEngine``: requests queue up, ``flush`` pads up to
``batch_size`` of them to fixed shapes and runs one forward whose
embedding pooling is one fused TBE kernel launch for all tables
(``cfg.fused``).  With ``cfg.cache.enabled`` the tables live behind the
tiered cache: ``flush`` first prefetches the micro-batch's working set
into the device slot pool, and a micro-batch whose working set overflows
the pool is split in half until it fits.  With a ``ParallelContext`` the
pooling runs the distributed embedding bag over the context's simulated
model axis; the engine shards the tables once, at construction.  With a
``ProcessContext`` the engine is one rank's: it keeps only this rank's
shard (a copy on the rank's device), every rank runs the same flushes in
lockstep over its process group, and each returns the same scores (rank
0's are the ones a caller reports).  The cached engines refuse a context,
as the reference's do; their cluster-wide cold tier is
``cache.cold_tier="remote"``, whose hosts are the ranks of ``remote_ctx=``
(a ``ProcessContext``) when one is given: every rank then runs the same
engine over the same requests, holds only its own row shard of every
table, and fetches the same rows in lockstep, so every rank keeps the
same slot pools, counters and scores.

``PipelinedDLRMEngine`` (``cfg.cache.pipeline_depth >= 2``) serves the
same requests as a software pipeline over a ring of slot pools
(``repro_torch.pipeline``): the next micro-batch's admission, cold fetch,
scatter and operand staging run on a worker thread, on a side CUDA stream
on the card, while the current micro-batch's forward runs on the main
stream; events order the two streams.  Its scores are bitwise equal to
``DLRMEngine``'s.

A ``cfg.sharding_plan`` (``core.sharding_plan.plan``) sizes the slot pools
per table, in both engines, as in the reference; the pipelined engine then
needs no ``cache.rows``.  ``telemetry=`` (``repro_torch.obs.Telemetry``)
puts each engine on one host-clock timeline with latency histograms and
the windowed hit-rate instruments the SLO monitor and drift detector read.

LM serving under a ``ProcessContext`` (each rank of the model axis a
process, its parameters cut by ``utils/convert.lm_params_for_rank``):
``generate`` and ``ContinuousBatcher`` run on the rank's device, every
rank over the same prompts, admitting and evicting the same requests in
lockstep (``models/decode.py``); each returns the same tokens.  With a
data axis that divides the batch (the batcher's slots), a rank's cache
holds its data group's share of the slots, the group prefills and
decodes only those, and the hidden states (an admission's first token)
come back whole over the data axis, so every rank keeps the same host
bookkeeping.

Float32 products run in full float32 on the card (TF32 off), as in the
reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import KernelContract
from repro_torch.cache.manager import CacheCapacityError
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.core import comm
from repro_torch.core.embedding_bag import (make_cache, shard_for_rank,
                                            shard_tables)
from repro_torch.core.jagged import JaggedBatch
from repro_torch.core.parallel import (ParallelContext, ProcessContext,
                                       data_split)
from repro_torch.models import decode as dec
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import lm
from repro_torch.pipeline import (DoubleBufferedSlotPool, PipelineScheduler,
                                  PipelineTrace)
from repro_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------

def _rank_device(ctx, device):
    """A rank's entry point runs on the rank's device: ``ctx.device``
    under a ``ProcessContext`` (a ``device`` that differs raises
    ``ValueError``), else ``device``."""
    if not isinstance(ctx, ProcessContext):
        return device
    if device is not None and torch.device(device) != ctx.device:
        raise ValueError(f"device {device} is not the rank's {ctx.device}")
    return ctx.device


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


def generate(params, cfg: ModelConfig, prompts, max_new: int,
             ctx: Optional[ParallelContext | ProcessContext] = None, *,
             temperature: float = 0.0, seed: int = 0, frames=None,
             device=None) -> torch.Tensor:
    """prompts (B, S) -> (B, max_new) generated ids (greedy by default) on
    ``device`` (None: the card; the parameters must live there).  The
    audio family's ``frames`` (B, S_enc, d) go through its encoder once,
    in the prefill.  ``ctx``: prefill, every decode step and the head
    under the context (``models/decode.py``); under a ``ProcessContext``
    on the rank's device, with the rank's parameters, ``S + max_new``
    divisible by the ranks when the cache is sequence-sharded."""
    device = resolve_device(_rank_device(lm.check_context(ctx), device))
    prompts = torch.as_tensor(prompts, device=device)
    B, S = prompts.shape
    gen = torch.Generator(device=device).manual_seed(seed)
    cache, hidden = dec.prefill(params, prompts, cfg, ctx,
                                max_len=S + max_new, frames=frames)
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
    prefills the request alone, writing its cache rows and states into
    its slot in place; eviction zeroes the slot's length only, as in the
    reference.  One decode_step advances
    every slot, empty ones included, as in the reference.  ``timings`` keeps,
    on the host clock, each admission's ``(prompt length, seconds)`` and
    each decode step's seconds, both up to the token on the host.

    The audio family is refused: the reference's admission prefills
    without frames and fails; whisper serves through ``generate(frames=)``.
    The vlm family is served text only, as the reference's admission
    prefills it.

    ``ctx``: the prefill of each admission, every decode step and the
    head run under the context (``models/decode.py``), so a slot's tokens
    are ``generate(ctx)``'s.  The reference's admission prefills without
    the context and only its decode steps and head take it; the port
    prefills under it, so admission runs the sharded vocabulary and the
    expert-parallel MoE as ``generate(ctx)`` does (ROADMAP "Differences on
    purpose").  With a sequence-sharded cache ``max_len`` must divide
    over the context's ranks (``ValueError``).  Under a ``ProcessContext``
    the batcher is one rank's: on the rank's device, over the rank's
    parameters (``utils/convert.lm_params_for_rank``) and its slice of
    the cache; every rank submits the same requests and steps in
    lockstep, and each finishes with the same tokens.  With a data axis
    that divides ``num_slots``, data group d owns slots ``[d n/dp, (d +
    1) n/dp)``: its ranks' cache holds only those, an admission into one
    is prefilled by its owner alone (its first token gathered over the
    data axis), and each decode step runs every group's slots in its
    group (``decode.decode_step``)."""

    def __init__(self, params, cfg: ModelConfig, num_slots: int,
                 max_len: int,
                 ctx: Optional[ParallelContext | ProcessContext] = None,
                 eos_id: int = 1, *, device=None):
        device = _rank_device(lm.check_context(ctx), device)
        if cfg.attention != "none":
            dec._seq_sharded(ctx, max_len)
        if cfg.family == "audio":
            raise ValueError(
                f"{cfg.name}: the batcher admits prompts without frames; "
                f"serve the audio family through generate(frames=)")
        self.device = resolve_device(device)
        on = params["embed"].device
        if on.type != self.device.type:
            raise ValueError(f"parameters are on {on}, the batcher on "
                             f"{self.device}")
        self.params, self.cfg, self.ctx = params, cfg, ctx
        self.num_slots, self.max_len, self.eos = num_slots, max_len, eos_id
        self.cache = dec.init_cache(cfg, num_slots, max_len,
                                    dtype=params["embed"].dtype,
                                    device=self.device, ctx=ctx)
        # the slots this rank's cache holds, and the context their
        # admissions run under: a data group's share over its model axis
        split = data_split(ctx, num_slots)
        rows, self._admit_ctx = split or (slice(None), ctx)
        self._own = range(num_slots)[rows]
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
        return lm.lm_logits(self.params, hidden[:, None], self.cfg,
                            self.ctx)[:, 0]

    # -- internal ----------------------------------------------------------
    def _local(self, i: int) -> Optional[int]:
        """Slot ``i``'s index in this rank's cache, None if another data
        group's cache holds it."""
        return i - self._own.start if i in self._own else None

    def _admit(self) -> None:
        for i in range(self.num_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                t0 = time.perf_counter()
                prompt = torch.as_tensor(req.prompt[None, :],
                                         device=self.device)
                first = torch.zeros((1,), dtype=torch.int64,
                                    device=self.device)
                j = self._local(i)
                if j is not None:
                    # slot j of every entry, rows and states alike (batch
                    # at axis 1); prefill writes the states whole
                    kv = {name: {k: v[:, j:j + 1] for k, v in st.items()}
                          for name, st in dec.kv_stacks(self.cache).items()}
                    hidden = dec._prefill_into(self.params, prompt, self.cfg,
                                               kv, self._admit_ctx)
                    self.cache["length"][j] = prompt.shape[1]
                    lg = self._head(hidden[:, -1])
                    first = torch.argmax(lg[:, : self.cfg.vocab_size], -1)
                if len(self._own) < self.num_slots:
                    # the owner's token, from the data group that holds i
                    first = comm.data_all_gather(first, ctx=self.ctx)[
                        i // len(self._own)]
                first = int(first.reshape(-1)[0])
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
                j = self._local(i)
                if j is not None:
                    self.cache["length"][j] = 0

    def step(self) -> bool:
        """Admit, decode one token for all slots, evict finished."""
        self._admit()
        if not any(s is not None for s in self.slots):
            return False
        t0 = time.perf_counter()
        self.cache, hidden = dec.decode_step(self.params, self.cache,
                                             self.tokens, self.cfg, self.ctx)
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
    ``ctx``'s simulated model axis when one is given.

    Cache sizes: without a ``cfg.sharding_plan``, EVERY table's slot
    count (``cache.rows_per_table`` when given, else ``cache.rows``) must
    be at least ``pooling``, so one request's working set always fits;
    it is the rule the plan branch applies to the plan's vector.  The
    reference checks the uniform ``cache.rows`` even when
    ``rows_per_table`` overrides it, so it refuses ``rows_per_table``
    with ``rows`` 0 and accepts a vector entry under ``pooling``: a
    difference on purpose (``tests/test_torch_serving.py`` pins both).

    ``remote_ctx`` (a ``ProcessContext``): the remote cold tier's hosts
    are the group's ranks, and this engine is one of them (on the rank's
    device; see the module docstring).  It needs ``cache.cold_tier ==
    "remote"`` and no ``ctx``.

    ``telemetry`` (a :class:`repro_torch.obs.Telemetry`) puts the engine
    on the unified timeline: ``submit`` stamps each request's enqueue
    time, ``flush`` records prefetch/forward spans on the engine lane and
    one enqueue->score latency observation per scored request
    (``<obs_name>.request_latency_s`` histogram + request-lane span), the
    cache's admit/fetch/scatter spans land on the cache lane, and the
    engine's ``CacheStats`` joins ``telemetry.metrics`` as the
    ``<obs_name>.cache`` producer.  None (the default) costs one attribute
    check per flush."""

    OBS_NAME = "dlrm"

    def __init__(self, params, cfg: DLRMConfig, batch_size: int,
                 ctx: Optional[ParallelContext | ProcessContext] = None, *,
                 device=None, telemetry=None,
                 obs_name: Optional[str] = None,
                 remote_ctx: Optional[ProcessContext] = None):
        cached = cfg.cache.enabled or cfg.sharding_plan is not None
        if remote_ctx is not None:
            _check_remote_ctx(remote_ctx, ctx, cfg, cached)
        for rank_ctx in (ctx, remote_ctx):
            device = _rank_device(rank_ctx, device)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full-fp32 MLP products, like the reference's
            torch.backends.cuda.matmul.allow_tf32 = False
        on = params["bottom"][0]["w"].device
        if on.type != self.device.type:
            raise ValueError(f"parameters are on {on}, the engine on "
                             f"{self.device}")
        self.params, self.cfg, self.ctx = params, cfg, ctx
        self.remote_ctx = remote_ctx
        self.batch_size = batch_size
        self.queue: List[CTRRequest] = []
        self.telemetry = telemetry
        self.obs_name = obs_name if obs_name is not None else self.OBS_NAME
        # rid -> perf_counter enqueue stamp, popped at scoring, so a
        # pipeline failure's requeued requests keep their ORIGINAL stamps
        self._enqueue_t: Dict[int, float] = {}
        # rid -> dequeue stamp (the micro-batch carve): splits latency into
        # queue wait and service time; a capacity split's survivors are
        # stamped again at their next carve
        self._dequeue_t: Dict[int, float] = {}
        # cache counters at the last batch tick (windowed hit-rate deltas)
        self._cache_counter_state = None
        self.cache = None
        if cached and ctx is not None:
            raise NotImplementedError(
                "DLRMEngine: the tiered cache path scores on a single "
                "serving device (an enabled cfg.cache with a "
                "ParallelContext is not supported) -- a cluster-wide cold "
                "tier is cache.cold_tier='remote'")
        if ctx is not None:
            # the sharded tables, built once: row and table shards are
            # views of params["tables"], column shards one copy; a rank of
            # a ProcessContext copies its own shard and keeps nothing else
            ecfg = cfg.embedding_config()
            if isinstance(ctx, ProcessContext):
                tables = shard_for_rank(params["tables"], ecfg, ctx)
            else:
                tables = shard_tables(params["tables"], ecfg, ctx.tp_size)
            self.params = {**params, "tables": tables}
        if cached:
            per_table = cfg.cache_rows_vector()
            if per_table is not None:
                # plan-sized heterogeneous pools: EVERY table's own S_t
                # must hold one request's working set
                small = [(t, s) for t, s in enumerate(per_table)
                         if s < cfg.pooling]
                if small:
                    raise ValueError(
                        f"sharding_plan slot pools {small} are smaller "
                        f"than pooling ({cfg.pooling}) — every table's "
                        f"cache_rows must fit one request's working set")
            else:
                slots = (cfg.cache.rows_per_table
                         if cfg.cache.rows_per_table is not None
                         else (cfg.cache.rows,))
                if min(slots) < cfg.pooling:
                    raise ValueError(
                        f"cache rows ({min(slots)}) must be >= pooling "
                        f"({cfg.pooling}) so a single request's working "
                        f"set always fits the slot pool (CacheConfig.rows)")
            self.cache = self._make_cache(params["tables"],
                                          cfg.embedding_config())
            # the cold tier now lives inside the cache (host memory, or the
            # remote tier's row shards): serving keeps no full tables
            self.params = {**params, "tables": None}
            if self.telemetry is not None:
                # cache-lane spans: every bag of the (possibly
                # double-buffered) pool records onto the one timeline
                bags = getattr(self.cache, "buffers", [self.cache])
                for bag in bags:
                    bag.tracer = self.telemetry.tracer
                self.telemetry.metrics.register_producer(
                    f"{self.obs_name}.cache", self.cache.stats.as_dict,
                    replace=True)
                self._cache_counter_state = \
                    self.cache.stats.counter_state()

    def _make_cache(self, tables: torch.Tensor, ecfg):
        """The tiered cache over ``tables`` on the engine's device; the
        pipelined engine builds its ring of slot pools here instead."""
        return make_cache(tables, ecfg, device=self.device,
                          remote_ctx=self.remote_ctx)

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
        if self.telemetry is not None:
            self._enqueue_t[req.rid] = time.perf_counter()
            self.telemetry.metrics.gauge(
                f"{self.obs_name}.queue_depth").set(len(self.queue))

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
        self._stamp_dequeue(todo)
        while True:
            dense, idx, lens = self._pad_batch(todo)
            params = self.params
            if self.cache is not None:
                # prefetch-at-flush: pin this micro-batch's rows in the slot
                # pool and score against the pool (ids become slot ids); a
                # refused working set splits the micro-batch -- a single
                # request always fits (cache rows >= pooling)
                p0 = time.perf_counter()
                try:
                    idx = self.cache.prefetch_arrays(idx, lens)
                except CacheCapacityError:
                    if len(todo) == 1:
                        raise
                    todo = todo[: len(todo) // 2]
                    continue
                if self.telemetry is not None:
                    self.telemetry.tracer.add_span(
                        f"{self.obs_name}.prefetch", p0, time.perf_counter(),
                        lane="engine", cat="engine",
                        args={"engine": self.obs_name, "batch": len(todo)})
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
        t1 = time.perf_counter()
        if self.cache is not None:
            self.cache.stats.add_time("forward", t1 - t0)
        if self.telemetry is not None:
            self.telemetry.tracer.add_span(
                f"{self.obs_name}.forward", t0, t1, lane="engine",
                cat="engine",
                args={"engine": self.obs_name, "batch": len(todo)})
        self.queue = self.queue[len(todo):]
        self._record_scored(todo, t1)
        return {req.rid: float(p[i]) for i, req in enumerate(todo)}

    def _stamp_dequeue(self, todo) -> None:
        """Stamp each carved request's dequeue time (the split between
        queue wait and service time) and sample the queue depth into the
        gauge and its windowed histogram."""
        if self.telemetry is None or not todo:
            return
        t = time.perf_counter()
        for req in todo:
            self._dequeue_t[req.rid] = t
        m = self.telemetry.metrics
        depth = len(self.queue)
        m.gauge(f"{self.obs_name}.queue_depth").set(depth)
        m.windowed_histogram(
            f"{self.obs_name}.queue_depth", unit="1",
            window=self.telemetry.window, lo=0.5, hi=1e7,
            buckets_per_decade=5).observe(depth)

    def _observe_cache_window(self) -> None:
        """Fold this micro-batch's cache counter movement into the windowed
        hit-rate instruments: the rolling window hits/lookups (their ratio
        is the windowed hit rate the SLO monitor reads) and the per-table
        EWMA ``hit_rate_t`` (the drift detector's measured side).  Under
        the pipelined engine the next batch's prefetch may already have
        landed when batch k is collected: one batch of attribution skew,
        as in the reference."""
        if self.cache is None:
            return
        stats = self.cache.stats
        delta = stats.delta_since(self._cache_counter_state)
        self._cache_counter_state = stats.counter_state()
        if delta.lookups == 0:
            return
        m = self.telemetry.metrics
        w = self.telemetry.window
        m.rolling_counter(f"{self.obs_name}.window.hits",
                          window=w).inc(delta.hits)
        m.rolling_counter(f"{self.obs_name}.window.lookups",
                          window=w).inc(delta.lookups)
        lt = delta.lookups_t
        if lt is not None:
            mask = lt > 0
            rate = np.where(mask, delta.hits_t / np.maximum(lt, 1), 0.0)
            m.ewma(f"{self.obs_name}.hit_rate_t").update(rate, mask=mask)

    def _record_scored(self, reqs, t_scored: float) -> None:
        """Close each scored request's enqueue->score latency span, feed
        the windowed instruments, and tick the window over: one scored
        micro-batch is one tick (SLO listeners fire, then the engine's
        windows rotate)."""
        if self.telemetry is None:
            return
        m = self.telemetry.metrics
        w = self.telemetry.window
        lat = m.windowed_histogram(f"{self.obs_name}.request_latency_s",
                                   unit="s", window=w)
        wait = m.windowed_histogram(f"{self.obs_name}.queue_wait_s",
                                    unit="s", window=w)
        service = m.windowed_histogram(f"{self.obs_name}.service_s",
                                       unit="s", window=w)
        for req in reqs:
            t_enq = self._enqueue_t.pop(req.rid, None)
            if t_enq is None:
                continue
            self.telemetry.record_request(self.obs_name, req.rid,
                                          t_enq, t_scored)
            lat.observe(max(0.0, t_scored - t_enq))
            t_deq = self._dequeue_t.pop(req.rid, None)
            if t_deq is not None:
                wait.observe(max(0.0, t_deq - t_enq))
                service.observe(max(0.0, t_scored - t_deq))
        self._observe_cache_window()
        self.telemetry.batch_tick(self.obs_name)

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

    ``self.trace`` holds every stage's wall-clock span (mirrored onto the
    telemetry's pipeline lane and per-stage windowed histograms when one
    is given); the shared ``cache_stats()`` record carries the same
    prefetch/scatter/forward timers as the serialized engine's, plus the
    measured ``overlap_s``.
    """

    OBS_NAME = "dlrm_pipelined"

    def __init__(self, params, cfg: DLRMConfig, batch_size: int,
                 ctx: Optional[ParallelContext] = None, *, device=None,
                 telemetry=None, obs_name: Optional[str] = None,
                 remote_ctx: Optional[ProcessContext] = None):
        if cfg.cache.pipeline_depth < 2:
            raise ValueError(
                f"PipelinedDLRMEngine needs pipeline_depth >= 2 (got "
                f"{cfg.cache.pipeline_depth}); depth 1 is the serialized "
                f"DLRMEngine -- use make_dlrm_engine to pick by config")
        if not cfg.cache.enabled and cfg.sharding_plan is None:
            raise ValueError(
                "PipelinedDLRMEngine requires the tiered cache (an enabled "
                "cfg.cache -- CacheConfig.rows > 0, formerly cache_rows -- "
                "or a cfg.sharding_plan): with fully device-resident tables "
                "there is no prefetch stage to overlap")
        super().__init__(params, cfg, batch_size, ctx, device=device,
                         telemetry=telemetry, obs_name=obs_name,
                         remote_ctx=remote_ctx)
        self.trace = PipelineTrace(
            tracer=None if telemetry is None else telemetry.tracer,
            label=self.obs_name,
            metrics=None if telemetry is None else telemetry.metrics,
            window=32 if telemetry is None else telemetry.window)
        self.scheduler = PipelineScheduler(
            self.cache, forward=self._pipeline_forward,
            collect=self._pipeline_collect, fallback=self._pipeline_fallback,
            prestage=self._pipeline_prestage, trace=self.trace)

    def _make_cache(self, tables: torch.Tensor, ecfg):
        return DoubleBufferedSlotPool(tables, ecfg,
                                      depth=self.cfg.cache.pipeline_depth,
                                      device=self.device,
                                      remote_ctx=self.remote_ctx)

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
        self._record_scored(todo, time.perf_counter())
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
            self._stamp_dequeue(todo)
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
                     ctx: Optional[ParallelContext | ProcessContext] = None,
                     *, device=None, telemetry=None,
                     obs_name: Optional[str] = None,
                     remote_ctx: Optional[ProcessContext] = None
                     ) -> DLRMEngine:
    """Build the engine ``cfg.cache.pipeline_depth`` selects on ``device``
    (None: the card): 1 is the serialized :class:`DLRMEngine`, >= 2 the
    :class:`PipelinedDLRMEngine` over a ``pipeline_depth``-deep ring of
    slot pools.  ``telemetry``/``obs_name``/``remote_ctx`` go to the
    engine (see :class:`DLRMEngine`)."""
    cls = PipelinedDLRMEngine if cfg.cache.pipeline_depth > 1 else DLRMEngine
    return cls(params, cfg, batch_size, ctx, device=device,
               telemetry=telemetry, obs_name=obs_name, remote_ctx=remote_ctx)


def _check_remote_ctx(remote_ctx, ctx, cfg: DLRMConfig, cached: bool) -> None:
    """``remote_ctx`` names the remote cold tier's hosts: a
    ``ProcessContext``, beside no model-axis context, under an enabled
    cache whose cold tier is ``"remote"``."""
    if not isinstance(remote_ctx, ProcessContext):
        raise TypeError(f"remote_ctx must be a ProcessContext (one host per "
                        f"rank), got {type(remote_ctx).__name__}")
    if ctx is not None:
        raise ValueError(
            "DLRMEngine: remote_ctx (the remote cold tier's hosts) and ctx "
            "(a model axis) were both given; the cached engine scores on "
            "one device per rank and takes no model axis")
    if not cached or cfg.cache.cold_tier != "remote":
        raise ValueError(
            f"DLRMEngine: remote_ctx needs an enabled cache whose cold tier "
            f"is 'remote', got cold_tier={cfg.cache.cold_tier!r}"
            + ("" if cached else " with the cache disabled"))


# ---------------------------------------------------------------------------
# Kernel contracts (audited by repro_torch.analysis)
# ---------------------------------------------------------------------------

KERNEL_CONTRACTS = {
    "tiered_forward": KernelContract(
        name="serving.engine.tiered_forward",
        note="the tiered serving program (flat-pool DLRM forward + "
             "sigmoid) runs ONE fused TBE launch with ZERO collectives "
             "and ZERO host transfers — all cold-tier traffic happens in "
             "the explicit prefetch phase"),
}
