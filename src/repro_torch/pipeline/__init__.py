"""Pipelined serving: double-buffered slot pools overlapping the next
micro-batch's prefetch with the current one's forward.

The counterpart of ``repro.pipeline``.  ``double_buffer.DoubleBufferedSlotPool``
keeps ``depth`` full flat slot pools (each with its own manager) over ONE
shared cold tier and ONE shared ``CacheStats``: batch k's forward reads the
LIVE buffer while batch k+1's admission, cold fetch and pool scatter target
the SHADOW buffer; ``swap()`` rotates the ring and publishes the prepared
epoch.  Plans are epoch-stamped and a commit refuses a stale one; a failed
fetch or scatter invalidates the plan's residency.

``scheduler.PipelineScheduler`` runs ``admit -> fetch -> scatter ->
forward -> swap`` with the prefetch stages on a worker thread.  On the card
that worker runs on a side CUDA stream, ordered against the forward's
stream by events (the reference relies on JAX dispatch order instead).
Every stage records a wall-clock ``StageSpan``: overlap is measured
(``PipelineTrace.overlap_s``), not assumed.

Exactness: the pipelined engine's scores are bitwise equal to the
serialized engine's under any eviction churn -- a batch's working set is
fully resident in its own buffer before its forward runs, and the pooled
output is invariant to slot layout (same kernel, same summation order,
same row payloads).

Consumer: ``serving.engine.PipelinedDLRMEngine`` (selected by
``cfg.cache.pipeline_depth``).
"""
from repro_torch.pipeline.double_buffer import DoubleBufferedSlotPool
from repro_torch.pipeline.scheduler import (
    STAGES,
    PipelineScheduler,
    PipelineTrace,
    StageSpan,
)

__all__ = [
    "DoubleBufferedSlotPool",
    "PipelineScheduler",
    "PipelineTrace",
    "StageSpan",
    "STAGES",
]
