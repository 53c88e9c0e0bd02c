"""Static checks of the port's pipeline protocol (the counterpart of the
protocol layer of ``repro.analysis``; its kernel contracts and lint audit
JAX programs and sources and have no counterpart here)."""
from repro_torch.analysis.protocol import (
    EpochReplay,
    ProtocolViolation,
    TimelineSpan,
    check_scheduler_source,
    check_timeline,
    extract_scheduler_events,
    load_timeline,
)

__all__ = [
    "EpochReplay",
    "ProtocolViolation",
    "TimelineSpan",
    "check_scheduler_source",
    "check_timeline",
    "extract_scheduler_events",
    "load_timeline",
]
