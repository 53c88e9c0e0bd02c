"""Tiered embedding cache: device slot pool over a host or remote cold
tier."""
from repro_torch.cache.tiers import HostStore, RemoteStore, SlotPool, \
    TableStore

__all__ = ["HostStore", "RemoteStore", "SlotPool", "TableStore"]
