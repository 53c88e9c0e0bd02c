"""``CacheConfig`` -- every knob of the tiered cache, in one frozen record.

The counterpart of ``repro.core.cache_config`` (stdlib + numpy only).  The
deprecated flat-field aliases of the reference (``resolve_cache_aliases``)
are left out on purpose: the port never had the old fields.

``slots_per_table``/``slot_offsets`` are the one definition of the flat
``(sum S_t, D)`` slot pool's geometry: the slot-pool manager sizes the pool
from it and the forward derives the kernel's per-table offsets from it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """``rows``: uniform per-table slot count S (0 disables the cache).
    ``rows_per_table``: per-table slot vector S_t, overriding ``rows``.
    ``policy``: "lfu" | "lru".  ``cold_tier``: "host" (the serving host's
    memory) | "remote" (row-split over ``remote_hosts`` simulated hosts,
    fetched by ``comm.fetch_rows`` over the ``remote_backend`` transport:
    "bulk" | "onesided").  ``warmup_freqs``: offline per-row
    frequencies seeding LFU and pre-admitting the top rows (data, excluded
    from equality).  ``pipeline_depth``: 1 = serialized serving."""

    rows: int = 0
    rows_per_table: Optional[Tuple[int, ...]] = None
    policy: str = "lfu"
    cold_tier: str = "host"
    remote_hosts: int = 0
    remote_backend: str = "bulk"
    pipeline_depth: int = 1
    warmup_freqs: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}")
        if self.rows < 0:
            raise ValueError(f"cache rows must be >= 0, got {self.rows}")
        if self.rows_per_table is not None and \
                not isinstance(self.rows_per_table, tuple):
            # normalize lists/arrays to a tuple: hashable, value equality
            object.__setattr__(
                self, "rows_per_table",
                tuple(int(s) for s in np.asarray(self.rows_per_table)))

    @property
    def enabled(self) -> bool:
        """True when the tiered cache path should be built at all."""
        return self.rows > 0 or self.rows_per_table is not None

    def slots_per_table(self, num_tables: int, rows: int) -> np.ndarray:
        """The per-table LIVE slot counts ``S_t = min(requested, rows)``."""
        if self.rows_per_table is not None:
            s = np.asarray(self.rows_per_table, np.int64)
            if s.shape != (num_tables,):
                raise ValueError(
                    f"rows_per_table must have one entry per table "
                    f"({num_tables}), got shape {s.shape}")
        else:
            s = np.full(num_tables, int(self.rows), np.int64)
        if (s <= 0).any():
            raise ValueError(
                f"cache rows must be positive for every table, got "
                f"{s.tolist()}")
        return np.minimum(s, rows)

    def slot_offsets(self, num_tables: int, rows: int) -> np.ndarray:
        """``(T + 1,)`` cumulative slot offsets: table ``t``'s slots live
        at flat pool rows ``[offsets[t], offsets[t + 1])``."""
        off = np.zeros(num_tables + 1, np.int64)
        np.cumsum(self.slots_per_table(num_tables, rows), out=off[1:])
        return off
