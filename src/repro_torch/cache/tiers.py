"""``TableStore`` -- the tier interface of the embedding store.

The counterpart of ``repro.cache.tiers`` for one serving device:

  * :class:`SlotPool` -- tier "hbm": the flat ``(sum S_t, D)`` device
    tensor the fused TBE kernel reads through per-table slot offsets.
    Allocated once and never reallocated; a prefetch writes its rows in
    place with one ``index_copy_`` (the reference's donated
    ``_scatter_rows``).
  * :class:`HostStore` -- tier "host": the full ``(T, R, D)`` tables as a
    CPU tensor; a fetch gathers rows there and the scatter copies them to
    the device.

The remote tier (``RemoteStore``, row shards on peer hosts) comes with the
distributed slice.  A fetched row's payload is bitwise the source table
row, so the pooled output stays bitwise-equal to the uncached lookup.
"""
from __future__ import annotations

import abc

import numpy as np
import torch


class TableStore(abc.ABC):
    """One tier of the embedding store: where row payloads live.

    ``hosts``/``home``/``rows_per_host`` describe the tier's ownership
    layout so the slot-pool manager can split a plan by serving tier."""

    tier: str = "?"
    hosts: int = 1
    home: int = 0

    @property
    @abc.abstractmethod
    def rows_per_host(self) -> int:
        """Rows of each table owned by one host (R for single-host tiers)."""

    @abc.abstractmethod
    def fetch(self, t_ids: np.ndarray, row_ids: np.ndarray) -> torch.Tensor:
        """(M,) table ids x (M,) table-local row ids -> (M, D) payloads."""


class SlotPool(TableStore):
    """Tier "hbm": the flat ``(sum S_t, D)`` device pool the kernel reads.

    Table ``t``'s slots are the rows ``[slot_offsets[t], slot_offsets[t+1])``;
    the pool holds exactly ``sum(S_t) * D`` elements, with no padding."""

    tier = "hbm"

    def __init__(self, num_tables: int, slots: int, dim: int,
                 dtype: torch.dtype, *, device: torch.device,
                 slots_per_table=None):
        if slots_per_table is None:
            slots_per_table = np.full(num_tables, slots, np.int64)
        self.slots_per_table = np.asarray(slots_per_table, np.int64)
        if self.slots_per_table.shape != (num_tables,) or \
                self.slots_per_table.max(initial=0) > slots:
            raise ValueError(
                f"slots_per_table must be ({num_tables},) with entries "
                f"<= {slots}, got {slots_per_table}")
        self.slot_offsets = np.zeros(num_tables + 1, np.int64)
        np.cumsum(self.slots_per_table, out=self.slot_offsets[1:])
        self.array = torch.zeros((int(self.slot_offsets[-1]), dim),
                                 dtype=dtype, device=device)

    @property
    def slots(self) -> int:
        """Largest per-table slot count."""
        return int(self.slots_per_table.max(initial=0))

    @property
    def rows_per_host(self) -> int:
        return self.slots

    @property
    def nbytes(self) -> int:
        return self.array.numel() * self.array.element_size()

    def fetch(self, t_ids, slot_ids) -> torch.Tensor:
        """Read resident payloads back to the host (test hook)."""
        addr = self.slot_offsets[np.asarray(t_ids)] + np.asarray(slot_ids)
        return self.array[torch.as_tensor(addr, device=self.array.device)
                          ].cpu()

    def scatter(self, flat_addr: np.ndarray, rows: torch.Tensor) -> None:
        """Write (M, D) ``rows`` at flat ``slot_offsets[t] + slot``
        addresses (``PrefetchPlan.flat_addr``), in place."""
        addr = torch.as_tensor(np.asarray(flat_addr, np.int64),
                               device=self.array.device)
        self.array.index_copy_(
            0, addr, rows.to(device=self.array.device,
                             dtype=self.array.dtype))


class HostStore(TableStore):
    """Tier "host": the full ``(T, R, D)`` tables as a CPU tensor."""

    tier = "host"

    def __init__(self, tables: torch.Tensor):
        if tables.dim() != 3:
            raise ValueError(
                f"tables must be (T, R, D), got {tuple(tables.shape)}")
        self.tables = tables.detach().to("cpu")

    @property
    def rows_per_host(self) -> int:
        return self.tables.shape[1]

    def fetch(self, t_ids, row_ids) -> torch.Tensor:
        return self.tables[torch.as_tensor(np.asarray(t_ids, np.int64)),
                           torch.as_tensor(np.asarray(row_ids, np.int64))]
