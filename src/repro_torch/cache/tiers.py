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
  * :class:`RemoteStore` -- tier "remote": every table row-split across
    ``hosts`` simulated hosts (host h owns rows ``[h*R/H, (h+1)*R/H)`` of
    every table, the paper's row-wise layout); a fetch is ONE batched
    ``comm.fetch_rows`` per prefetch, over the bulk or the one-sided
    transport.

The simulation backs all H hosts with slices of ONE device (the card by
default), where the reference backs each with its own jax device; placing
one shard per card comes with the distributed slice.  The serving rank is
host ``home``: rows it owns count as host-tier traffic, rows of peers as
remote-tier traffic.  A fetched row's payload is bitwise the source table
row whichever tier served it, so the pooled output stays bitwise-equal to
the uncached lookup.
"""
from __future__ import annotations

import abc
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.utils.device import resolve_device


def _pad_pow2(arrays):
    """Pad each (M, ...) array to the next power of two by repeating its
    last element -- idempotent duplicates that keep the fetch's shapes to
    O(log M_max) distinct sizes, as in the reference."""
    m = arrays[0].shape[0]
    pad = (1 << (m - 1).bit_length()) - m
    if not pad:
        return arrays
    return [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
            for a in arrays]


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


class RemoteStore(TableStore):
    """Tier "remote": every table row-split across ``hosts`` hosts.

    Host h's shard is the flat ``(T * R/H, D)`` block of rows
    ``[h*R/H, (h+1)*R/H)`` of every table (owner-local address
    ``t * R/H + r % (R/H)``), all H shards stacked ``(H, T * R/H, D)`` on
    ``device`` (None: the card).  ``fetch`` runs ONE ``comm.fetch_rows``
    over the shards per call, with the request padded to a power of two,
    and returns the payloads to the serving host as a CPU tensor."""

    tier = "remote"

    def __init__(self, tables: torch.Tensor, *, hosts: Optional[int] = None,
                 backend: str = "bulk", home: int = 0, device=None):
        if tables.dim() != 3:
            raise ValueError(
                f"tables must be (T, R, D), got {tuple(tables.shape)}")
        T, R, D = tables.shape
        if backend not in ("bulk", "onesided"):
            raise ValueError(f"unknown remote backend {backend!r}")
        self.device = resolve_device(device)
        # one simulated host per card by default: one card, or the CPU,
        # is one host and too few
        H = int(hosts) if hosts else (
            torch.cuda.device_count() if self.device.type == "cuda" else 1)
        if H < 2:
            raise ValueError(
                f"RemoteStore needs >= 2 hosts (got {H}) -- use HostStore "
                f"(cold_tier='host') for a single-host cold tier")
        if R % H:
            raise ValueError(
                f"rows_per_table ({R}) must divide evenly over {H} hosts")
        self.hosts, self.home, self.backend = H, int(home), backend
        self._rows_per_host = R // H
        # (H, T * R/H, D): host h's flat shard at [h], one permuted copy
        self.shards = (tables.detach().to(self.device)
                       .reshape(T, H, self._rows_per_host, D)
                       .permute(1, 0, 2, 3)
                       .reshape(H, T * self._rows_per_host, D))

    @property
    def rows_per_host(self) -> int:
        return self._rows_per_host

    def owner_of(self, row_ids: np.ndarray) -> np.ndarray:
        return np.asarray(row_ids) // self._rows_per_host

    def fetch(self, t_ids, row_ids) -> torch.Tensor:
        t_ids = np.asarray(t_ids, np.int64)
        row_ids = np.asarray(row_ids, np.int64)
        owner = row_ids // self._rows_per_host
        local = t_ids * self._rows_per_host + row_ids % self._rows_per_host
        m = local.shape[0]
        local, owner = _pad_pow2([local, owner])
        t0 = time.perf_counter()
        out = comm.fetch_rows(
            self.shards, torch.as_tensor(local, device=self.device),
            torch.as_tensor(owner, device=self.device), backend=self.backend)
        # device -> host round trip: the payloads land on the serving host
        # (modelling NIC -> host memory) before SlotPool.scatter moves them
        # to the device
        result = out[:m].cpu()
        # the stacked payload bytes: H contributions of the padded request
        comm.record_runtime(
            "fetch_rows",
            self.hosts * local.shape[0] * self.shards.shape[-1]
            * self.shards.element_size(),
            self.hosts, self.backend, t0, time.perf_counter())
        return result
