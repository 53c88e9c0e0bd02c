"""Fixed-capacity bucketing: the counterpart of ``repro.core.routing``.

The paper's phase-1 permute (§4.2) routes lookup ids to owner shards
through fixed-shape buffers; the same primitive routes MoE token
assignments to experts:

    bucketed, slot, dropped = fixed_capacity_bucket(dest, n_buckets, cap,
                                                    payloads)

An element's ``slot`` is ``dest * cap + pos`` (``pos`` its place among
the earlier elements of the same bucket, in input order) when it fits,
and ``n_buckets * cap``, one past the end, when it is dropped;
``gather_from_buckets`` inverts the permutation (dropped elements read
zero).  The integer outputs are bitwise the reference's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def bucket_positions(dest: torch.Tensor, num_buckets: int, capacity: int):
    """Stable position of each element within its destination bucket.

    ``dest`` (N,) integer in ``[0, num_buckets)``.  Returns (slot, keep,
    dropped): slot (N,) int32, ``dest * capacity + pos`` for kept
    elements and ``num_buckets * capacity`` for dropped ones; keep (N,)
    bool; dropped () int32, the overflow count.  The reference takes
    ``pos`` from a one-hot cumsum over the (N, num_buckets) matrix; here
    from a stable sort by bucket (an element's rank in the sorted order
    less its bucket's start), the same integers without the cumsum down
    N rows, which takes milliseconds on the card at N = 24,576."""
    dest = dest.long()
    order = torch.argsort(dest, stable=True)
    counts = torch.bincount(dest, minlength=num_buckets)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(dest)
    pos[order] = torch.arange(dest.shape[0], device=dest.device) \
        - starts[dest[order]]
    pos = pos.to(torch.int32)
    keep = pos < capacity
    dropped = (~keep).sum(dtype=torch.int32)
    slot = torch.where(keep, dest.to(torch.int32) * capacity + pos,
                       num_buckets * capacity).to(torch.int32)
    return slot, keep, dropped


def scatter_to_buckets(slot: torch.Tensor, payload: torch.Tensor,
                       num_buckets: int, capacity: int, fill=0):
    """(N, ...) payload -> (num_buckets, capacity, ...) via ``slot``: an
    ``index_copy_`` into a ``(size + 1, ...)`` buffer whose last row, the
    dropped elements', is cut off."""
    size = num_buckets * capacity
    trail = tuple(payload.shape[1:])
    buf = torch.full((size + 1,) + trail, fill, dtype=payload.dtype,
                     device=payload.device)
    buf.index_copy_(0, slot.long(), payload)
    return buf[:size].reshape((num_buckets, capacity) + trail)


def gather_from_buckets(slot: torch.Tensor, buckets: torch.Tensor):
    """Inverse of scatter: element j <- buckets.flat[slot[j]] (dropped ->
    0).  The reference reads a zero row appended past the end; here the
    one-past-end slots read the last row and are zeroed, which gives the
    same values without copying the buckets."""
    nb, cap = buckets.shape[:2]
    trail = tuple(buckets.shape[2:])
    size = nb * cap
    slot = slot.long()
    if size == 0:
        return buckets.new_zeros((slot.shape[0],) + trail)
    out = buckets.reshape((size,) + trail)[slot.clamp(max=size - 1)]
    return out.masked_fill_((slot >= size).view((-1,) + (1,) * len(trail)),
                            0)


def fixed_capacity_bucket(
    dest: torch.Tensor, num_buckets: int, capacity: int,
    payloads: Sequence[torch.Tensor], fills: Sequence = None,
) -> Tuple[list, torch.Tensor, torch.Tensor]:
    """Bucket several parallel payload tensors by ``dest``.

    Returns ([bucketed...], slot, dropped).  Overflow elements are dropped
    (slot one past the end); empty slots hold ``fills`` (0 by default)."""
    slot, _, dropped = bucket_positions(dest, num_buckets, capacity)
    fills = fills or [0] * len(payloads)
    out = [scatter_to_buckets(slot, p, num_buckets, capacity, f)
           for p, f in zip(payloads, fills)]
    return out, slot, dropped
