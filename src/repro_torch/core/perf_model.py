"""Analytical alpha-beta performance model: the paper's Sec. 3/5 analyses.

The counterpart of ``repro.core.perf_model`` (numpy only): collective
and embedding-bag phase models, the tiered-cache projections the planner
(``core/sharding_plan.py``) prices slot pools with (``zipf_hit_rate``,
``expected_unique_misses``, ``tiered_embedding_bag_time``), and the
calibration loop (``StageSample``, ``calibrate``) that fits measured
serving spans (``repro_torch.obs.Tracer.stage_samples``) back onto a
:class:`Hardware`.  Every function computes what the reference's does,
on the same inputs, to the last bit.

Left out on purpose: the reference's TPU platform (``TPU_V5E``) and its
roofline terms (``roofline_terms`` with the ``ICI_LINK_Bps`` /
``V5E_*`` constants), a TPU's constants that serve the reference's TPU
roofline benchmark and nothing on this port's path.  ``H100_DGX`` keeps
the reference's values, so the same inputs give the same plan in both
packages; constants fitted on the card come out of :func:`calibrate` at
run time and are never written back here.

Collective cost: ``t(S) = alpha + c_op(n) * S / beta`` where ``c_op`` is
the ring traffic multiplier (2(n-1)/n all-reduce, (n-1)/n gather, scatter
and a2a, 1 broadcast), the standard bulk-collective model;
device-initiated one-sided transport has a lower alpha but a lower
sustained beta (no multi-channel pipelining), the crossover the paper
measures (Fig. 1).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class Transport:
    name: str
    alpha_s: float      # per-collective launch/latency floor (seconds)
    beta_Bps: float     # sustained algorithm bandwidth (bytes/second)


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    hbm_Bps: float                 # per-device HBM bandwidth
    hbm_capacity_B: float          # per-device HBM capacity
    peak_flops: float              # per-device peak (bf16)
    bulk: Transport                # NCCL / XLA-collective analogue
    onesided: Transport            # NVSHMEM / Pallas-RDMA analogue
    gather_overhead_s: float = 3e-6   # kernel launch + index math floor
    host_Bps: float = 32e9         # host<->device link (PCIe / host DMA)


# --- calibrated platforms ----------------------------------------------------

H100_DGX = Hardware(
    name="h100-dgx-nvlink",
    hbm_Bps=3.35e12,
    hbm_capacity_B=80e9,
    peak_flops=989e12,
    bulk=Transport("nccl", alpha_s=22e-6, beta_Bps=150e9),
    onesided=Transport("nvshmem", alpha_s=1.5e-6, beta_Bps=20e9),
    gather_overhead_s=1e-6,
    host_Bps=55e9,                 # PCIe gen5 x16 sustained
)


_OP_FACTOR = {
    "all_reduce": lambda n: 2 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "broadcast": lambda n: 1.0,
    # the tiered cache's batched row fetch (comm.fetch_rows): of the missed
    # row payload, the (n-1)/n fraction owned by peer hosts crosses the wire
    "fetch_rows": lambda n: (n - 1) / n,
}


def collective_time(
    op: str, msg_bytes: float, n_devices: int, transport: Transport
) -> float:
    """Seconds for one collective of local payload ``msg_bytes``.

    The latency floor grows ~log2(n) beyond the 8-device system the
    constants were calibrated on (tree/ring hop depth), matching how the
    paper extrapolates 8-GPU measurements to 128-GPU projections.
    """
    if n_devices <= 1:
        return 0.0
    c = _OP_FACTOR[op](n_devices)
    alpha = transport.alpha_s * max(1.0, math.log2(n_devices) / 3.0)
    return alpha + c * msg_bytes / transport.beta_Bps


# ---------------------------------------------------------------------------
# Embedding-bag phase model (paper §4/§5 experiments)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EmbeddingWorkload:
    num_tables: int
    batch_per_device: int
    pooling: int
    dim: int
    dtype_bytes: int = 4
    index_bytes: int = 4


def phase_times(
    w: EmbeddingWorkload, n_devices: int, hw: Hardware, *, onesided: bool = False
) -> Dict[str, float]:
    """Per-phase seconds of the RW pipeline: permute / gather / reduce-scatter.

    Mirrors the measured decomposition of Figs. 6-8: phase 1 all-to-alls the
    index payload, phase 2 streams ``B*T*L`` rows from HBM, phase 3
    reduce-scatters the ``B*T*D`` pooled partials.
    """
    t = hw.onesided if onesided else hw.bulk
    idx_bytes = w.batch_per_device * w.num_tables * w.pooling * w.index_bytes
    # Partials for every origin rank live on each owner before the RS, but a
    # (origin, b, t) segment is only materialized if at least one of its L
    # lookups landed on this owner — for n >> L the buffer is sparse.
    sparsity = min(1.0, w.pooling / max(1, n_devices))
    out_bytes = (
        w.batch_per_device * w.num_tables * w.dim * w.dtype_bytes
        * n_devices * sparsity
    )
    gather_bytes = (
        w.batch_per_device * w.num_tables * w.pooling * w.dim * w.dtype_bytes
    )
    return {
        "permute": collective_time("all_to_all", idx_bytes, n_devices, t),
        "gather": hw.gather_overhead_s + gather_bytes / hw.hbm_Bps,
        "reduce_scatter": collective_time(
            "reduce_scatter", out_bytes, n_devices, t
        ),
    }


def embedding_bag_time(
    w: EmbeddingWorkload, n_devices: int, hw: Hardware, *, onesided: bool = False
) -> float:
    return sum(phase_times(w, n_devices, hw, onesided=onesided).values())


def tbe_gather_phases(
    w: EmbeddingWorkload, hw: Hardware, *, fused: bool
) -> Dict[str, float]:
    """Modeled gather-phase decomposition, fused-TBE vs per-table launches.

    ``launch`` is the per-kernel setup floor (grid launch + pipeline
    fill/drain + index prefetch), paid once under TBE and T times under the
    per-table baseline. ``stream`` is the HBM row traffic — identical in
    both layouts, which is exactly why the paper's #tables axis (§5) is a
    launch-overhead axis at small pooling sizes.
    """
    launches = 1 if fused else w.num_tables
    stream_bytes = (
        w.batch_per_device * w.num_tables * w.pooling * w.dim * w.dtype_bytes
    )
    return {
        "launch": launches * hw.gather_overhead_s,
        "stream": stream_bytes / hw.hbm_Bps,
    }


# ---------------------------------------------------------------------------
# Fig. 9 — local vs distributed projection
# ---------------------------------------------------------------------------

def devices_for_table(table_bytes: float, hw: Hardware) -> int:
    """Paper's rule: N = ceil(table_bytes / HBM capacity), power-of-two."""
    n = max(1, math.ceil(table_bytes / hw.hbm_capacity_B))
    return 1 << (n - 1).bit_length()


def local_vs_distributed_speedup(
    table_bytes: float, w: EmbeddingWorkload, hw: Hardware, *, onesided=False
) -> float:
    """Projected speedup of an all-local-HBM pooling over the distributed one.

    "Local" assumes a device (or memory pool) large enough to hold the whole
    table — pooling costs only the HBM row traffic. "Distributed" pays the
    full 3-phase pipeline across N devices. This reproduces Fig. 9, where a
    10 TB table (128 H100s) projects to 22.8x-108.2x depending on message
    size (#tables, pooling, dim).
    """
    n = devices_for_table(table_bytes, hw)
    local = embedding_bag_time(w, 1, hw, onesided=onesided)
    dist = embedding_bag_time(w, n, hw, onesided=onesided)
    return dist / local


# ---------------------------------------------------------------------------
# Tiered-cache projections (the tiered cache: hit-rate-parameterized phases)
# ---------------------------------------------------------------------------

def slot_pool_bytes(slots_per_table, dim: int, dtype_bytes: int = 4) -> int:
    """Exact HBM the FLAT heterogeneous slot pool allocates:
    ``sum(S_t) * dim * dtype_bytes``.

    This is the quantity the planner's HBM budget must charge — the flat
    ``(sum S_t, D)`` pool holds no padding, so priced bytes == allocated
    bytes == ``SlotPool.live_nbytes``."""
    s = np.asarray(slots_per_table, np.int64)
    if s.size and s.min() < 0:
        raise ValueError(f"slot counts must be >= 0, got {s.tolist()}")
    return int(s.sum()) * int(dim) * int(dtype_bytes)


def padded_slot_pool_bytes(slots_per_table, dim: int,
                           dtype_bytes: int = 4) -> int:
    """HBM a RECTANGULAR ``(T, max S_t, D)`` pool would allocate for the
    same per-table slot counts — the pre-flat layout's cost, kept as the
    baseline the benchmarks quantify the flat pool's shrink against."""
    s = np.asarray(slots_per_table, np.int64)
    if s.size == 0:
        return 0
    if s.min() < 0:
        raise ValueError(f"slot counts must be >= 0, got {s.tolist()}")
    return int(s.size) * int(s.max()) * int(dim) * int(dtype_bytes)

@functools.lru_cache(maxsize=None)
def _gen_harmonic(n: float, a: float) -> float:
    """H(n, a) = sum_{k=1..n} k^-a (exact head + integral tail).

    Valid for any ``a >= 0``: the Euler–Maclaurin tail uses the power
    integral for ``a != 1`` and the log integral at exactly ``a == 1``
    (the plain harmonic number) — the truncated-zeta mass the a <= 1
    traffic model needs.
    """
    n = int(n)
    if n <= 0:
        return 0.0
    head = min(n, 1 << 16)
    s = sum(k ** -a for k in range(1, head + 1))
    if n > head:
        # Euler–Maclaurin tail: integral + half-correction at both ends
        if a == 1.0:
            s += math.log(n / head) - 1 / (2 * head) + 1 / (2 * n)
        else:
            s += (head ** (1 - a) - n ** (1 - a)) / (a - 1) \
                - head ** -a / 2 + n ** -a / 2
    return s


def zipf_hit_rate(a: float, rows: int, cache_rows: int) -> float:
    """Steady-state per-lookup hit rate of a ``cache_rows``-row LFU cache
    under clipped-zipf(a) traffic over ``rows`` ids.

    Traffic model matches ``core/jagged.random_jagged_batch(zipf_a=a)``:

      * ``a > 1`` — ranks are zipf(a) with infinite support, clipped to
        ``rows``: the whole rank tail collapses onto the LAST row, which
        therefore carries enough mass to be cache-resident itself;
      * ``0 < a <= 1`` — the infinite-support zeta diverges, so traffic
        is the TRUNCATED zeta over exactly ``rows`` ranks
        (``p_k = k^-a / H(rows, a)``, the harmonic sum at ``a == 1``).
        This is far from uniform: at a = 0.9 the top 20% of 64K rows
        already absorbs ~85% of lookups.  (The old model priced any
        a <= 1 as uniform ``cache_rows / rows`` — wildly undercounting
        the cache's value for mildly-skewed traffic.)

    The steady-state LFU cache holds the ``cache_rows`` most frequent
    rows; the hit rate is their probability mass.  ``a <= 0`` (uniform
    or anti-skewed) degenerates to ``cache_rows / rows``.
    """
    if cache_rows <= 0:
        return 0.0
    if cache_rows >= rows:
        return 1.0
    if a <= 0.0:
        return cache_rows / rows
    c = min(cache_rows, rows)
    if a <= 1.0:
        return min(1.0, _gen_harmonic(c, a) / _gen_harmonic(rows, a))
    zeta = _gen_harmonic(1 << 24, a) + \
        ((1 << 24) ** (1 - a)) / (a - 1)            # ζ(a)
    clamp = zeta - _gen_harmonic(rows - 1, a)        # mass of the last row
    # top-c set: either the c hottest head rows, or c-1 head + clamp row
    head_only = _gen_harmonic(c, a)
    with_clamp = _gen_harmonic(c - 1, a) + clamp
    return min(1.0, max(head_only, with_clamp) / zeta)


def _expected_new_rows(lo: int, hi: int, Z: float, a: float,
                       n: float) -> float:
    """sum_{k=lo..hi} 1 - (1 - k^-a / Z)^n — expected distinct rows of
    rank lo..hi touched by ``n`` iid lookups.  Exact (vectorized) over
    the first 2^20 ranks; beyond that every row's per-batch probability
    is tiny, so the linear binomial head ``n * p_k`` is summed
    analytically through the harmonic mass (a slight over-estimate,
    vanishing as n * p_k -> 0)."""
    if hi < lo:
        return 0.0
    m = hi - lo + 1
    exact = min(m, 1 << 20)
    k = np.arange(lo, lo + exact, dtype=np.float64)
    p = np.minimum(k ** -a / Z, 1.0)
    e = float((1.0 - np.power(1.0 - p, n)).sum())
    if m > exact:
        tail_mass = (_gen_harmonic(hi, a)
                     - _gen_harmonic(lo + exact - 1, a)) / Z
        e += n * tail_mass
    return e


def expected_unique_misses(a: float, rows: int, cache_rows: int,
                           lookups: int) -> float:
    """Expected DISTINCT missed rows in one batch of ``lookups`` iid
    clipped-zipf(a) lookups against the steady-state top-``cache_rows``
    residency (the :func:`zipf_hit_rate` model, same traffic/residency).

    This is what the real bag fetches per batch — each missed ROW moves
    once per prefetch (``CacheStats.fetch_host``/``fetch_remote``),
    however many of the batch's lookups hit it.  Charging per missed
    LOOKUP instead (the pre-fix model) over-prices fetch traffic
    whenever a cold row repeats within a batch.
    """
    if lookups <= 0 or cache_rows >= rows:
        return 0.0
    c = max(0, int(cache_rows))
    n = float(lookups)
    if a <= 0.0:                       # uniform traffic
        p = 1.0 / rows
        return (rows - c) * (1.0 - (1.0 - p) ** n)
    if a <= 1.0:                       # truncated zeta over [1, rows]
        Z = _gen_harmonic(rows, a)
        return _expected_new_rows(c + 1, rows, Z, a, n)
    # a > 1: infinite-support zipf clipped to ``rows`` — the rank tail
    # collapses onto the LAST row (mass ``clamp``).  Mirror the
    # residency choice zipf_hit_rate makes for the top-c set.
    zeta = _gen_harmonic(1 << 24, a) + \
        ((1 << 24) ** (1 - a)) / (a - 1)
    clamp = zeta - _gen_harmonic(rows - 1, a)
    clamp_term = 1.0 - (1.0 - min(clamp / zeta, 1.0)) ** n
    if c == 0:                             # empty cache: every row misses
        return _expected_new_rows(1, rows - 1, zeta, a, n) + clamp_term
    head_only = _gen_harmonic(c, a)
    with_clamp = _gen_harmonic(c - 1, a) + clamp
    if with_clamp >= head_only:
        # resident: c-1 head rows + the clamp row; misses: ranks c..rows-1
        return _expected_new_rows(c, rows - 1, zeta, a, n)
    # resident: c head rows; misses: ranks c+1..rows-1 plus the clamp row
    return _expected_new_rows(c + 1, rows - 1, zeta, a, n) + clamp_term


def tiered_phase_times(
    w: EmbeddingWorkload, hw: Hardware, *, hit_rate: float, hosts: int = 1,
    onesided: bool = False, zipf_a: float = None, rows: int = None,
    cache_rows: int = None,
) -> Dict[str, float]:
    """Per-phase seconds of the tiered serving path whose cold tier spans
    ``hosts`` hosts (host 0 = the serving rank, RW row split §4.2).

      ``gather``       — every lookup streams from the HBM slot pool
                         through the one fused TBE launch, identical to
                         the local gather phase;
      ``prefetch_h2d`` — ALL missed rows cross the serving host's
                         host<->device link (home-owned rows straight
                         from host RAM, peer-owned rows after they land
                         on the NIC), so remote misses pay BOTH links;
      ``fetch_remote`` — the (hosts-1)/hosts fraction of missed rows
                         owned by peers crosses the network in ONE
                         batched ``comm.fetch_rows`` collective per
                         prefetch (bulk vs one-sided transport — the
                         embedding-row message sizes where the paper's
                         Fig. 1 crossover lives).

    The permute/reduce-scatter phases of the distributed pipeline are
    GONE: that is the whole trade the cache makes.

    Miss-fetch pricing: the real bag moves each missed ROW once per
    batch (``CacheStats.bytes_h2d``/``bytes_remote`` count unique
    fetched rows), however many lookups repeat it.  When the caller
    supplies the traffic model (``zipf_a`` + per-table ``rows`` +
    ``cache_rows``), fetch bytes are priced by
    :func:`expected_unique_misses` so the modeled transfer matches
    measured ``CacheStats`` — that is what makes a planner-emitted
    plan's prices checkable.  Without the traffic model the fallback
    charges once per missed LOOKUP via ``hit_rate``: an upper bound,
    exact only when no cold row repeats within a batch.
    """
    lookups = w.batch_per_device * w.num_tables * w.pooling
    row_bytes = w.dim * w.dtype_bytes
    if zipf_a is not None and rows is not None and cache_rows is not None:
        per_table = w.batch_per_device * w.pooling
        miss_bytes = w.num_tables * row_bytes * expected_unique_misses(
            zipf_a, rows, cache_rows, per_table)
    else:
        miss_bytes = (1.0 - hit_rate) * lookups * row_bytes
    out = {
        "prefetch_h2d": 0.0,
        "fetch_remote": 0.0,
        "gather": hw.gather_overhead_s + lookups * row_bytes / hw.hbm_Bps,
    }
    if miss_bytes > 0:
        out["prefetch_h2d"] = hw.gather_overhead_s + miss_bytes / hw.host_Bps
        if hosts > 1:
            t = hw.onesided if onesided else hw.bulk
            out["fetch_remote"] = collective_time(
                "fetch_rows", miss_bytes, hosts, t)
    return out


def tiered_embedding_bag_time(
    w: EmbeddingWorkload, hw: Hardware, *, hit_rate: float, hosts: int = 1,
    onesided: bool = False, zipf_a: float = None, rows: int = None,
    cache_rows: int = None,
) -> float:
    return sum(tiered_phase_times(
        w, hw, hit_rate=hit_rate, hosts=hosts, onesided=onesided,
        zipf_a=zipf_a, rows=rows, cache_rows=cache_rows).values())


def overlapped_phase_times(
    w: EmbeddingWorkload, hw: Hardware, *, hit_rate: float, hosts: int = 1,
    onesided: bool = False, depth: int = 2, zipf_a: float = None,
    rows: int = None, cache_rows: int = None,
) -> Dict[str, float]:
    """Steady-state per-batch phases of the PIPELINED tiered path
    (repro_torch/pipeline/): depth >= 2 double-buffers the slot pool so batch
    k+1's prefetch (host-link h2d + remote ``fetch_rows``) runs under
    batch k's forward gather.

    Per-phase costs are :func:`tiered_phase_times` unchanged; the extra
    ``overlap`` entry is the NEGATIVE span hidden under the forward —
    ``min(prefetch, forward)``, the canonical steady-state pipeline
    reduction — so ``sum(values())`` is the per-batch wall-clock
    ``max(prefetch, forward)`` instead of their sum.  At ``depth`` 1
    nothing overlaps and the dict degenerates to ``tiered_phase_times``
    (``overlap`` = 0): the serialized engine exactly.
    """
    out = dict(tiered_phase_times(
        w, hw, hit_rate=hit_rate, hosts=hosts, onesided=onesided,
        zipf_a=zipf_a, rows=rows, cache_rows=cache_rows))
    fetch = out["prefetch_h2d"] + out["fetch_remote"]
    out["overlap"] = -min(fetch, out["gather"]) if depth >= 2 else 0.0
    return out


def overlapped_embedding_bag_time(
    w: EmbeddingWorkload, hw: Hardware, *, hit_rate: float, hosts: int = 1,
    onesided: bool = False, depth: int = 2, zipf_a: float = None,
    rows: int = None, cache_rows: int = None,
) -> float:
    """Steady-state per-batch seconds of the pipelined tiered path:
    ``max(prefetch, forward)`` at depth >= 2, the serialized sum at 1."""
    return sum(overlapped_phase_times(
        w, hw, hit_rate=hit_rate, hosts=hosts, onesided=onesided,
        depth=depth, zipf_a=zipf_a, rows=rows,
        cache_rows=cache_rows).values())


def pipelined_speedup_vs_distributed(
    table_bytes: float, w: EmbeddingWorkload, hw: Hardware, *,
    hit_rate: float, hosts: int, depth: int = 2,
    fetch_onesided: bool = False, dist_onesided: bool = False,
) -> float:
    """Fig. 9 recovery with a cluster-wide cold tier AND the prefetch
    pipeline: :func:`tiered_speedup_vs_distributed` where the serving
    device additionally hides miss-fetch latency under the forward."""
    n = devices_for_table(table_bytes, hw)
    dist = embedding_bag_time(w, n, hw, onesided=dist_onesided)
    piped = overlapped_embedding_bag_time(
        w, hw, hit_rate=hit_rate, hosts=hosts, onesided=fetch_onesided,
        depth=depth)
    return dist / piped


def cached_phase_times(
    w: EmbeddingWorkload, hw: Hardware, *, hit_rate: float
) -> Dict[str, float]:
    """Single-host special case of :func:`tiered_phase_times` (local cold
    tier: no ``fetch_remote`` phase exists)."""
    out = tiered_phase_times(w, hw, hit_rate=hit_rate, hosts=1)
    del out["fetch_remote"]
    return out


def cached_embedding_bag_time(
    w: EmbeddingWorkload, hw: Hardware, *, hit_rate: float
) -> float:
    return sum(cached_phase_times(w, hw, hit_rate=hit_rate).values())


def cache_speedup_vs_distributed(
    table_bytes: float, w: EmbeddingWorkload, hw: Hardware, *,
    hit_rate: float, onesided: bool = False,
) -> float:
    """Fig. 9 extension: one cached device vs the N-device RW pipeline.

    The paper projects a 22.8x-108.2x slowdown when a table spans
    N = ceil(bytes / HBM) devices; this projects how much of that
    slowdown a single-device slot-pool cache with the given hit rate
    claws back (>1: the cache beats distributing the table).
    """
    n = devices_for_table(table_bytes, hw)
    dist = embedding_bag_time(w, n, hw, onesided=onesided)
    cached = cached_embedding_bag_time(w, hw, hit_rate=hit_rate)
    return dist / cached


def tiered_speedup_vs_distributed(
    table_bytes: float, w: EmbeddingWorkload, hw: Hardware, *,
    hit_rate: float, hosts: int, fetch_onesided: bool = False,
    dist_onesided: bool = False, zipf_a: float = None, rows: int = None,
    cache_rows: int = None,
) -> float:
    """Fig. 9 recovery with a CLUSTER-WIDE cold tier.

    One serving device whose slot pool fronts tables row-split over
    ``hosts`` hosts (misses fetched cross-host) vs the paper's N-device
    RW pipeline for the same table bytes.  This is the deployment the
    scale-out papers describe — the table doesn't fit one node, but only
    the MISS traffic pays the network, not every lookup's phase 1-3.
    """
    n = devices_for_table(table_bytes, hw)
    dist = embedding_bag_time(w, n, hw, onesided=dist_onesided)
    tiered = tiered_embedding_bag_time(
        w, hw, hit_rate=hit_rate, hosts=hosts, onesided=fetch_onesided,
        zipf_a=zipf_a, rows=rows, cache_rows=cache_rows)
    return dist / tiered


# ---------------------------------------------------------------------------
# Calibration — measured spans in, fitted Hardware out (repro_torch/obs/)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageSample:
    """One measured serving-stage interval, the calibration input.

      * stage "h2d"          — one prefetch's host->device payload move:
        ``seconds`` of wall-clock for ``bytes`` of missed-row payload
        (the interval ``tiered_phase_times`` prices as ``prefetch_h2d =
        gather_overhead_s + bytes / host_Bps``);
      * stage "fetch_remote" — one batched ``comm.fetch_rows``
        collective: ``bytes`` is the LOCAL payload (stacked contribution
        over the axis size, i.e. the miss payload ``collective_time``
        charges) and ``n_devices`` the axis size.

    :meth:`repro_torch.obs.Tracer.stage_samples` projects a recorded timeline
    onto these records.
    """

    stage: str
    seconds: float
    bytes: float
    n_devices: int = 1


def _fit_affine(features, seconds):
    """Least-squares ``t ~= a * f0 + b * f1`` with non-negativity clamps.

    Returns ``(a, b)``; a rank-deficient or too-small sample set falls
    back to a one-coefficient slope fit through the origin, and a
    negative coefficient triggers a refit on the other feature alone —
    physical constants (latency floors, inverse bandwidths) are never
    negative.  Returns None with no samples.
    """
    F = np.asarray(features, np.float64).reshape(-1, 2)
    y = np.asarray(seconds, np.float64)
    if F.shape[0] == 0:
        return None

    def slope(col):
        d = float((F[:, col] ** 2).sum())
        return float((F[:, col] * y).sum()) / d if d > 0 else 0.0

    if F.shape[0] < 2 or np.linalg.matrix_rank(F) < 2:
        return 0.0, slope(1)
    a, b = (float(v) for v in np.linalg.lstsq(F, y, rcond=None)[0])
    if b <= 0:
        return slope(0), 0.0
    if a < 0:
        return 0.0, slope(1)
    return a, b


def predicted_stage_time(s: StageSample, hw: Hardware, *,
                         onesided: bool = False) -> float:
    """Seconds the model charges for one :class:`StageSample`'s stage —
    the exact terms ``tiered_phase_times`` uses, applied per sample."""
    if s.stage == "h2d":
        return hw.gather_overhead_s + s.bytes / hw.host_Bps
    if s.stage == "fetch_remote":
        t = hw.onesided if onesided else hw.bulk
        return collective_time("fetch_rows", s.bytes, s.n_devices, t)
    raise ValueError(
        f"unknown stage {s.stage!r}; pick 'h2d' or 'fetch_remote'")


def stage_time_error(samples, hw: Hardware, *,
                     onesided: bool = False) -> Dict[str, float]:
    """Model-vs-measured relative error, per stage plus "total".

    Each entry is ``|sum(predicted) - sum(measured)| / sum(measured)``
    over that stage's samples — the aggregate-throughput error a
    capacity planner cares about (per-sample jitter averages out).
    """
    meas: Dict[str, float] = {}
    pred: Dict[str, float] = {}
    for s in samples:
        meas[s.stage] = meas.get(s.stage, 0.0) + s.seconds
        pred[s.stage] = pred.get(s.stage, 0.0) \
            + predicted_stage_time(s, hw, onesided=onesided)
    out = {stage: abs(pred[stage] - meas[stage]) / meas[stage]
           for stage in meas if meas[stage] > 0}
    total = sum(meas.values())
    if total > 0:
        out["total"] = abs(sum(pred.values()) - total) / total
    return out


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Outcome of :func:`calibrate`: the fitted platform plus fit context."""

    hw: Hardware
    base: Hardware
    n_h2d: int
    n_remote: int
    onesided: bool

    def error(self, samples) -> Dict[str, float]:
        """Fitted model's stage-time error on ``samples`` (held-out or
        training — the caller picks the window)."""
        return stage_time_error(samples, self.hw, onesided=self.onesided)


def calibrate(source, base: Hardware = H100_DGX, *,
              onesided: bool = False) -> CalibrationResult:
    """Fit the serving-stage constants of ``base`` to measured spans.

    ``source`` is either an iterable of :class:`StageSample` or anything
    with a ``stage_samples()`` method (a :class:`repro_torch.obs.Tracer`).
    Two independent least-squares fits, each replacing only the
    constants its stage exercises (everything else — HBM bandwidth,
    peak FLOPs, capacities — keeps ``base``'s values):

      * "h2d" samples fit ``t = gather_overhead_s + bytes / host_Bps``
        (features ``(1, bytes)`` — intercept is the per-prefetch floor,
        slope the inverse host-link bandwidth);
      * "fetch_remote" samples fit the α–β collective model
        ``t = alpha_s * max(1, log2 n / 3) + c_op(n) * bytes /
        beta_Bps``, replacing the bulk (or, with ``onesided=True``, the
        one-sided) :class:`Transport`.

    A stage with no samples keeps ``base``'s constants; a degenerate
    slope fit (zero inverse bandwidth) pins that bandwidth to ``inf`` so
    the fitted floor alone carries the prediction.
    """
    samples = list(source.stage_samples()
                   if hasattr(source, "stage_samples") else source)
    h2d = [s for s in samples if s.stage == "h2d"]
    rem = [s for s in samples
           if s.stage == "fetch_remote" and s.n_devices > 1]
    hw = base
    if h2d:
        a, b = _fit_affine([(1.0, s.bytes) for s in h2d],
                           [s.seconds for s in h2d])
        hw = dataclasses.replace(
            hw, gather_overhead_s=a,
            host_Bps=(1.0 / b if b > 0 else math.inf))
    if rem:
        factor = _OP_FACTOR["fetch_rows"]
        a, b = _fit_affine(
            [(max(1.0, math.log2(s.n_devices) / 3.0),
              factor(s.n_devices) * s.bytes) for s in rem],
            [s.seconds for s in rem])
        fitted = Transport(
            name=(hw.onesided if onesided else hw.bulk).name + "-calibrated",
            alpha_s=a, beta_Bps=(1.0 / b if b > 0 else math.inf))
        hw = dataclasses.replace(
            hw, **({"onesided": fitted} if onesided else {"bulk": fitted}))
    hw = dataclasses.replace(hw, name=base.name + "-calibrated")
    return CalibrationResult(hw, base, len(h2d), len(rem), onesided)
