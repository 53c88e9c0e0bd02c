"""The chunk kernels of ``csrc/onesided_a2a.cu``, emulated on the CPU.

The put kernel and the pull-sum kernel run only on the card, so their
index arithmetic and their summation order are held here through an
emulation that lives in this file, not as a mode of the package:

  * the put grid (source rank, put in the rotated schedule, tile, thread,
    unit) writes every ``(source, destination, element)`` of an
    all-to-all exactly once, from the right element, for 1 to 8 ranks,
    chunks of 0, 1, 7 and 1001 elements and 16-byte-aligned ones, and for
    launches over a range of source ranks;
  * the same grid with the arguments the ring entry passes (one put per
    source, the source blocks a chunk apart) is the ring permute of all n
    ranks in one launch, ``out[(r + shift) % n] = x[r]``, for shifts up to
    n + 1, and over ranges of source ranks;
  * the pull-sum grid (tile, destination) writes every output element
    exactly once, and its arithmetic -- four partial sums ``acc[s % 4]``
    from +0.0, sources in rank order, combined left to right, rounded once
    -- is bitwise-equal to ``onesided_reduce_scatter_ref`` and to
    ``x.sum(0)`` for f32, bf16 and int32 at E <= 4, with -0.0 sources and
    int32 sums that overflow.

Tolerance at E > 4: the CPU's sum adds the E sources one after another,
the kernel (as PyTorch's sum on the card, bitwise there) in four partial
sums, so two orders of the same E f32 terms: each differs from the exact
sum by at most (E - 1) * 2**-24 * sum|x|, so the two by twice that.  A
bf16 result rounds each once more: one bf16 ulp, at most 2**-7 * |sum|,
on top.  int32 sums wrap, and wrap alike in any order: bitwise.

Also: CPU calls launch nothing and count nothing, a tensor on neither the
CPU nor a card is refused, and the source names what it replaces and what
bounds it.  The constants of the emulation are read from the source.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import comm
from repro_torch.kernels import onesided_a2a as oa

SOURCE = (Path(oa.__file__).resolve().parents[1] / "csrc"
          / "onesided_a2a.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr \w+(?: \w+)? {name} = (\d+);",
                         SOURCE).group(1))


THREADS, UNROLL, PARTS = _const("kThreads"), _const("kUnroll"), \
    _const("kParts")
CHUNKS = [0, 1, 7, 1001, 1024]
ITEMSIZES = {torch.int32: 4, torch.float32: 4, torch.bfloat16: 2}


def _units(chunk: int, itemsize: int):
    """(units, elements per unit): 16-byte units when the chunk's bytes
    are a multiple of 16 (the wrapper's rule, for aligned bases)."""
    per = 16 // itemsize if (chunk * itemsize) % 16 == 0 else 1
    return chunk // per, per


def _put_grid(E, first, count, units):
    """Every (source r, destination d, unit u) one put launch touches, by
    the kernel's arithmetic: block (x, y, z) is source r = first + z, put y
    to d = (r + 1 % E + y) % E, units x * kTile + t + k * kThreads."""
    tiles = -(-units // (THREADS * UNROLL))
    z, y, bx, t, k = np.meshgrid(np.arange(count), np.arange(E),
                                 np.arange(tiles), np.arange(THREADS),
                                 np.arange(UNROLL), indexing="ij")
    r = first + z
    d = (r + 1 % E + y) % E
    u = bx * THREADS * UNROLL + t + k * THREADS
    live = u < units
    return r[live], d[live], u[live]


def _sum_grid(first, count, units):
    """Every (destination j of the launch, unit u) of one pull-sum launch:
    block (x, y) is tile x of destination first + y, unit x * kThreads +
    t."""
    tiles = -(-units // THREADS)
    y, bx, t = np.meshgrid(np.arange(count), np.arange(tiles),
                           np.arange(THREADS), indexing="ij")
    u = bx * THREADS + t
    live = u < units
    return y[live], u[live]


def _emulate_pull_sum(x: torch.Tensor, first=0, count=None):
    """The pull-sum kernel on ``x`` (E, E, C): the grid's reads and its
    arithmetic, destination by destination."""
    E, _, C = x.shape
    count = E - first if count is None else count
    units, per = _units(C, ITEMSIZES[x.dtype])
    j, u = _sum_grid(first, count, units)
    out = torch.empty((count, C), dtype=x.dtype)
    if C == 0:
        return out
    elems = (u[:, None] * per + np.arange(per)).reshape(-1)
    jj = np.repeat(j, per)
    acc_t = torch.int64 if x.dtype == torch.int32 else torch.float32
    parts = [torch.zeros(len(elems), dtype=acc_t) for _ in range(PARTS)]
    for s in range(E):
        src = x[s].reshape(-1)          # rank s's send buffer
        parts[s % PARTS] = parts[s % PARTS] + src[
            torch.from_numpy((first + jj) * C + elems)].to(acc_t)
    r = parts[0]
    for p in range(1, PARTS):
        r = r + parts[p]
    if x.dtype == torch.int32:
        r = (r + 2**31) % 2**32 - 2**31        # the unsigned sum's bits
    flat = out.reshape(-1)
    flat[torch.from_numpy(jj * C + elems)] = r.to(x.dtype)
    return out


def _bits(x):
    return x.view({4: torch.int32, 2: torch.int16}[x.element_size()])


def _same(got, want) -> bool:
    return got.dtype == want.dtype and got.shape == want.shape \
        and torch.equal(_bits(got), _bits(want))


def _chunks(rng, e, c, dtype):
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2**31, 2**31, (e, e, c))
                                .astype(np.int32))
    return torch.from_numpy(rng.standard_normal((e, e, c))
                            .astype(np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# the put kernel's grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("e", range(1, 9))
def test_put_grid_writes_each_element_once(e, c, itemsize):
    """One launch for all sources: every (source, destination, element)
    written once, with the element the source holds for that destination;
    launches over ranges of sources that tile [0, E) write disjoint parts
    of the same whole."""
    units, per = _units(c, itemsize)
    x = np.arange(e * e * c).reshape(e, e, c)
    r, d, u = _put_grid(e, 0, e, units)
    assert len(r) == e * e * units
    elems = (u[:, None] * per + np.arange(per)).reshape(-1)
    r, d = np.repeat(r, per), np.repeat(d, per)
    out = np.full(e * e * c, -1)
    target = d * e * c + r * c + elems          # buffer d, row r
    assert len(np.unique(target)) == len(target) == e * e * c
    out[target] = x.reshape(-1)[r * e * c + d * c + elems]
    np.testing.assert_array_equal(out.reshape(e, e, c), x.transpose(1, 0, 2))
    cuts = sorted({0, e // 3, e // 2, e})
    seen = [_put_grid(e, a, b - a, units) for a, b in zip(cuts, cuts[1:])
            if b > a]
    rs = np.concatenate([s[0] for s in seen])
    ds = np.concatenate([s[1] for s in seen])
    us = np.concatenate([s[2] for s in seen])
    keys = (rs * e + ds) * max(units, 1) + us
    assert len(np.unique(keys)) == len(keys) == e * e * units


def _ring_args():
    """The put-grid arguments ``onesided_ring_put`` passes to
    ``dispatch_puts`` after the table: (first put, puts, source-rank step,
    source step, destination step), as source text."""
    body = SOURCE[SOURCE.index('extern "C" int onesided_ring_put'):]
    call = re.search(r"dispatch_puts\(([^;]*)\);", body).group(1)
    args = [a.strip() for a in call.split(",")]
    return args[5], args[6], args[8], args[9], args[10]


def _ring_grid(n, first, count, units, shift):
    """Every (source r, destination d, source unit, destination unit) of
    one ring launch, by the put kernel's arithmetic with the arguments the
    ring entry passes: block (x, y, z) is source r = first + z, put y to
    d = (r + first_put + y) % n, reading src + z * src_rank_step + d *
    src_step + u (src = rank first's block) and writing buffer d at r *
    dst_step + u."""
    first_put, puts, rank_step, src_step, dst_step = _ring_args()
    assert (first_put, puts) == ("shift % num_ranks", "1")
    assert (rank_step, src_step, dst_step) == ("chunk", "0", "0")
    tiles = -(-units // (THREADS * UNROLL))
    z, y, bx, t, k = np.meshgrid(np.arange(count), np.arange(1),
                                 np.arange(tiles), np.arange(THREADS),
                                 np.arange(UNROLL), indexing="ij")
    r = first + z
    d = (r + shift % n + y) % n
    u = bx * THREADS * UNROLL + t + k * THREADS
    live = u < units
    src_u = first * units + z * units + u       # rank r's block, unit u
    return r[live], d[live], src_u[live], u[live]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("n", range(1, 9))
def test_ring_grid_is_one_launch_for_all_ranks(n, c, itemsize):
    """One ring launch over all n sources writes every unit of every
    destination block exactly once, from the block of the rank that puts
    there: out[(r + shift) % n] = x[r], for shifts 0 .. n + 1; launches
    over ranges of sources that tile [0, n) write disjoint parts of the
    same whole (one rank per card passes (r, 1))."""
    units, per = _units(c, itemsize)
    x = np.arange(n * c).reshape(n, c)
    for shift in range(n + 2):
        r, d, su, du = _ring_grid(n, 0, n, units, shift)
        assert len(r) == n * units
        target = d * units + du
        assert len(np.unique(target)) == len(target) == n * units
        elems = np.arange(per)
        out = np.full(n * c, -1)
        out[(target[:, None] * per + elems).reshape(-1)] = x.reshape(-1)[
            (su[:, None] * per + elems).reshape(-1)]
        np.testing.assert_array_equal(out.reshape(n, c), np.roll(x, shift, 0))
        cuts = sorted({0, n // 3, n // 2, n})
        parts = [_ring_grid(n, a, b - a, units, shift)
                 for a, b in zip(cuts, cuts[1:]) if b > a]
        keys = np.concatenate([p[1] * units + p[3] for p in parts])
        assert len(np.unique(keys)) == len(keys) == n * units
        for p in parts:
            assert ((p[0] + shift) % n == p[1]).all()


# ---------------------------------------------------------------------------
# the pull-sum kernel's grid and arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("e", range(1, 9))
def test_pull_sum_grid_writes_each_output_once(e, c, itemsize):
    units, _ = _units(c, itemsize)
    for first, count in ((0, e), (e // 2, e - e // 2), (e - 1, 1)):
        j, u = _sum_grid(first, count, units)
        keys = j * max(units, 1) + u
        assert len(np.unique(keys)) == len(keys) == count * units


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("e", [1, 2, 3, 4])
def test_pull_sum_is_the_plain_sum_bitwise(e, c, dtype):
    """At E <= 4 the four partial sums are the rank order from +0.0:
    bitwise the plain version and x.sum(0), for random values, -0.0
    sources and exact cancellations, and int32 sums that overflow."""
    rng = np.random.default_rng(1000 * e + c)
    x = _chunks(rng, e, c, dtype)
    if dtype != torch.int32 and c:
        x[..., : c // 2] = -0.0                 # every source -0.0
        if e > 1:                               # rank 1 cancels rank 0
            x[1, :, c // 2:] = -x[0, :, c // 2:]
    got = _emulate_pull_sum(x)
    assert _same(got, oa.onesided_reduce_scatter_ref(x))
    assert _same(got, x.sum(0, dtype=x.dtype))
    if dtype != torch.int32 and c:
        assert _same(got[:, : c // 2], torch.zeros_like(got[:, : c // 2]))


@pytest.mark.parametrize("e", [2, 3, 4])
def test_pull_sum_int32_wraps(e):
    x = torch.full((e, e, 1001), 2**31 - 1, dtype=torch.int32)
    got = _emulate_pull_sum(x)
    assert _same(got, oa.onesided_reduce_scatter_ref(x))
    want = (x.long().sum(0) + 2**31) % 2**32 - 2**31
    assert torch.equal(got.long(), want) and not torch.equal(
        got.long(), x.long().sum(0))


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("e", [5, 6, 7, 8])
def test_pull_sum_more_than_four_ranks(e, dtype):
    """Beyond 4 ranks a partial sum takes sources s, s + 4, ...: against
    the CPU's one-after-another order, bitwise for int32 and within two
    f32 orders' bound (one bf16 ulp more for bf16) for floats."""
    rng = np.random.default_rng(e)
    x = _chunks(rng, e, 1001, dtype)
    got = _emulate_pull_sum(x)
    want = oa.onesided_reduce_scatter_ref(x)
    if dtype == torch.int32:
        assert _same(got, want)
        return
    assert got.dtype == dtype and got.shape == want.shape
    bound = 2 * (e - 1) * 2.0**-24 * x.float().abs().sum(0)
    if dtype == torch.bfloat16:
        bound = bound + 2.0**-7 * want.float().abs()
    assert bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_ranged_pull_sum_is_the_slice(dtype):
    """A launch over destinations (first, count) is that slice of the
    whole: one rank per card would pass (r, 1)."""
    rng = np.random.default_rng(7)
    x = _chunks(rng, 4, 1001, dtype)
    full = _emulate_pull_sum(x)
    for first, count in ((1, 2), (3, 1), (0, 1)):
        assert _same(_emulate_pull_sum(x, first, count),
                     full[first:first + count])


# ---------------------------------------------------------------------------
# the wrappers on the CPU, and the source
# ---------------------------------------------------------------------------

def test_cpu_calls_launch_nothing_and_count_nothing():
    oa.reset_launch_counts()
    x = torch.randn((4, 4, 5, 3))
    oa.onesided_all_to_all(x)
    oa.onesided_reduce_scatter(x)
    oa.onesided_reduce_scatter(x.to(torch.int32))
    oa.onesided_ring_permute(x[0], 1)
    oa.onesided_fetch_rows(x)
    comm.reduce_scatter(x, backend="onesided")
    comm.all_to_all(x, backend="onesided")
    assert set(oa.LAUNCH_COUNTS.values()) == {0}


@pytest.mark.parametrize("fn", [
    oa.onesided_all_to_all, oa.onesided_reduce_scatter,
    oa.onesided_put_rows, oa.onesided_fetch_rows,
    lambda a: oa.onesided_ring_permute(a, 1)])
def test_meta_tensors_are_refused(fn):
    """No silent fallback: a tensor on neither the CPU nor a card raises,
    and counts nothing."""
    oa.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.empty((4, 4, 2, 3), device="meta"))
    assert set(oa.LAUNCH_COUNTS.values()) == {0}


def test_source_names_what_it_replaces_and_what_bounds_it():
    for name in ("onesided_all_to_all", "onesided_reduce_scatter",
                 "onesided_ring_permute", "onesided_fetch_rows",
                 "src/repro/kernels/onesided_a2a.py", "put_chunks_kernel",
                 "sum_chunks_kernel", "What bounds both: device-memory bytes",
                 "thread_reduce_impl"):
        assert name in SOURCE, name
    assert len(re.findall(r"__global__", SOURCE)) == 3
    assert _const("kMaxRanks") == oa.MAX_RANKS
