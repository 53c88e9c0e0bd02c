"""The chunk kernels of ``csrc/onesided_a2a.cu`` against their plain
versions, on an NVIDIA card.

Every test here is marked ``cuda`` and skips without a card: the kernels
have no CPU mode, and ``tests/test_torch_chunks.py`` holds their index
arithmetic and summation order on the CPU.  On a machine with an H100,
from the repository root:

    python -m pytest -q -m cuda tests/test_torch_chunks_card.py

The cases are the edges that ``chip_smoke.py``'s main-path shapes do not
reach: 1 to 8 ranks, chunks of 0, 1 and odd lengths beside 16-byte-aligned
ones, views whose base is not 16-byte aligned, bf16 sums that cancel,
int32 sums that wrap, ``-0.0`` sources, launches over a range of ranks
short of all E, and the ring permute (one launch for all ranks) at every
shift up to n + 1 and over ranges of source ranks, and the pull-sum at
every rank count from 9 to ``MAX_RANKS``; and, with each rank a process
(``core.parallel.run_ranks``, 2 and 4 processes sharing the card), the
put, the pull-sum and the all-reduce through the peers' symmetric
buffers, and a peer's handle that does not open.  Every comparison is bitwise:
the puts copy bits, and the pull-sum adds in the order of PyTorch's CUDA
sum over an outer dimension (four partial sums, combined left to right),
for any E up to ``MAX_RANKS``.  One exception:
with chunks of ONE element the plain version's sum over sources runs over
a contiguous dimension, where PyTorch's CUDA reduction takes another order,
so there a float result is held to the plain version within two f32 orders'
bound, 2 * (E - 1) * 2**-24 * sum|x| (one bf16 ulp, 2**-7 * |sum|, more for
bf16), and stays bitwise against ``x.sum(0)``.  This file imports no JAX,
so that it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.core import comm
from repro_torch.kernels import onesided_a2a as oa

DTYPES = [torch.int32, torch.float32, torch.bfloat16]
RANKS = [1, 2, 3, 4, 5, 8]
CHUNKS = [0, 1, 7, 1001, 1024]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chunk kernels have no CPU mode")
    return torch.device("cuda")


def _bits(x):
    """Raw bits, so that -0.0 and 0.0 differ."""
    return x.view({4: torch.int32, 2: torch.int16}[x.element_size()])


def _same(got, want) -> bool:
    return got.dtype == want.dtype and got.shape == want.shape \
        and torch.equal(_bits(got), _bits(want))


def _chunks(g, e, c, dtype, device):
    """(e, e, c) send buffers: N(0, 1) floats, or int32 over the whole
    range (sums over ranks overflow)."""
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, (e, e, c), generator=g,
                             device=device, dtype=torch.int32)
    return torch.randn((e, e, c), generator=g, device=device).to(dtype)


def _misaligned(x):
    """A contiguous copy of x whose base lies one element past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


def _check_a2a(x):
    oa.reset_launch_counts()
    got = oa.onesided_all_to_all(x)
    torch.cuda.synchronize()
    assert oa.LAUNCH_COUNTS["onesided_all_to_all"] == (1 if x[0, 0].numel()
                                                       else 0)
    assert _same(got, oa.onesided_all_to_all_ref(x))
    assert _same(got, x.transpose(0, 1).contiguous())


def _check_rs(x):
    oa.reset_launch_counts()
    got = oa.onesided_reduce_scatter(x)
    torch.cuda.synchronize()
    assert oa.LAUNCH_COUNTS["onesided_reduce_scatter"] == (
        1 if x[0, 0].numel() else 0)
    plain = oa.onesided_reduce_scatter_ref(x)
    if x[0, 0].numel() == 1 and x.dtype != torch.int32:
        bound = 2 * (x.shape[0] - 1) * 2.0**-24 * x.float().abs().sum(0)
        if x.dtype == torch.bfloat16:
            bound = bound + 2.0**-7 * plain.float().abs()
        assert got.dtype == plain.dtype and got.shape == plain.shape
        assert bool(((got.float() - plain.float()).abs() <= bound).all())
    else:
        assert _same(got, plain)
    assert _same(got, x.sum(0, dtype=x.dtype))
    assert _same(got, comm.reduce_scatter(x, backend="bulk"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("e", RANKS)
def test_all_to_all_matches_plain_version(card, e, c, dtype):
    g = torch.Generator(device=card).manual_seed(100 * e + c)
    x = _chunks(g, e, c, dtype, card)
    _check_a2a(x)
    if c:
        _check_a2a(_misaligned(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("e", RANKS)
def test_reduce_scatter_matches_plain_version(card, e, c, dtype):
    g = torch.Generator(device=card).manual_seed(200 * e + c)
    x = _chunks(g, e, c, dtype, card)
    _check_rs(x)
    if c:
        _check_rs(_misaligned(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 16, 67, 68])
def test_reduce_scatter_keeps_the_sum_order_up_to_max_ranks(card, c, dtype):
    """Every rank count from 9 to ``MAX_RANKS`` (63): the pull-sum bitwise
    ``x.sum(0)``, on rows of 4-element multiples (chunks 16 and 68; at 64
    ranks PyTorch's sum splits the sources across threads there) and not
    (1, 67)."""
    g = torch.Generator(device=card).manual_seed(300 + c)
    for e in range(9, oa.MAX_RANKS + 1):
        x = _chunks(g, e, c, dtype, card)
        assert _same(oa.onesided_reduce_scatter(x), x.sum(0, dtype=dtype)), e


def _four_partials(x):
    """The pull-sum's order in f32 elementwise adds: partial ``s % 4``
    takes source s in rank order, then ((p0 + p1) + p2) + p3."""
    acc = [torch.zeros_like(x[0], dtype=torch.float32) for _ in range(4)]
    for s in range(x.shape[0]):
        acc[s % 4] = acc[s % 4] + x[s].float()
    return (((acc[0] + acc[1]) + acc[2]) + acc[3]).to(x.dtype)


@pytest.mark.cuda
def test_sum_order_parts_at_one_rank_past_max_ranks(card):
    """Why ``MAX_RANKS`` is 63: on f32 rows of 4-element multiples the
    pull-sum's order (emulated, and equal to the kernel's at 63 ranks)
    is ``x.sum(0)``'s at 63 sources and not at 64, where PyTorch splits
    the sources across 4 threads of a block."""
    g = torch.Generator(device=card).manual_seed(401)
    x = torch.randn((oa.MAX_RANKS,) * 2 + (68,), generator=g, device=card)
    assert _same(_four_partials(x), oa.onesided_reduce_scatter(x))
    assert _same(_four_partials(x), x.sum(0))
    y = torch.randn((oa.MAX_RANKS + 1,) * 2 + (68,), generator=g,
                    device=card)
    assert not _same(_four_partials(y), y.sum(0))


@pytest.mark.cuda
@pytest.mark.parametrize("e", RANKS)
def test_reduce_scatter_int32_wraps(card, e):
    """int32 sums that overflow wrap modulo 2**32, as x.sum(0) does."""
    x = torch.full((e, e, 1001), 2**31 - 1, dtype=torch.int32, device=card)
    x[:, :, ::2] = -2**31
    got = oa.onesided_reduce_scatter(x)
    assert _same(got, x.sum(0, dtype=torch.int32))
    want = (x.long().sum(0) + 2**31) % 2**32 - 2**31
    assert torch.equal(got.long(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e", RANKS)
def test_reduce_scatter_negative_zeros_and_cancellation(card, e, dtype):
    """Sources of -0.0 sum to +0.0; neighbouring ranks' x and -x cancel
    exactly; a bf16 sum of 1 and (E - 1) * 2**-9 rounds once, from f32 (a
    bf16 running sum would stay at 1)."""
    c = 1024
    x = torch.full((e, e, c), -0.0, device=card)
    g = torch.Generator(device=card).manual_seed(e)
    v = torch.randn((e // 2, e, c), generator=g, device=card)
    x[0:2 * (e // 2):2] = v
    x[1:2 * (e // 2):2] = -v
    x[..., :8] = -0.0                                  # every source -0.0
    x[..., 8] = 2.0 ** -9
    x[0, :, 8] = 1.0
    x = x.to(dtype)
    _check_rs(x)
    _check_rs(_misaligned(x))
    got = oa.onesided_reduce_scatter(x)
    assert torch.equal(_bits(got[..., :8]), _bits(torch.zeros_like(
        got[..., :8])))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e, first, count", [(4, 1, 2), (4, 3, 1),
                                             (8, 0, 3), (8, 5, 3),
                                             (3, 1, 2)])
def test_ranged_launch_matches_the_slice(card, e, first, count, dtype):
    """A launch over ranks first .. first + count - 1 (one rank per card
    would pass (r, 1)): the pull-sum gives the full result's destinations
    of that range, the puts fill that range's sources in every buffer."""
    g = torch.Generator(device=card).manual_seed(e + 10 * first)
    for c in (1001, 1024):
        x = _chunks(g, e, c, dtype, card)
        full = oa.onesided_reduce_scatter_ref(x)
        part = oa._launch_pull_sum(x, first, count)
        assert _same(part, full[first:first + count])
        put = oa._launch_all_to_all(x, "onesided_all_to_all", first, count)
        torch.cuda.synchronize()
        want = oa.onesided_all_to_all_ref(x)
        assert _same(put[:, first:first + count].contiguous(),
                     want[:, first:first + count].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("e", [1, 3, 4])
def test_put_rows_and_ring_launches(card, e):
    """The row exchange is one launch for all hosts, and so is the ring for
    all ranks."""
    g = torch.Generator(device=card).manual_seed(e)
    c = torch.randn((e, e, 33, 10), generator=g, device=card)
    oa.reset_launch_counts()
    got = oa.onesided_put_rows(c)
    fetched = oa.onesided_fetch_rows(c)
    ring = oa.onesided_ring_permute(c[0], 1)
    torch.cuda.synchronize()
    assert oa.LAUNCH_COUNTS == {"onesided_put_rows": 2,
                                "onesided_all_to_all": 0,
                                "onesided_reduce_scatter": 0,
                                "onesided_ring_permute": 1}
    assert _same(got, oa.onesided_put_rows_ref(c))
    assert _same(fetched, oa.onesided_fetch_rows_ref(c))
    assert _same(ring, torch.roll(c[0], 1, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("e", RANKS + [7])
def test_ring_matches_plain_version(card, e, c, dtype):
    """The ring, one launch for all ranks, bitwise with its plain version
    and torch.roll, for every shift up to n + 1, on 16-byte units and on
    element units (a base that is not 16-byte aligned)."""
    g = torch.Generator(device=card).manual_seed(300 * e + c)
    x = _chunks(g, 1, e * c, dtype, card).reshape(e, c)
    for src in ((x, _misaligned(x)) if c else (x,)):
        for shift in range(e + 2):
            oa.reset_launch_counts()
            got = oa.onesided_ring_permute(src, shift)
            torch.cuda.synchronize()
            assert oa.LAUNCH_COUNTS["onesided_ring_permute"] == (
                1 if c else 0)
            assert _same(got, oa.onesided_ring_permute_ref(src, shift))
            assert _same(got, torch.roll(src, shift, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e, first, count", [(1, 0, 1), (2, 1, 1),
                                             (3, 0, 2), (4, 1, 2),
                                             (4, 3, 1), (5, 2, 3),
                                             (8, 0, 3), (8, 5, 3)])
def test_ranged_ring_fills_its_sources_blocks(card, e, first, count, dtype):
    """A ring launch over sources first .. first + count - 1 (one rank per
    card would pass (r, 1)) fills exactly the blocks those sources put,
    out[(r + shift) % n], and tiles with the other ranges into the
    whole."""
    g = torch.Generator(device=card).manual_seed(e + 10 * first)
    for c in (1001, 1024):
        x = _chunks(g, 1, e * c, dtype, card).reshape(e, c)
        for shift in (1, e + 1):
            want = oa.onesided_ring_permute_ref(x, shift)
            part = oa._launch_ring(x, shift, first, count)
            torch.cuda.synchronize()
            dst = [(r + shift) % e for r in range(first, first + count)]
            assert _same(part[dst], want[dst])
            whole = torch.empty_like(x)
            for a, n in ((0, first), (first, count),
                         (first + count, e - first - count)):
                if n:
                    got = oa._launch_ring(x, shift, a, n)
                    rows = [(r + shift) % e for r in range(a, a + n)]
                    whole[rows] = got[rows]
            torch.cuda.synchronize()
            assert _same(whole, want)


@pytest.mark.cuda
def test_launcher_refuses_bad_ranges(card):
    """A range outside the ranks is refused by the launcher, with its
    cudaError_t string, more ranks than a launch's table holds by the
    wrapper, and neither counts anything."""
    x = torch.zeros((4, 4, 16), device=card)
    oa.reset_launch_counts()
    with pytest.raises(RuntimeError, match="invalid argument"):
        oa._launch_pull_sum(x, 3, 2)
    with pytest.raises(RuntimeError, match="invalid argument"):
        oa._launch_all_to_all(x, "onesided_all_to_all", 2, 3)
    with pytest.raises(RuntimeError, match="invalid argument"):
        oa._launch_ring(x[0], 1, 2, 3)
    many = torch.zeros((oa.MAX_RANKS + 1, oa.MAX_RANKS + 1, 1), device=card)
    for fn in (oa.onesided_all_to_all, oa.onesided_reduce_scatter):
        with pytest.raises(ValueError, match=f"at most {oa.MAX_RANKS}"):
            fn(many)
    assert set(oa.LAUNCH_COUNTS.values()) == {0}


# ---------------------------------------------------------------------------
# one rank per process: the put and the pull-sum across processes sharing
# the card, through the peers' symmetric buffers (CUDA IPC)
# ---------------------------------------------------------------------------

PROC_WORLDS = [2, 4]
PROC_CASES = [(dtype, c) for dtype in DTYPES for c in (0, 1, 1001, 1024)]


def _proc_cases(ctx):
    """Every case on this rank: the rank's own chunks of stacked inputs
    that every rank draws alike, through the per-rank wrappers, against
    the plain versions of the stacked inputs; each case's launches."""
    e, r = ctx.world, ctx.rank
    out = {}
    for dtype, c in PROC_CASES:
        g = torch.Generator(device=ctx.device).manual_seed(100 * e + c)
        xs = _chunks(g, e, c, dtype, ctx.device)          # (E_src, E, c)
        x = xs[r].contiguous()
        oa.reset_launch_counts()
        put = comm.all_to_all(x, backend="onesided", ctx=ctx)
        rs = comm.reduce_scatter(x, backend="onesided", ctx=ctx)
        ar = comm.all_reduce(x, backend="onesided", ctx=ctx)
        torch.cuda.synchronize()
        plain_rs = oa.onesided_reduce_scatter_ref(xs)[r]
        if c == 1 and dtype != torch.int32:
            # the plain version's sum runs over a contiguous dimension:
            # PyTorch's other order (see _check_rs); x.sum(0) is the
            # kernel's
            plain_rs = xs.sum(0, dtype=dtype)[r]
        out[(dtype, c)] = dict(
            put=_same(put, oa.onesided_all_to_all_ref(xs)[r]),
            rs=_same(rs, plain_rs),
            rs_sum0=_same(rs, xs.sum(0, dtype=dtype)[r]),
            ar=_same(ar, xs.sum(0, dtype=dtype)),
            launches=dict(oa.LAUNCH_COUNTS))
    # a handle that does not open raises: no fallback to a bulk collective
    real = oa.dist.all_gather_object

    def garbage(handles, obj, group=None):
        real(handles, obj, group=group)
        for i in range(len(handles)):
            if i != r:
                handles[i] = bytes(len(obj))

    oa.dist.all_gather_object = garbage
    try:
        oa.SymmetricBuffers(ctx.group, r, e, ctx.device, 1 << 20)
        out["bad_handle"] = None
    except RuntimeError as err:
        out["bad_handle"] = str(err)
    finally:
        oa.dist.all_gather_object = real
    gathered = [None] * e
    torch.distributed.all_gather_object(gathered, out, group=ctx.group)
    return gathered


@pytest.fixture(scope="module")
def proc_results():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chunk kernels have no CPU mode")
    from repro_torch.core import parallel

    return {e: parallel.run_ranks(_proc_cases, e, backend="gloo",
                                  device="cuda:0", timeout_s=300)
            for e in PROC_WORLDS}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, c", PROC_CASES)
@pytest.mark.parametrize("e", PROC_WORLDS)
def test_processes_put_and_pull_sum_match_plain_versions(proc_results, e,
                                                         dtype, c):
    """Each rank a process on one card: its puts land in the peers'
    buffers as the plain all-to-all's chunks, its pull-sums read the
    peers' send buffers into the plain reduce-scatter's and x.sum(0)'s
    bits; one launch of each per call (none for an empty chunk)."""
    want = dict(onesided_all_to_all=1 if c else 0,
                onesided_reduce_scatter=2 if c else 0)
    for rank, out in enumerate(proc_results[e]):
        got = out[(dtype, c)]
        assert got["put"] and got["rs"] and got["rs_sum0"] and got["ar"], \
            (rank, got)
        assert {k: got["launches"][k] for k in want} == want


@pytest.mark.cuda
@pytest.mark.parametrize("e", PROC_WORLDS)
def test_processes_refuse_a_handle_that_does_not_open(proc_results, e):
    for out in proc_results[e]:
        assert out["bad_handle"] is not None
        assert "cudaIpcOpenMemHandle" in out["bad_handle"]
