"""The TBE gather-pool kernel of ``csrc/tbe_gather_pool.cu`` at the edges
that ``chip_smoke.py``'s main-path shapes do not reach, on an NVIDIA card.

Every test here is marked ``cuda`` and skips without a card: the kernel has
no CPU mode, and ``tests/test_torch_tbe_schedule.py`` holds its schedule on
the CPU.  On a machine with an H100, from the repository root:

    python -m pytest -q -m cuda tests/test_torch_tbe_card.py

The cases: odd D (the scalar path) and D over 128 (more than one pass of the
warp over a row), pooling lengths around and over the kernel's 32-slot
windows and 8-row groups, and around the 4-row groups of a grid larger than
the SMs hold at once, bf16 tables, ids at the last row of the
allocation, ``-1`` padding at slot 0 of every bag (every case synchronises
after its launches, so that a stray read faults in the case that made
it), bags of live ids with zero weights, and tables whose base is not
aligned to four elements (the scalar path at D % 4 == 0).

Every case is bitwise across the three wrappers over the same rows: the
stacked tables (table t at row t * R, passed as a stride), the flat view
with the same offsets passed as an array, a compact pool holding only the
rows the bags read, and one table at a time; the scalar path is bitwise
with the vector path.  Each output element is the same FMA chain from +0.0
over the live slots in ascending order in every launch shape, so nothing
else is right.  Against the plain version (an einsum in another order) the
kernel is held to ``POOL_TOL``, ``rtol=atol=1e-5``: two f32 orders of L
terms differ by at most about L * 2**-24 * sum|w * x|, and with rows of
N(0, 1/D) and weights in [0, 1) the errors are about 1e-7.  This file
imports no JAX, so that it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.kernels import embedding_gather as eg

POOL_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the TBE kernel has no CPU mode")
    return torch.device("cuda")


def _bits(x):
    return x.view(torch.int32)


def _case(card, t, b, lp, r, d, dtype, seed, pad_first=True, last_row=False,
          zero_every=0):
    """(tables, idx, w): rows of N(0, 1/d) in ``dtype``, lengths in
    [0, lp] (bags of length 0 among them), -1 beyond each bag's length and,
    with ``pad_first``, at slot 0 of every bag with weight 0; with
    ``last_row`` every live id is r - 1; with ``zero_every`` every such
    bag keeps its ids and gets weight 0."""
    g = torch.Generator(device=card).manual_seed(seed)
    tables = (torch.randn((t, r, d), generator=g, device=card)
              * d ** -0.5).to(dtype)
    lens = torch.randint(0, lp + 1, (t, b), generator=g, device=card)
    mask = torch.arange(lp, device=card) < lens[..., None]
    if pad_first and lp:
        mask[..., 0] = False
    ids = (torch.full((t, b, lp), r - 1, device=card, dtype=torch.int32)
           if last_row else
           torch.randint(0, r, (t, b, lp), generator=g, device=card,
                         dtype=torch.int32))
    idx = torch.where(mask, ids, -1).to(torch.int32)
    w = torch.rand((t, b, lp), generator=g, device=card) * mask
    if zero_every:
        w[:, ::zero_every] = 0.0
    return tables, idx, w


def _compact(tables, idx, w):
    """A flat pool holding only the rows the bags read, table after table,
    the ids that address it and its (T,) offsets: the slot-pool layout."""
    rows, counts = [], []
    slots = torch.zeros_like(idx)
    live = w != 0
    for t in range(tables.shape[0]):
        uniq, inv = torch.unique(idx[t][live[t]].long(), return_inverse=True)
        rows.append(tables[t, uniq])
        counts.append(uniq.numel())
        slots[t][live[t]] = inv.to(torch.int32)
    pool = torch.cat(rows)
    if pool.shape[0] == 0:                      # nothing live: one spare row
        pool = torch.zeros_like(tables[0, :1])
    off = torch.tensor([0] + counts[:-1], device=idx.device).cumsum(0)
    return pool.contiguous(), off.to(torch.int32), slots


def _misaligned(tables):
    """A contiguous copy of ``tables`` whose base lies one element past a
    four-element boundary (the scalar path)."""
    buf = torch.empty(tables.numel() + 1, dtype=tables.dtype,
                      device=tables.device)
    view = buf[1:].view(tables.shape)
    view.copy_(tables)
    assert view.data_ptr() % (4 * view.element_size()) != 0
    return view


def _check(tables, idx, w):
    """Every layout bitwise-equal to the stacked launch, one launch each,
    and the stacked launch within POOL_TOL of the plain version."""
    t, r, d = tables.shape
    eg.reset_launch_counts()
    stacked = eg.gather_pool_tbe(tables, idx, w)
    torch.cuda.synchronize()
    assert eg.LAUNCH_COUNTS["gather_pool_tbe"] == 1
    assert stacked.dtype == torch.float32 and stacked.shape == (
        t, idx.shape[1], d)
    flat = tables.view(t * r, d)
    starts = (torch.arange(t, device=tables.device) * r).to(torch.int32)
    assert torch.equal(eg.gather_pool_tbe_flat(flat, starts, idx, w),
                       stacked)
    pool, off, slots = _compact(tables, idx, w)
    assert torch.equal(eg.gather_pool_tbe_flat(pool, off, slots, w), stacked)
    for k in range(t):
        assert torch.equal(eg.gather_pool(tables[k], idx[k], w[k]),
                           stacked[k])
    torch.cuda.synchronize()
    assert eg.LAUNCH_COUNTS == {"gather_pool": t, "gather_pool_tbe": 1,
                                "gather_pool_tbe_flat": 2}
    want = eg.gather_pool_tbe_ref(tables, idx, w)
    assert torch.allclose(stacked, want, **POOL_TOL), \
        float((stacked - want).abs().max())
    dead = (w == 0).all(-1)
    assert torch.equal(_bits(stacked[dead]),
                       torch.zeros_like(_bits(stacked[dead])))
    return stacked


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 3, 10, 33, 127, 132, 256, 260, 384])
def test_odd_and_wide_dims(card, d, dtype):
    """The scalar path (D % 4 != 0) and more than one pass of the warp over
    a row (D over 32 scalar, over 128 vector)."""
    _check(*_case(card, 3, 50, 12, 500, d, dtype, seed=d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lp", [0, 1, 7, 8, 9, 16, 17, 31, 32, 33, 64, 100])
def test_pooling_lengths(card, lp, dtype):
    """Lengths around the 8-row groups and the 32-slot windows, and over
    32: two and four windows a bag."""
    _check(*_case(card, 3, 200, lp, 1000, 128, dtype, seed=lp))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lp", [1, 3, 4, 5, 8, 9, 33])
def test_pooling_lengths_wide_grid(card, lp, dtype):
    """26 x 200 bags, more than 132 SMs hold at once: the stacked f32
    launch takes 4-row groups, the single-table launches 8-row groups,
    bitwise all the same."""
    _check(*_case(card, 26, 200, lp, 300, 128, dtype, seed=lp + 300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [10, 128, 256])
def test_ids_at_the_last_row(card, d, dtype):
    """Every live id is the last row of its table: the last table's is the
    last row of the allocation."""
    tables, idx, w = _case(card, 2, 64, 40, 300, d, dtype, seed=7,
                           last_row=True)
    out = _check(tables, idx, w)
    want = torch.einsum("tb,td->tbd", w.sum(-1), tables[:, -1].float())
    assert torch.allclose(out, want, **POOL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [10, 128])
def test_padding_at_slot_zero_is_never_read(card, d, dtype):
    """-1 at slot 0 of every bag, and every bag of one table padded
    throughout: a read of row -1 of the first table would lie before the
    allocation."""
    tables, idx, w = _case(card, 2, 128, 33, 200, d, dtype, seed=11)
    idx[0] = -1
    w[0] = 0.0
    out = _check(tables, idx, w)
    assert torch.equal(_bits(out[0]), torch.zeros_like(_bits(out[0])))


@pytest.mark.cuda
@pytest.mark.parametrize("lp", [1, 32, 64])
def test_zero_weight_bags_with_live_ids(card, lp):
    """Bags whose ids are in range but whose weights are all 0 pool to
    +0.0 and read nothing."""
    tables, idx, w = _case(card, 2, 100, lp, 500, 128, torch.float32,
                           seed=lp + 100, pad_first=False, zero_every=3)
    out = _check(tables, idx, w)
    assert torch.equal(_bits(out[:, ::3]),
                       torch.zeros_like(_bits(out[:, ::3])))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lp", [5, 33])
def test_scalar_path_is_bitwise_the_vector_path(card, lp, dtype):
    """D % 4 == 0 on a base that is not four-element aligned takes the
    scalar path: bitwise the vector path's output."""
    tables, idx, w = _case(card, 2, 64, lp, 300, 128, dtype, seed=lp + 200)
    vec = _check(tables, idx, w)
    scalar = _check(_misaligned(tables), idx, w)
    assert torch.equal(vec, scalar)


@pytest.mark.cuda
@pytest.mark.parametrize("t, b", [(1, 1), (1, 31), (1, 2048), (1, 5000),
                                  (26, 64), (4, 1024), (26, 2048)])
def test_grid_shapes(card, t, b):
    """From one bag to more than the spread blocks cover (the launcher's
    block size changes with the number of bags) and than the SMs hold at
    once (its rows a group do): every bag is written.
    The output's memory is first handed out filled with NaN, which the
    caching allocator is likely to hand back for the output."""
    tables, idx, w = _case(card, t, b, 20, 400, 128, torch.float32, seed=b)
    junk = torch.full((t, b, 128), float("nan"), device=card)
    del junk
    out = eg.gather_pool_tbe(tables, idx, w)
    torch.cuda.synchronize()
    assert not bool(out.isnan().any())
    assert torch.equal(out, _check(tables, idx, w))
