"""The TBE gather-pool kernel's schedule (``csrc/tbe_gather_pool.cu``),
emulated on the CPU.

The kernel runs only on the card, so its index arithmetic and its order of
work are held here through an emulation that lives in this file, not as a
mode of the package.  The emulation follows the source: the launcher's
block size (``warps_per_block``) and rows a group (kGroup, or half of it on
the vector path of a grid larger than the SMs hold at once), one warp per
bag, the passes of the warp over D (four elements a lane when D % 4 == 0,
else one), the windows of 32 slots whose live slots (``w != 0``) a ballot
gives, the groups of live slots, and the ring of kStages groups whose next
loads are issued before this group's FMAs.  Its constants are read from
the source.  Over T in {1, 3}, L in {0, 1, 7, 31, 32, 33, 64, 100} and D in
{4, 10, 96, 128, 132, 256}, and on a grid that takes the half group, it
holds that:

  * every ``(t, b, d)`` output is written exactly once;
  * rows are read only for live slots, each once a pass, in groups of at
    most a group's rows of live slots of one window;
  * they are accumulated in ascending l, from +0.0, each group's loads
    issued kStages - 1 groups ahead of its FMAs;
  * null offsets with a stride (``gather_pool_tbe``: t * R,
    ``gather_pool``: 0) address the same rows as the offsets passed as an
    array.

The emulated output is held to the wrappers' CPU results (their plain
versions) within ``POOL_TOL`` (``rtol=atol=1e-5``): the kernel's FMA chain
and the plain einsum are two f32 orders of at most 100 terms, about 1e-7
apart at these values (the emulation's FMA rounds through f64, which can
differ from the card's in the last bit).  The wrappers' CPU results are
also held against the JAX reference's ``gather_pool_pallas`` and
``gather_pool_tbe_pallas`` in Pallas interpret mode at the lengths around
the windows, within ``rtol=1e-5, atol=1e-6`` as in
``tests/test_torch_kernels.py``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import embedding_gather as jgather
from repro_torch.kernels import embedding_gather as eg

SOURCE = (Path(eg.__file__).resolve().parents[1] / "csrc"
          / "tbe_gather_pool.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


MAX_WARPS, GROUP, STAGES, SPREAD = (_const("kMaxWarpsPerBlock"),
                                    _const("kGroup"), _const("kStages"),
                                    _const("kSpreadBlocksPerSm"))
DEEP_WARPS, WIDE_BYTES = _const("kDeepWarpsPerSm"), _const("kWideRingBytes")
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
LENGTHS = [0, 1, 7, 31, 32, 33, 64, 100]
DIMS = [4, 10, 96, 128, 132, 256]


def _warps_per_block(bags: int, sms: int) -> int:
    """The launcher's block size: the largest, up to kMaxWarpsPerBlock
    warps, that gives every SM kSpreadBlocksPerSm blocks."""
    warps = MAX_WARPS
    while warps > 1 and -(-bags // warps) < sms * SPREAD:
        warps >>= 1
    return warps


def _group(bags: int, sms: int, vec: bool, itemsize: int = 4) -> int:
    """The launcher's rows a group: kGroup, halved on the vector path of a
    grid of more than kDeepWarpsPerSm bags an SM when a ring of kStages x
    kGroup units a lane would outgrow kWideRingBytes a warp."""
    unit = 4 * itemsize
    if vec and STAGES * GROUP * 32 * unit > WIDE_BYTES \
            and bags > sms * DEEP_WARPS:
        return GROUP // 2
    return GROUP


def _pool_bag(w_bag: np.ndarray, trace: list, group: int) -> None:
    """One bag's slot schedule, as ``pool_bag`` and ``fetch`` walk it:
    appends ("issue", l) and ("fma", l) in the order the warp does them,
    and ("commit",) and ("wait",) around each group."""
    pooling = len(w_bag)
    state = dict(l0=0, live=[])

    def fetch():
        while not state["live"] and state["l0"] < pooling:
            win = range(state["l0"], min(state["l0"] + 32, pooling))
            state["live"] = [l for l in win if w_bag[l] != 0.0]   # ballot
            state["l0"] += 32
        taken = state["live"][:group]
        state["live"] = state["live"][group:]
        trace.extend(("issue", l) for l in taken)
        trace.append(("commit",))
        return taken

    groups = [fetch() for _ in range(STAGES - 1)] + [None]
    while True:
        for st in range(STAGES):
            if not groups[st]:
                return
            ahead = (st + STAGES - 1) % STAGES
            groups[ahead] = fetch()
            trace.append(("wait",))
            trace.extend(("fma", l) for l in groups[st])


def _fma(w, r, acc):
    """f32 fma(w, r, acc) through f64 (w * r is exact there)."""
    return (np.float64(w) * r.astype(np.float64)
            + acc.astype(np.float64)).astype(np.float32)


def _emulate(flat, off, stride, idx, w, sms=132):
    """The kernel on the CPU: (T, B, D) f32, and a record of its work:
    the rows each pass read, the writes of each output element, each
    pass's trace."""
    T, B, L = idx.shape
    N, D = flat.shape
    per = 4 if D % 4 == 0 else 1
    bags = T * B
    warps = _warps_per_block(bags, sms)
    group = _group(bags, sms, per == 4)
    out = np.full((T, B, D), np.nan, np.float32)
    writes = np.zeros((T, B, D), np.int64)
    reads, traces = [], []
    for block in range(-(-bags // warps)):
        for wi in range(warps):
            bag = block * warps + wi
            if bag >= bags:
                continue
            t, b = divmod(bag, B)
            base = int(off[t]) if off is not None else t * stride
            for c0 in range(0, D, 32 * per):
                lanes = np.arange(32)
                d = c0 + lanes[:, None] * per + np.arange(per)
                d = d[d < D]                       # the active lanes' units
                trace = []
                _pool_bag(w[t, b], trace, group)
                acc = np.zeros(len(d), np.float32)       # +0.0
                for ev in trace:
                    if ev[0] == "issue":
                        reads.append((t, b, c0, ev[1],
                                      base + int(idx[t, b, ev[1]])))
                    elif ev[0] == "fma":
                        row = flat[base + int(idx[t, b, ev[1]])]
                        acc = _fma(w[t, b, ev[1]], row[d], acc)
                out[t, b, d] = acc
                writes[t, b, d] += 1
                traces.append(((t, b, c0), trace))
    return out, writes, reads, traces


def _inputs(T, L, D, seed, R=50, B=9):
    """numpy tables (T, R, D) ~ N(0, 1/D), ids with -1 beyond each bag's
    length (lengths in [0, L], zero-length bags among them) and at slot 0
    of every third bag, weights in [0, 1) zeroed there, and bags of live
    ids with zero weights."""
    rng = np.random.default_rng(seed)
    tables = (rng.standard_normal((T, R, D)) / np.sqrt(D)).astype(np.float32)
    lens = rng.integers(0, L + 1, (T, B))
    live = np.arange(L) < lens[..., None]
    if L:
        live[:, ::3, 0] = False
    idx = np.where(live, rng.integers(0, R, (T, B, L)), -1).astype(np.int32)
    w = (rng.random((T, B, L)) * live).astype(np.float32)
    w[:, 4] = 0.0                       # live ids, no weight
    return tables, idx, w


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("T", [1, 3])
def test_schedule(T, L, D):
    _check_schedule(T, L, D, B=9, sms=132)


@pytest.mark.parametrize("D", [4, 10, 128, 132])
@pytest.mark.parametrize("L", LENGTHS)
def test_schedule_wide_grid(L, D):
    """A grid of more bags than the SMs hold at once (one SM here): the
    vector path takes half a group a stage."""
    group = _check_schedule(2, L, D, B=16, sms=1)
    assert group == (GROUP // 2 if D % 4 == 0 else GROUP)


def _check_schedule(T, L, D, B, sms) -> int:
    """The emulated launch's invariants; returns its rows a group."""
    tables, idx, w = _inputs(T, L, D, seed=100 * T + L + D, B=B)
    R = tables.shape[1]
    flat = tables.reshape(T * R, D)
    group = _group(T * B, sms, D % 4 == 0)
    out, writes, reads, traces = _emulate(flat, None, R, idx, w, sms=sms)

    # every output element written exactly once
    assert (writes == 1).all()

    # rows read only for live slots, each live slot once a pass
    for (t, b, c0), trace in traces:
        issued = [ev[1] for ev in trace if ev[0] == "issue"]
        summed = [ev[1] for ev in trace if ev[0] == "fma"]
        live = [l for l in range(L) if w[t, b, l] != 0.0]
        assert issued == live and summed == live      # ascending, once each
        # groups: at most ``group`` live slots of one 32-slot window, in order
        groups, cur = [], []
        for ev in trace:
            if ev[0] == "issue":
                cur.append(ev[1])
            elif ev[0] == "commit":
                if cur:
                    groups.append(cur)
                cur = []
        assert [l for g in groups for l in g] == live
        for g in groups:
            assert len(g) <= group and g[0] // 32 == g[-1] // 32
        # the live slots of a window fill its groups before the next window
        for a, b_ in zip(groups, groups[1:]):
            assert len(a) == group or a[0] // 32 != b_[0] // 32
        # each group's loads go out STAGES - 1 groups ahead of its FMAs
        firsts = {g[0]: i for i, g in enumerate(groups)}
        seen_issue, fired = 0, 0
        for ev in trace:
            if ev[0] == "issue":
                seen_issue += 1
            elif ev[0] == "fma" and ev[1] in firsts:
                ahead = sum(len(x) for x in groups[:firsts[ev[1]] + STAGES])
                assert seen_issue == ahead
                fired += 1
        assert fired == len(groups)
    for t, b, _, l, row in reads:
        assert w[t, b, l] != 0.0 and row == t * R + idx[t, b, l]
        assert 0 <= idx[t, b, l] < R

    # from +0.0: a bag with no live slot pools to +0.0, not -0.0
    dead = (w == 0).all(-1)
    assert dead.any()
    assert (out[dead].view(np.int32) == 0).all()

    # the plain versions, which the wrappers take on the CPU
    tt, ti, tw = (torch.from_numpy(a) for a in (tables, idx, w))
    stacked = eg.gather_pool_tbe(tt, ti, tw)
    np.testing.assert_allclose(out, stacked.numpy(), **POOL_TOL)
    starts = torch.arange(T, dtype=torch.int32) * R
    np.testing.assert_allclose(
        out, eg.gather_pool_tbe_flat(tt.reshape(T * R, D), starts, ti,
                                     tw).numpy(), **POOL_TOL)
    for t in range(T):
        np.testing.assert_allclose(
            out[t], eg.gather_pool(tt[t], ti[t], tw[t]).numpy(), **POOL_TOL)
    return group


def test_group_follows_the_grid():
    """kGroup rows on a grid the SMs hold at once and on the scalar path;
    half on the f32 vector path of a larger grid; bf16's ring of kGroup
    rows fits kWideRingBytes, so it keeps them."""
    assert GROUP == 8 and GROUP // 2 == 4
    assert _group(2048, 132, True) == GROUP              # T = 1
    assert _group(132 * DEEP_WARPS, 132, True) == GROUP
    assert _group(132 * DEEP_WARPS + 1, 132, True) == GROUP // 2
    assert _group(26 * 2048, 132, True) == GROUP // 2    # T = 26
    assert _group(26 * 2048, 132, True, itemsize=2) == GROUP
    assert _group(26 * 2048, 132, False) == GROUP


@pytest.mark.parametrize("T", [1, 3])
def test_null_offsets_address_the_stacked_rows(T):
    """The stride entry (no offsets array) reads the rows that the offsets
    array t * R reads, and one table alone (stride 0) the rows of that
    table at offset 0; so their outputs are the same bits."""
    tables, idx, w = _inputs(T, 33, 8, seed=T)
    R = tables.shape[1]
    flat = tables.reshape(T * R, 8)
    by_stride = _emulate(flat, None, R, idx, w)
    by_array = _emulate(flat, np.arange(T, dtype=np.int32) * R, 0, idx, w)
    assert by_stride[2] == by_array[2]
    assert np.array_equal(by_stride[0].view(np.int32),
                          by_array[0].view(np.int32))
    for t in range(T):
        one = _emulate(tables[t], None, 0, idx[t:t + 1], w[t:t + 1])
        assert [(b, c0, l, row + t * R) for _, b, c0, l, row in one[2]] == \
            [(b, c0, l, row) for tt, b, c0, l, row in by_array[2] if tt == t]
        assert np.array_equal(one[0][0].view(np.int32),
                              by_array[0][t].view(np.int32))


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("bags", [1, 31, 2048, 53248])
def test_spread_blocks_cover_every_bag_once(bags, sms):
    """The launcher's blocks: every bag has exactly one warp, and a grid
    of fewer bags than kMaxWarpsPerBlock x kSpreadBlocksPerSm x SMs goes
    out in smaller blocks."""
    warps = _warps_per_block(bags, sms)
    assert 1 <= warps <= MAX_WARPS and warps & (warps - 1) == 0
    blocks = -(-bags // warps)
    owned = np.arange(blocks * warps)
    assert (owned[owned < bags] == np.arange(bags)).all()
    if warps > 1:
        assert blocks >= sms * SPREAD
    if bags >= MAX_WARPS * SPREAD * sms:
        assert warps == MAX_WARPS
    assert _warps_per_block(2048, 132) == 2


# ---------------------------------------------------------------------------
# the wrappers' CPU results against the JAX reference, in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 31, 32, 33, 64])
def test_wrappers_match_pallas_at_window_edges(L):
    """``gather_pool`` and ``gather_pool_tbe`` against the Pallas kernels
    they replace, at lengths around the kernel's 32-slot windows.  The
    reference reads every slot's row, so its ids are in range: -1 padding
    becomes id 0 there, weight 0 in both."""
    T, D = 2, 16
    tables, idx, w = _inputs(T, L, D, seed=500 + L, R=40)
    safe = np.where(idx < 0, 0, idx).astype(np.int32)
    got = eg.gather_pool_tbe(torch.from_numpy(tables), torch.from_numpy(idx),
                             torch.from_numpy(w))
    want = jgather.gather_pool_tbe_pallas(
        jnp.asarray(tables), jnp.asarray(safe), jnp.asarray(w),
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)
    one = eg.gather_pool(torch.from_numpy(tables[1]),
                         torch.from_numpy(idx[1]), torch.from_numpy(w[1]))
    want1 = jgather.gather_pool_pallas(
        jnp.asarray(tables[1]), jnp.asarray(safe[1]), jnp.asarray(w[1]),
        interpret=True)
    np.testing.assert_allclose(one.numpy(), np.asarray(want1), **JAX_TOL)
    assert torch.equal(one, got[1])


def test_source_names_the_schedule_and_what_bounds_it():
    for text in ("gather_pool_tbe_flat_pallas", "gather_pool_tbe_pallas",
                 "gather_pool_pallas", "src/repro/kernels/embedding_gather.py",
                 "__ballot_sync", "__shfl_sync", "cp.async.ca",
                 "cp.async.wait_group", "device-memory bytes", "latency",
                 "acc = fma(w_l, row_l[d], acc) from +0.0"):
        assert text in SOURCE, text
    assert "one row in flight per warp" not in SOURCE
    assert "It is the simple version" not in SOURCE
    assert len(re.findall(r"__global__", SOURCE)) == 1
