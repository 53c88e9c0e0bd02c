"""The host's side of the per-rank one-sided exchanges' signals, on the CPU.

With each rank a process, every one-sided exchange finishes on the card:
the ranks store epochs into signal pads after their symmetric buffers
(``csrc/onesided_a2a.cu``, the Completion paragraph).  The kernels run only
on a card (``tests/test_torch_chunks_card.py``); what the host does is
checked here: the pad's layout, which never reaches into the bytes a view
hands out; the epoch counter, one step per exchange of each buffer, from 0
again on a grown buffer, refusing to overflow; what each exchange asks
the launchers for (a fake library stands in for the built one and records
the calls); and the report a spin that ran out leaves behind.
"""
import ctypes
import re
from pathlib import Path

import pytest
import torch

from repro_torch.core import parallel
from repro_torch.kernels import onesided_a2a as oa

SOURCE = (Path(oa.__file__).resolve().parents[1] / "csrc" /
          "onesided_a2a.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr\s+\w+(?:\s+\w+)*\s+{name}\s*=\s*(0x[0-9a-fA-F]+"
                  rf"|\d+)", SOURCE)
    assert m, name
    return int(m.group(1), 0)


# ---------------------------------------------------------------------------
# the pad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", range(1, oa.MAX_RANKS + 1))
def test_pad_layout_holds_every_slot_past_the_buffer(world):
    """SIGNAL, ACK and COUNT one after another, 3E + 1 words, after the
    buffer's bytes and rounded to whole PAD_ALIGN blocks."""
    for nbytes in (1 << 20, 1 << 29):
        pad = oa.pad_layout(world, nbytes)
        assert pad.offset == nbytes
        assert (pad.signal, pad.ack, pad.count) == (0, world, 2 * world)
        assert pad.words == 3 * world + 1
        assert 8 * pad.words <= pad.nbytes < 8 * pad.words + oa.PAD_ALIGN
        assert pad.nbytes % oa.PAD_ALIGN == 0
        assert (pad.offset + pad.nbytes) % oa.PAD_ALIGN == 0


def test_pad_layout_refuses_what_the_kernels_cannot_take():
    for world in (0, oa.MAX_RANKS + 1):
        with pytest.raises(ValueError, match="at most"):
            oa.pad_layout(world, 1 << 20)
    for nbytes in (0, 100):
        with pytest.raises(ValueError, match="multiple"):
            oa.pad_layout(4, nbytes)


def test_pad_constants_match_the_source():
    assert (_const("kSignalRegion"), _const("kAckRegion")) == (oa.SIGNAL,
                                                              oa.ACK)
    assert _const("kCountRegion") == oa.pad_layout(4, 1 << 20).count // 4
    assert _const("kTimedOut") == oa.TIMED_OUT
    assert _const("kRecordWords") == 8


def _bare_buffers(world: int, nbytes: int):
    """A SymmetricBuffers' host state without a card (no allocation)."""
    bufs = object.__new__(oa.SymmetricBuffers)
    bufs.world, bufs.rank, bufs.nbytes = world, 0, nbytes
    bufs.pad = oa.pad_layout(world, nbytes)
    bufs.device = torch.device("cuda", 0)
    return bufs


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16])
def test_a_view_never_reaches_the_pad(dtype):
    """view() refuses one element past the buffer's bytes, where the pad
    begins."""
    bufs = _bare_buffers(4, 1 << 20)
    n = bufs.nbytes // dtype.itemsize
    with pytest.raises(ValueError, match="do not fit"):
        bufs.view(dtype, (n + 1,))
    with pytest.raises(ValueError, match="do not fit"):
        bufs.view(dtype, (4, n // 4 + 1))
    assert n * dtype.itemsize == bufs.pad.offset


# ---------------------------------------------------------------------------
# the epoch counter
# ---------------------------------------------------------------------------

def test_epochs_count_from_one_and_refuse_to_overflow():
    ep = oa.Epochs()
    assert [ep.next() for _ in range(5)] == [1, 2, 3, 4, 5]
    ep.epoch = oa.EPOCH_MAX - 1
    assert ep.next() == oa.EPOCH_MAX
    with pytest.raises(OverflowError, match="epoch"):
        ep.next()
    assert ep.epoch == oa.EPOCH_MAX
    assert oa.EPOCH_MAX == 2 ** 63 - 1   # a signed 64-bit launcher argument


class _FakeLib:
    """The built library's launchers, recorded; every call succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


class _FakeBuffers:
    """A SymmetricBuffers' host state over CPU tensors."""

    def __init__(self, world, rank, nbytes=1 << 20):
        self.world, self.rank, self.nbytes = world, rank, nbytes
        self.device = torch.device("cpu")
        self.pad = oa.pad_layout(world, nbytes)
        self.epochs = oa.Epochs()
        self._counts = (ctypes.c_ulonglong * (world + 1))()
        self._table = (ctypes.c_longlong * world)(*range(world))
        self._bytes = torch.zeros(nbytes, dtype=torch.uint8)

    def view(self, dtype, shape):
        n = 1
        for s in shape:
            n *= s
        return self._bytes[:n * dtype.itemsize].view(dtype).view(shape)


@pytest.fixture
def fake(monkeypatch):
    """The card's launch path on the CPU: a recording library, stream 0,
    no device context; a fence or a barrier fails the test."""
    lib = _FakeLib()
    monkeypatch.setattr(oa, "_kernel", lambda: lib)
    monkeypatch.setattr(oa, "_stream", lambda device: 0)
    monkeypatch.setattr(oa.torch.cuda, "device",
                        lambda device: _NullContext())

    def refuse(*a, **k):
        raise AssertionError("a per-rank exchange synchronised the host")

    monkeypatch.setattr(oa.dist, "barrier", refuse)
    monkeypatch.setattr(oa.torch.cuda, "synchronize", refuse)
    oa.reset_launch_counts()
    return lib


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _launch(call):
    """(launcher, its signal arguments: epoch and the rest) of a call."""
    name, args = call
    if name == "onesided_signal_copy":
        (_, _, nbytes, _, _, rank, world, wait, wait_region, wait_epoch,
         sig, sig_region, epoch, _, pad_off, timeout_ns, _) = args
        return name, dict(nbytes=nbytes, rank=rank, world=world, wait=wait,
                          wait_region=wait_region, wait_epoch=wait_epoch,
                          signal=sig, signal_region=sig_region, epoch=epoch,
                          pad_off=pad_off, timeout_ns=timeout_ns)
    counts, epoch, pad_off, timeout_ns = args[-5:-1]
    return name, dict(epoch=epoch, pad_off=pad_off, timeout_ns=timeout_ns,
                      counts=counts)


E, RANK = 4, 1
ALL = (1 << E) - 1


def test_each_exchange_takes_one_epoch_of_its_buffers(fake):
    """Each exchange of a buffer takes its next epoch, once: the a2a, the
    fetch and the ring share the receive buffers' count, the
    reduce-scatter and the all-reduce the send buffers'."""
    recv, send = _FakeBuffers(E, RANK), _FakeBuffers(E, RANK)
    x = torch.ones((E, 8), dtype=torch.float32)
    oa._all_to_all_on_card(x, RANK, recv)
    oa._fetch_rows_on_card(torch.ones((E, 3, 4)), RANK, recv)
    oa._ring_permute_on_card(x[0].contiguous(), 1, RANK, recv)
    oa._pull_sum_rank(x, RANK, send, RANK, 8, (8,))
    oa._pull_sum_rank(x, RANK, send, 0, x.numel(), tuple(x.shape))
    oa._all_to_all_on_card(x, RANK, recv)
    assert (recv.epochs.epoch, send.epochs.epoch) == (4, 2)
    launches = [_launch(c) for c in fake.calls]
    assert [(n, a["epoch"]) for n, a in launches] == [
        ("onesided_a2a_put", 1), ("onesided_signal_copy", 1),
        ("onesided_a2a_put", 2), ("onesided_signal_copy", 2),
        ("onesided_signal_copy", 2),
        ("onesided_ring_put", 3), ("onesided_signal_copy", 3),
        ("onesided_signal_copy", 1), ("onesided_rs_pull", 1),
        ("onesided_signal_copy", 2), ("onesided_rs_pull", 2),
        ("onesided_a2a_put", 4), ("onesided_signal_copy", 4)]
    for _, a in launches:
        assert a["pad_off"] == 1 << 20
        assert a["timeout_ns"] == int(oa.SIGNAL_TIMEOUT_S * 1e9)
    assert oa.FENCE_STATS["fences"] == 0
    assert oa.LAUNCH_COUNTS == {
        "onesided_put_rows": 1, "onesided_all_to_all": 2,
        "onesided_reduce_scatter": 2, "onesided_ring_permute": 1,
        "onesided_signal": 7}


def test_each_wait_is_for_what_its_exchange_needs(fake):
    """The receive waits for the sources' arrivals of the epoch and
    acknowledges it to every rank (the ring's for its one source); the
    fetch's sum sits between a wait and an acknowledgement; the staging
    waits for every acknowledgement of the epoch before and signals its
    own; the copies move the buffers' bytes."""
    recv, send = _FakeBuffers(E, RANK), _FakeBuffers(E, RANK)
    x = torch.ones((E, 8), dtype=torch.float32)
    oa._all_to_all_on_card(x, RANK, recv)
    oa._fetch_rows_on_card(torch.ones((E, 3, 4)), RANK, recv)
    oa._ring_permute_on_card(x[0].contiguous(), -1, RANK, recv)
    oa._pull_sum_rank(x, RANK, send, RANK, 8, (8,))
    sig = [a for n, a in map(_launch, fake.calls)
           if n == "onesided_signal_copy"]
    a2a, fetch_wait, fetch_ack, ring, stage = sig
    assert (a2a["wait"], a2a["wait_region"], a2a["wait_epoch"]) == (
        ALL, oa.SIGNAL, 1)
    assert (a2a["signal"], a2a["signal_region"], a2a["nbytes"]) == (
        ALL, oa.ACK, x.numel() * 4)
    assert (fetch_wait["wait"], fetch_wait["wait_epoch"],
            fetch_wait["signal"], fetch_wait["nbytes"]) == (ALL, 2, 0, 0)
    assert (fetch_ack["wait"], fetch_ack["signal"],
            fetch_ack["signal_region"], fetch_ack["epoch"]) == (
        0, ALL, oa.ACK, 2)
    assert (ring["wait"], ring["wait_epoch"], ring["signal"]) == (
        1 << ((RANK + 1) % E), 3, ALL)
    assert (stage["wait"], stage["wait_region"], stage["wait_epoch"],
            stage["signal"], stage["signal_region"], stage["epoch"]) == (
        ALL, oa.ACK, 0, ALL, oa.SIGNAL, 1)
    assert all(a["rank"] == RANK and a["world"] == E for a in sig)


def test_empty_exchanges_take_no_epoch_and_launch_nothing(fake):
    recv, send = _FakeBuffers(E, RANK), _FakeBuffers(E, RANK)
    oa._all_to_all_on_card(torch.ones((E, 0)), RANK, recv)
    oa._fetch_rows_on_card(torch.ones((E, 0, 4)), RANK, recv)
    oa._ring_permute_on_card(torch.ones((0, 4)), 1, RANK, recv)
    oa._pull_sum_rank(torch.ones((E, 0)), RANK, send, RANK, 0, (0,))
    assert (recv.epochs.epoch, send.epochs.epoch) == (0, 0)
    assert fake.calls == []


def test_signals_follow_the_lowered_bound(fake, monkeypatch):
    monkeypatch.setattr(oa, "SIGNAL_TIMEOUT_S", 0.25)
    recv = _FakeBuffers(E, RANK)
    oa._all_to_all_on_card(torch.ones((E, 8)), RANK, recv)
    assert {_launch(c)[1]["timeout_ns"] for c in fake.calls} == {250_000_000}


class _GrowingBuffers:
    made = []

    def __init__(self, group, rank, world, device, nbytes):
        self.nbytes, self.closed = nbytes, False
        self.epochs = oa.Epochs()
        _GrowingBuffers.made.append(self)

    def close(self):
        self.closed = True


def test_a_grown_buffer_starts_again_from_epoch_zero(monkeypatch):
    """ProcessContext.symmetric: the same buffers while they fit (their
    epochs go on); a larger size fences, closes them, and the new ones
    count from 0.  Fences belong to a buffer's life only."""
    fences = []
    monkeypatch.setattr(oa, "SymmetricBuffers", _GrowingBuffers)
    monkeypatch.setattr(oa, "fence", lambda group, device: fences.append(1))
    _GrowingBuffers.made = []
    ctx = parallel.ProcessContext(group=None, rank=0, world=2,
                                  device=torch.device("cpu"))
    a = ctx.symmetric("recv", 100)
    for _ in range(3):
        a.epochs.next()
    assert ctx.symmetric("recv", 1 << 20) is a and a.epochs.epoch == 3
    assert fences == []
    b = ctx.symmetric("recv", (1 << 20) + 1)
    assert b is not a and a.closed and fences == [1]
    assert (b.nbytes, b.epochs.epoch, b.epochs.next()) == (1 << 21, 0, 1)
    s = ctx.symmetric("send", 10)
    assert s.epochs.epoch == 0 and b.epochs.epoch == 1
    ctx.close()
    assert fences == [1, 1] and b.closed and s.closed


# ---------------------------------------------------------------------------
# a spin that ran out
# ---------------------------------------------------------------------------

def test_a_timed_out_spin_names_the_rank_the_slot_and_the_epoch(monkeypatch):
    """The record a trapped kernel leaves in host memory becomes the
    sentence a rank's error carries to run_ranks."""
    record = (ctypes.c_uint64 * 8)()
    monkeypatch.setattr(oa, "_RECORD", ctypes.addressof(record))
    assert oa.signal_timeout_report() is None
    assert parallel._signal_note() == ""
    record[:] = [oa.TIMED_OUT, 2, oa.SIGNAL, 3, 17, 16, 500_000_000, 4]
    msg = oa.signal_timeout_report()
    assert msg.startswith("signal wait timed out after 0.5 s: rank 2 of 4")
    assert "SIGNAL[3]" in msg and "epoch 17" in msg and "read 16" in msg
    assert parallel._signal_note() == msg + "\n"
    record[2] = oa.ACK
    assert "ACK[3]" in oa.signal_timeout_report()
    monkeypatch.setattr(oa, "_RECORD", None)
    assert oa.signal_timeout_report() is None
