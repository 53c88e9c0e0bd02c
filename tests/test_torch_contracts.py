"""The port's kernel contracts (``repro_torch.analysis.contracts``) on the
CPU: every attached contract passes its fixture, the registries carry the
reference's keys and names, and each injected fault is caught -- a second
wrapper call, a collective, an out-of-place scatter, an f64 upcast, a
``.item()`` (the reference's ``tests/test_analysis.py`` cases, in PyTorch
terms)."""
import dataclasses

import pytest
import torch

from repro_torch.analysis import (
    ContractViolation,
    KernelContract,
    audit,
    count_launches,
    repo_contracts,
    summarize,
)
from repro_torch.analysis.fixtures import ALL_FIXTURES, run_all
from repro_torch.cache import tiers
from repro_torch.core import comm
from repro_torch.kernels import embedding_gather as eg
from repro_torch.kernels import ops as kops


def _tbe_args(T=4, R=64, D=16, B=8, L=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((T, R, D), generator=g),
            torch.randint(0, R, (T, B, L), generator=g, dtype=torch.int32),
            torch.rand((T, B, L), generator=g))


def _tbe_fused(t, i, w):
    return kops.embedding_bag_batched(t, i, None, w, fused=True)


def test_every_attached_contract_passes_its_fixture():
    reports = run_all()
    assert len(reports) == len(ALL_FIXTURES) == len(repo_contracts()) == 7
    assert {r.contract.name for r in reports} == set(repo_contracts())
    for report in reports:
        assert report.ok, (report.contract.name, report.violations)
        assert report.census.device == "cpu"
        assert report.census.kernel_calls == report.contract.max_launches


@pytest.mark.parametrize("module", [
    "kernels.ops", "cache.cached_bag", "core.embedding_bag",
    "serving.engine", "cache.tiers"])
def test_registries_carry_the_references_contracts(module):
    """Module by module: the reference's keys, names and launch bounds;
    its donated argnums are the port's in-place argnums."""
    import importlib

    ref = importlib.import_module(f"repro.{module}").KERNEL_CONTRACTS
    mine = importlib.import_module(f"repro_torch.{module}").KERNEL_CONTRACTS
    assert set(mine) == set(ref)
    for key, c in mine.items():
        r = ref[key]
        assert (c.name, c.min_launches, c.max_launches,
                c.allowed_collectives, c.in_place_argnums, c.max_float_bits,
                c.forbid_host_transfers) == \
            (r.name, r.min_pallas_calls, r.max_pallas_calls,
             r.allowed_collectives, r.donate_argnums, r.max_float_bits,
             r.forbid_host_transfers)
        assert c.note


def test_wrapper_calls_are_the_launch_census():
    """The dispatch mode never sees a ctypes launch, so the census counts
    wrapper calls: one for the fused forward, T unfused; the backward and
    the plain version's own ops add none."""
    args = _tbe_args()
    assert count_launches(_tbe_fused, *args) == 1
    assert count_launches(lambda t, i, w: kops.embedding_bag_batched(
        t, i, None, w, fused=False), *args) == 4

    def train_step(t, i, w):
        t = t.clone().requires_grad_()
        (g,) = torch.autograd.grad((_tbe_fused(t, i, w) ** 2).sum(), (t,))
        return g

    census = summarize(train_step, args)
    assert census.calls == {"gather_pool_tbe": 1}
    assert census.launches == {}            # the CPU launches nothing
    assert census.ops.get("index_add_", 0) == 1
    assert census.device_kernels is None
    audit(train_step, args, kops.KERNEL_CONTRACTS["tbe_fused"]
          ).raise_if_failed()


def test_injected_second_launch_is_caught():
    contract = kops.KERNEL_CONTRACTS["tbe_fused"]

    def two_launches(t, i, w):
        return _tbe_fused(t, i, w) + _tbe_fused(t, i, w)

    report = audit(two_launches, _tbe_args(), contract)
    assert not report.ok
    assert report.census.kernel_calls == 2
    assert any("kernel-wrapper calls: got 2" in v for v in report.violations)
    with pytest.raises(ContractViolation, match="got 2"):
        report.raise_if_failed()
    audit(_tbe_fused, _tbe_args(), contract).raise_if_failed()


def test_forbidden_collective_is_caught():
    x = torch.randn(4, 8)
    strict = KernelContract(name="no-collectives", min_launches=0,
                            max_launches=0)
    report = audit(lambda v: comm.all_reduce(v), (x,), strict)
    assert report.census.collectives == {"all_reduce": 1}
    assert any("'all_reduce'" in v for v in report.violations)
    allowed = dataclasses.replace(strict, allowed_collectives=("all_reduce",))
    audit(lambda v: comm.all_reduce(v), (x,), allowed).raise_if_failed()
    # the audit's sink is removed afterwards, the previous one restored
    seen = []
    prev = comm.set_event_sink(seen.append)
    try:
        audit(lambda v: comm.all_reduce(v), (x,), allowed)
        comm.all_reduce(x)
    finally:
        comm.set_event_sink(prev)
    assert [e.op for e in seen] == ["all_reduce"]


def test_out_of_place_scatter_is_caught():
    contract = tiers.KERNEL_CONTRACTS["scatter_rows"]
    pool = torch.zeros(64, 8)
    args = (pool, torch.tensor([3, 9, 4, 60]), torch.randn(4, 8))
    ptr = pool.data_ptr()
    audit(tiers._scatter_rows, args, contract).raise_if_failed()
    assert pool.data_ptr() == ptr and torch.equal(pool[9], args[2][1])

    def dropped(p, addr, rows):                 # the regression: a copy
        return p.index_copy(0, addr, rows)

    report = audit(dropped, args, contract)
    assert any("in place" in v and "index_copy" in v
               for v in report.violations)


def test_float_upcast_is_caught():
    def upcasts(x):
        return (x.double() * 2).float()

    report = audit(upcasts, (torch.randn(8),),
                   KernelContract(name="f32", min_launches=0,
                                  max_launches=0))
    assert any("float64" in v and "ceiling" in v for v in report.violations)

    def bf16_path(x):
        return (x.float() * 2).to(torch.bfloat16)

    ceiling16 = KernelContract(name="bf16-only", min_launches=0,
                               max_launches=0, max_float_bits=16)
    x = torch.randn(8).to(torch.bfloat16)
    assert any("float32" in v for v in audit(bf16_path, (x,),
                                             ceiling16).violations)
    audit(bf16_path, (x,), dataclasses.replace(
        ceiling16, max_float_bits=32)).raise_if_failed()


def test_host_transfer_is_caught():
    contract = kops.KERNEL_CONTRACTS["tbe_fused"]

    def with_item(t, i, w):
        out = _tbe_fused(t, i, w)
        return out * float(out.abs().max().item())

    report = audit(with_item, _tbe_args(), contract)
    assert any("_local_scalar_dense" in v for v in report.violations)

    def with_bool(t, i, w):
        out = _tbe_fused(t, i, w)
        return out if bool((out > 0).any()) else out

    assert not audit(with_bool, _tbe_args(), contract).ok
    allowed = dataclasses.replace(contract, forbid_host_transfers=False)
    audit(with_item, _tbe_args(), allowed).raise_if_failed()


def test_audit_counts_calls_on_both_devices_via_call_counts():
    """CALL_COUNTS moves on the CPU (the plain version), LAUNCH_COUNTS does
    not: a launch is the card's."""
    eg.reset_call_counts()
    eg.reset_launch_counts()
    t, i, w = _tbe_args()
    eg.gather_pool_tbe(t, i, w)
    eg.gather_pool(t[0], i[0], w[0])
    assert eg.CALL_COUNTS == {"gather_pool": 1, "gather_pool_tbe": 1,
                              "gather_pool_tbe_flat": 0}
    assert set(eg.LAUNCH_COUNTS.values()) == {0}
