"""The reference's training state placement over processes for rwkv6
(the RWKV mixers, no FFN), whisper-base (the encoder, cross attention,
``frames`` in every batch) and internvl2-2b (the projector, ``patches``
in every batch), on the CPU.

``tests/_placement_checks.py`` holds the machinery and says what each
check holds: every leaf's spec and every rank's pieces the reference's,
two placed steps on four gloo processes within ``REF_RTOL`` of the
reference's ``Trainer(state_shardings=)``, the placed state bitwise the
unplaced run's cut (no family here has an MoE layer, so every sum runs
over at most two ranks), and each rank's bytes the specs'.  One JAX
subprocess with four forced CPU devices beside one spawn of the ranks.
"""
import pytest

import _placement_checks as P

ARCHS = ("rwkv6-1.6b", "whisper-base", "internvl2-2b")
# a leaf of each family that the data axis cuts under fsdp
DATA_CUT_LEAF = {"rwkv6-1.6b": "blocks/rwkv", "whisper-base": "blocks/cross",
                 "internvl2-2b": "projector"}
CASES = P.cases(ARCHS)
TRAINED = P.trained(ARCHS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return P.run(tmp_path_factory.mktemp("placement_families"), ARCHS)


@pytest.mark.parametrize("case", CASES, ids=P.case_id)
def test_specs_are_the_references(runs, case):
    P.check_specs(runs, case, DATA_CUT_LEAF[case[0]])


@pytest.mark.parametrize("case", CASES, ids=P.case_id)
def test_rank_pieces_are_the_reference_shards(runs, case):
    P.check_pieces(runs, case)


@pytest.mark.parametrize("case", [c for c in TRAINED if c[3] == "float32"],
                         ids=P.case_id)
def test_training_matches_the_reference(runs, case):
    P.check_reference_steps(runs, case)


@pytest.mark.parametrize("case", TRAINED, ids=P.case_id)
def test_placed_state_is_the_unplaced_runs(runs, case):
    assert P.bitwise_case(*case[:2])
    P.check_vs_unplaced(runs, case)


@pytest.mark.parametrize("case", TRAINED, ids=P.case_id)
def test_ranks_holding_a_piece_alike_agree(runs, case):
    P.check_alike(runs, case)


@pytest.mark.parametrize("case", TRAINED, ids=P.case_id)
def test_rank_bytes_are_the_specs(runs, case):
    P.check_bytes(runs, case)


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_backward_sums_in_bounded_buckets(runs, arch):
    P.check_bucket_sums(runs, arch)


@pytest.mark.parametrize("arch,key", [("whisper-base", "frames"),
                                      ("internvl2-2b", "patches")])
def test_batches_carry_the_family_inputs(runs, arch, key):
    """Each step's batch, on both sides, holds the family's own input
    beside the tokens and labels."""
    for batch in P.batches_of(runs[0], arch):
        assert {"tokens", "labels", key} <= set(batch), sorted(batch)
        assert batch[key].shape[0] == P.LB
