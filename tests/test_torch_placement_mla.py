"""The reference's training state placement over processes for
deepseek-v3 (MLA, an MoE layer with a shared expert beside a dense one,
the MTP head) and hymba (attention and Mamba heads), on the CPU.

``tests/_placement_checks.py`` holds the machinery and says what each
check holds: every leaf's spec and every rank's pieces the reference's,
two placed steps on four gloo processes within ``REF_RTOL`` of the
reference's ``Trainer(state_shardings=)``, the placed state the
unplaced run's cut (bitwise, but deepseek's on the model axis of 4,
where its shared experts sum in another order: within ``STATE_RTOL``),
each rank's bytes the specs', and deepseek's checkpoints across
placements.  One JAX subprocess with four forced CPU devices beside one
spawn of the ranks.
"""
import pytest

import _placement_checks as P

ARCHS = ("deepseek-v3-671b", "hymba-1.5b")
# a leaf of each family that the data axis cuts under fsdp: deepseek's
# dense layer's FFN, hymba's Mamba heads
DATA_CUT_LEAF = {"deepseek-v3-671b": "dense_blocks/ffn",
                 "hymba-1.5b": "blocks/mamba"}
CKPT_ARCH = "deepseek-v3-671b"
CASES = P.cases(ARCHS)
TRAINED = P.trained(ARCHS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return P.run(tmp_path_factory.mktemp("placement_mla"), ARCHS, CKPT_ARCH)


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


@pytest.mark.parametrize("src", ["placed", "unplaced", "one"])
def test_checkpoint_restores_across_placements(runs, src):
    P.check_checkpoint(runs, src)


def test_placed_checkpoint_round_trip_and_one_state(runs):
    P.check_checkpoint_files(runs)


def test_deepseek_is_held_at_both_layer_kinds_and_the_mtp_head():
    """The widened deepseek config keeps a dense and an MoE layer and the
    MTP head, so that every kind of its leaves is placed above."""
    cfg = P._cfg("deepseek-v3-671b")
    assert (cfg.num_layers, cfg.first_k_dense, cfg.mtp_depth) == (2, 1, 1)
    paths = P.S.flatten_specs(P.specs_of("deepseek-v3-671b", "2x2", True,
                                         "float32"))
    for part in ("dense_blocks/attn", "moe_blocks/moe/shared",
                 "moe_blocks/moe/up", "mtp/proj", "mtp/block/ffn"):
        assert any(part in p for p in paths), part

