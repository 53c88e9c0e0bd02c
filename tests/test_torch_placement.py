"""The reference's training state placement over processes, on the CPU.

``launch/specs.py`` ports ``repro.launch.specs``' state rules; a rank of
a ``(dp, tp)`` mesh of processes then holds only its piece of each train
state leaf (parameters, gradients, both moments), gathers a layer's
weights whole only while the layer runs, and writes and restores the
whole state's checkpoint.  Held here, for granite and moonshot widened
past the rules' 1024 thresholds (``d_model`` and the dense FFN 1024, so
that every rule cuts a leaf; one dense layer, and moonshot's MoE layer),
in f32, on the meshes ``(2, 2)`` and ``(1, 4)``, with ``fsdp`` on and
off:

  * every leaf's spec the reference's ``state_spec_tree``
    (``Mesh(devices.reshape(mesh), ("data", "model"))``), for f32 and
    int8 moments, where an axis of one device counts as no cut;
  * each rank's pieces of a state in the reference's layout
    (``utils/convert.lm_train_state_for_rank`` with the specs) bitwise
    that device's ``addressable_shards`` after ``jax.device_put(state,
    shardings)``;
  * two train steps under the placement on four gloo processes (one
    spawn; the ``(1, 4)`` mesh is the same processes as one model axis,
    where ``fsdp`` False places as True -- no data axis -- and one run,
    the port's and the reference's, serves both):
    losses and gradient norms within ``REF_RTOL`` of the reference's
    ``Trainer(state_shardings=)`` from the same state and batches (this
    file run as a script in a subprocess with four forced CPU devices);
  * the same steps' state, each rank's pieces, bitwise the cut of the
    port's unplaced run's (``state_shardings`` None: only the vocabulary
    and the experts cut), f32 and int8 moments; losses bitwise, norms
    within ``NORM_RTOL`` (their sums run in another order); the pieces
    two ranks hold alike bitwise equal;
  * each rank's parameter, gradient and moment bytes the specs'
    arithmetic;
  * a checkpoint written under the placement restores bitwise unplaced,
    and on one device; one written unplaced, or on one device, restores
    bitwise under the placement;
  * a spec the port cannot honour raises, naming the leaf.

The steps run with the clip threshold above every gradient norm: the
clip factor is then 1 exactly, so the update is elementwise and the
placed state can be held bitwise to the unplaced one (with a clip, the
norms' last bits would reach every weight).
"""
import dataclasses

import pytest
import torch

import _placement_checks as P
from repro_torch.core.parallel import ProcessContext, make_context
from repro_torch.launch import specs as S
from repro_torch.models import lm as tlm
from repro_torch.train import step as tstep

ARCHS = ("granite-8b", "moonshot-v1-16b-a3b")
# the leaf the data axis cuts under fsdp (a dense layer's FFN)
DATA_CUT_LEAF = "blocks/ffn"
CASES = P.cases(ARCHS)
# the trained cases: f32 on both meshes, int8 moments on (2, 2)
TRAINED = P.trained(ARCHS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, every rank's results, tmp): the
    JAX subprocess beside the one spawn of the ranks (the machinery of
    ``tests/_placement_checks.py``, granite's checkpoints)."""
    return P.run(tmp_path_factory.mktemp("placement"), ARCHS, ARCHS[0])


# ---------------------------------------------------------------------------
# the specs and the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=P.case_id)
def test_specs_are_the_references(runs, case):
    P.check_specs(runs, case, DATA_CUT_LEAF)


@pytest.mark.parametrize("case", CASES, ids=P.case_id)
def test_rank_pieces_are_the_reference_shards(runs, case):
    """lm_train_state_for_rank of the state in the reference's layout,
    under the case's specs, on each (data group, model rank): bitwise
    that device's shards after jax.device_put."""
    P.check_pieces(runs, case)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [c for c in TRAINED if c[3] == "float32"],
                         ids=P.case_id)
def test_training_matches_the_reference(runs, case):
    P.check_reference_steps(runs, case)


@pytest.mark.parametrize("case", TRAINED, ids=P.case_id)
def test_placed_state_is_the_unplaced_runs(runs, case):
    """Every rank's pieces after the steps bitwise its cut of the unplaced
    run's state, and the losses bitwise, where every sum runs over at most
    two ranks (else within STATE_RTOL); the norms within NORM_RTOL; the
    first loss bitwise."""
    P.check_vs_unplaced(runs, case)


@pytest.mark.parametrize("case", TRAINED, ids=P.case_id)
def test_ranks_holding_a_piece_alike_agree(runs, case):
    """Two ranks whose pieces of a leaf are the same piece (the spec does
    not cut it over the axis they differ on) hold it bitwise alike."""
    P.check_alike(runs, case)


@pytest.mark.parametrize("case", TRAINED, ids=P.case_id)
def test_rank_bytes_are_the_specs(runs, case):
    """Each rank's parameter, gradient and moment bytes are exactly what
    the specs give its pieces."""
    P.check_bytes(runs, case)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", ["placed", "unplaced", "one"])
def test_checkpoint_restores_across_placements(runs, src):
    """A checkpoint written under the placement restores unplaced, one
    written unplaced or on one device restores under the placement: each
    rank's restored pieces bitwise its cut of the checkpoint's whole
    state, read on one device."""
    P.check_checkpoint(runs, src)


def test_placed_checkpoint_round_trip_and_one_state(runs):
    """The placed run's checkpoint restored under the placement is its
    state bitwise, and the placed and unplaced runs wrote the same whole
    state: the same bytes in both checkpoints."""
    P.check_checkpoint_files(runs)


# ---------------------------------------------------------------------------
# what the port cannot honour
# ---------------------------------------------------------------------------

def test_a_spec_the_port_cannot_honour_raises_naming_the_leaf():
    cfg = dataclasses.replace(P._cfg(ARCHS[0]), num_layers=2)
    ctx = ProcessContext(group=None, rank=0, world=2,
                         device=torch.device("cpu"), dp_size=2, dp_rank=0)
    specs = S.param_spec_tree(tlm.init_params(None, cfg, tp_size=2,
                                              device="meta"), cfg, ctx)
    specs["blocks"]["ffn"]["up"] = ("data", None, "model")
    with pytest.raises(ValueError, match="blocks/ffn/up: a spec cutting "
                                         "the layer axis"):
        tlm.init_params(torch.Generator().manual_seed(0), cfg, ctx=ctx,
                        specs=specs)
    specs["blocks"]["ffn"]["up"] = (None, ("data",), "model", None)
    with pytest.raises(ValueError, match="blocks/ffn/up: a spec of 4 "
                                         "entries"):
        tlm.init_params(torch.Generator().manual_seed(0), cfg, ctx=ctx,
                        specs=specs)
    bad = dataclasses.replace(ctx, world=3)
    with pytest.raises(ValueError, match=r"^blocks/\S+: the model axis's "
                                         r"3 ranks do not divide"):
        tstep.init_train_state(torch.Generator().manual_seed(0), cfg,
                               P._tc("float32"), ctx=bad,
                               specs={"params": S.param_spec_tree(
                                   tlm.init_params(None, cfg, tp_size=2,
                                                   device="meta"), cfg,
                                   make_context(1))})
