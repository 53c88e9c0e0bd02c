"""Run `chip_smoke.py`'s phases of ranks as processes alone.

    python3 tools/rank_phases.py [7p] [6p] [8p | 8p-nccl] [7tp] [8tp] [8dp]
        [8lr | 8lr-nccl | 8lr-ds] [9]

Phase 1 (environment and the kernels' build), phase 3 (the uncached
engine at full width, whose tables and scores the others read), phase 4
(the cached engine over the host tier), phase 6 (the remote tier on
simulated hosts), phase 6b (pipelined), phase 7 (the simulated ranks),
phase 7p (ranks as processes: the gloo leg on one card with its race leg
of back-to-back one-sided exchanges, and the NCCL leg where there are 2
or more) and phase 6p (the remote tier with one host
per process: the gloo leg, and the NCCL leg where there are 2 or more
cards, one process a card, the bulk fetch over the group's
reduce-scatter and the one-sided puts across cards through CUDA IPC)
and phase 8p (LM serving with each rank a process: granite-8b,
moonshot-v1-16b-a3b and deepseek-v3-671b (3 dense MLA layers and 1 MoE
of 256 experts, 64 a rank) cut in depth, 4 gloo processes sharing the
card in one spawn; on 4 cards also the NCCL leg, moonshot at all 48
layers, one process a card; ``8p-nccl`` runs that leg alone), phase 7tp (DLRM training at
full width with each rank a process: 2 steps of row-wise Adagrad and SGD
a strategy, 4 gloo processes sharing the card, table-wise 2, held to the
one-device flow or the simulated ranks') and phase 8tp (LM training with
each rank a process: granite-8b at 2 layers and moonshot-v1-16b-a3b at
4, Trainer steps held to make_context(4)'s, and a resume) and phase 8dp
(a (2, 2) mesh of ranks as processes: DLRM flushes at full width and
DLRM training, each data group its half of the batch, held to
make_context(2, dp_size=2)'s) and phase 8lr (the serve and train
launchers' rank functions on a (2, 2) mesh: granite-8b served at 12
layers, each rank drawing only its share, and trained at 2 layers under
the reference's state placement with a checkpoint, a resume and a tied
head, held to make_context(2, dp_size=2)'s; on 4 cards its NCCL legs
serve and train granite-8b at all 36 layers, then deepseek-v3-671b:
served at 7 layers (3 dense, 4 MoE; 128 experts a rank) with decode held
to the forward, and trained at 4 layers (3 dense, 1 MoE) under the
placement with step 1 held to a no-grad loss and each rank's state
bytes to the specs'; ``8lr-nccl`` runs the NCCL legs alone, ``8lr-ds``
the deepseek-v3 leg alone) and phase 9 (the five examples on the card,
quickstart's and dlrm_inference's rank functions on a (1, 4) mesh of
processes); on 4 cards all also run their NCCL legs, one process
a card.  A quicker check of
the per-rank paths than the whole script, on as many cards as the
machine has.
Naming 7p, 6p, 8p, 7tp, 8tp, 8dp, 8lr or 9 runs that one and only the
phases it reads (7p: 1, 3, 7; 6p: 1, 3, 4, 6, 6b; 8p, 7tp, 8tp, 8dp,
8lr, 9: 1); 7p, 6p and 8p by default.  Phase 8t's deepseek-v3-671b leg,
(e), runs in the whole script only.
Exits non-zero if a check fails; the last line is ``{"ok": true,
"cards": N}``.
"""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    wanted = set(argv) or {"7p", "6p", "8p"}
    if not wanted <= {"7p", "6p", "8p", "8p-nccl", "7tp", "8tp", "8dp",
                      "8lr", "8lr-nccl", "8lr-ds", "9"}:
        print(f"rank_phases: unknown phase(s) {sorted(wanted)}; name 7p, "
              f"6p, 8p (or 8p-nccl), 7tp, 8tp, 8dp, 8lr (or 8lr-nccl, "
              f"8lr-ds) "
              f"and/or 9", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("rank_phases: no CUDA device is available", file=sys.stderr)
        return 1
    pt = cs.port_namespace()
    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import onesided_a2a as oa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_environment(build)
    if wanted & {"7p", "6p"}:
        _dlrm_rank_phases(cs, pt, eg, oa, wanted)
    if "8p" in wanted:
        cs.phase_lm_ranks(pt, (eg, oa, pt.fa))
    elif "8p-nccl" in wanted:
        cs.phase_lm_ranks(pt, (eg, oa, pt.fa), backends=("nccl",))
    if "7tp" in wanted:
        cs.phase_train_ranks(pt, eg, oa)
    if "8tp" in wanted:
        cs.phase_lm_train_ranks(pt, (eg, oa, pt.fa))
    if "8dp" in wanted:
        cs.phase_dp_ranks(pt, (eg, oa, pt.fa))
    if "8lr" in wanted:
        cs.phase_launch_ranks(pt, (eg, oa, pt.fa))
    elif "8lr-nccl" in wanted:
        cs.phase_launch_ranks(pt, (eg, oa, pt.fa), backends=("nccl",))
    elif "8lr-ds" in wanted:
        cs.phase_launch_ranks(pt, (eg, oa, pt.fa), backends=("ds",))
    if "9" in wanted:
        cs.phase_examples(pt, (eg, oa, pt.fa))
    print(json.dumps({"ok": True, "cards": torch.cuda.device_count()}))
    return 0


def _dlrm_rank_phases(cs, pt, eg, oa, wanted) -> None:
    """Phases 7p and 6p with the phases they read; phase 3's tables are
    freed when they return."""
    unc = cs.phase_uncached(pt, eg, oa)
    if "6p" in wanted:
        cached = cs.phase_cached(pt, eg, oa, unc)
        remote = cs.phase_remote(pt, eg, oa, unc, cached)
        piped = cs.phase_pipelined(pt, eg, oa, unc, cached, remote)
    if "7p" in wanted:
        dist = cs.phase_distributed(pt, eg, oa, unc)
        cs.phase_ranks(pt, unc, dist)
    if "6p" in wanted:
        cs.phase_remote_ranks(pt, unc, remote, piped)
    del unc
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
