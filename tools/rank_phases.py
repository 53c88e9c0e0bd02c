"""Run `chip_smoke.py`'s phases of the distributed embedding bag alone.

    python3 tools/rank_phases.py

Phase 1 (environment and the kernels' build), phase 3 (the uncached
engine at full width, whose tables and scores the others read), phase 7
(the simulated ranks) and phase 7p (ranks as processes: the gloo leg on
one card, and the NCCL leg where there are 2 or more).  A quicker check
of the per-rank path than the whole script, on as many cards as the
machine has.  Exits non-zero if a check fails; the last line is
``{"ok": true, "cards": N}``.
"""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
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
    unc = cs.phase_uncached(pt, eg, oa)
    dist = cs.phase_distributed(pt, eg, oa, unc)
    cs.phase_ranks(pt, unc, dist)
    print(json.dumps({"ok": True, "cards": torch.cuda.device_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
