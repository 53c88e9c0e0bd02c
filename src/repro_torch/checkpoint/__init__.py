"""Checkpoints: the counterpart of ``repro.checkpoint``."""
from repro_torch.checkpoint.store import (  # noqa: F401
    latest_step,
    restore,
    save,
    wait_all,
)
