"""Synthetic input pipelines."""
from repro_torch.data.synthetic import (  # noqa: F401
    Prefetcher,
    dlrm_batches,
    dlrm_drift_batches,
    lm_batches,
)
