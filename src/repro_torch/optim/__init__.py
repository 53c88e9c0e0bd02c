"""Optimizers: the counterpart of ``repro.optim``.  Row-wise Adagrad, the
DLRM tables' optimizer, is ported; ``adamw`` and ``quant`` come with LM
training."""
from repro_torch.optim.rowwise_adagrad import (  # noqa: F401
    rowwise_adagrad_init,
    rowwise_adagrad_update,
)
