"""LM training: the counterpart of ``repro.train``."""
from repro_torch.train.step import (  # noqa: F401
    init_train_state,
    lm_loss,
    make_train_step,
    softmax_xent_chunked,
)
