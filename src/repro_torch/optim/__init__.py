"""Optimizers: the counterpart of ``repro.optim``: AdamW with float32,
bfloat16 or blockwise-int8 moments (LM training) and row-wise Adagrad
(the DLRM tables)."""
from repro_torch.optim.adamw import (  # noqa: F401
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.optim.quant import (  # noqa: F401
    QuantizedTensor,
    dequantize_blockwise,
    quantize_blockwise,
)
from repro_torch.optim.rowwise_adagrad import (  # noqa: F401
    rowwise_adagrad_init,
    rowwise_adagrad_update,
)
