"""granite-8b — llama-architecture code model (IBM). [arXiv:2405.04324]

Assigned: 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    activation="silu",
    rope_theta=10000000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=256,
        activation="silu",
    )
