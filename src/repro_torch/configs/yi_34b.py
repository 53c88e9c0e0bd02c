"""yi-34b — llama-architecture GQA dense model. [arXiv:2403.04652]

Assigned: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    activation="silu",
    rope_theta=5000000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=256,
        activation="silu",
    )
