"""nemotron-4-340b — GQA + squared-ReLU dense giant. [arXiv:2402.16819]

Assigned: 96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
Squared-ReLU, non-gated FFN; the 256000-row vocabulary is the largest
embedding table in the pool — the headline case for the paper's
row-wise-sharded embedding technique.
"""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="relu2",
    gated_ffn=False,
    norm="layernorm",
    rope_theta=10000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=256,
        activation="relu2",
        gated_ffn=False,
        norm="layernorm",
    )
