"""starcoder2-15b — GQA + RoPE dense code model. [arXiv:2402.19173]

Assigned: 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
StarCoder2-15B uses layernorm + non-gated GELU FFN (GPT-style MLP) and
learned attention with RoPE; ``long_500k`` is skipped (full attention).
"""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",
    gated_ffn=False,
    norm="layernorm",
    rope_theta=100000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=256,
        activation="gelu",
        gated_ffn=False,
        norm="layernorm",
    )
