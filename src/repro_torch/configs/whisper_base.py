"""whisper-base — encoder-decoder audio model. [arXiv:2212.04356]

Assigned: 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865, enc-dec with a
conv frontend STUB: per the assignment, ``input_specs()`` provides
precomputed frame embeddings (1500, 512) — the mel+conv stack is not
modelled. 6 encoder + 6 decoder layers; decoder cross-attends to the
encoder output. LayerNorm + GELU, learned positions (modelled with RoPE-free
sinusoidal-equivalent learned table).
"""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,               # decoder layers
    encoder_layers=6,
    encoder_seq_len=1500,       # precomputed frame embeddings (stub frontend)
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    activation="gelu",
    gated_ffn=False,
    norm="layernorm",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        num_layers=2,
        encoder_layers=2,
        encoder_seq_len=32,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        activation="gelu",
        gated_ffn=False,
        norm="layernorm",
    )
