"""internvl2-2b — InternViT + InternLM2 VLM. [arXiv:2404.16821]

Assigned: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The InternViT frontend is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings (256 tokens, 1024-dim InternViT-300M
width) which an MLP projector maps to d_model and prepends to the text
sequence. The LM backbone is InternLM2-1.8B (llama-style GQA).
"""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    vision_tokens=256,
    vision_dim=1024,
    activation="silu",
    rope_theta=1000000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        vision_tokens=8,
        vision_dim=32,
        activation="silu",
    )
