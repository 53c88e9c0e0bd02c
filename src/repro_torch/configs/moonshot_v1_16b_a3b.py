"""moonshot-v1-16b-a3b — Moonlight-16B-A3B (kimi/moonshot), MoE 64e top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]
Assigned: 48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, 64e top-6.
d_ff=1408 is the routed-expert hidden dim (Moonlight follows the
DeepSeek-V3-style fine-grained-expert design, incl. 2 shared experts and a
dense first layer); the shared/dense FFN uses the same 1408 granularity.
"""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    first_k_dense=1,
    moe_d_ff=1408,
    activation="silu",
    rope_theta=50000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=96,
        vocab_size=256,
        num_experts=8,
        experts_per_token=2,
        num_shared_experts=1,
        first_k_dense=1,
        moe_d_ff=96,
        activation="silu",
    )
