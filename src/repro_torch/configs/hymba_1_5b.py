"""hymba-1.5b — parallel attention + mamba heads per layer. [arXiv:2411.13676]

Assigned: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16. Hymba fuses attention and SSM (mamba) heads in the same
layer, combining their (normalized) outputs; most layers use sliding-window
attention (1024) with 3 full-attention layers (first/middle/last) — this is
what bounds decode's state (a KV window + O(1) SSM state). Hymba's 128
learnable meta tokens are not modelled, as in the reference.
"""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attention="hybrid_parallel",
    window=1024,
    global_attn_layers=(0, 15, 31),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    activation="silu",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke",
        family="hybrid",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attention="hybrid_parallel",
        window=16,
        global_attn_layers=(0,),
        ssm_state=4,
        ssm_conv=4,
        ssm_expand=2,
    )
