"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8, MTP. [arXiv:2412.19437]

Assigned: 61L d_model=7168 128H (GQA kv=128) d_ff=2048 vocab=129280,
MoE 256e top-8. d_ff=2048 is the routed-expert hidden dim (the paper's
moe_intermediate_size); the first 3 layers are dense with the paper's
intermediate_size=18432. Attention is MLA (q_lora 1536, kv_lora 512,
nope 128 + rope 64, v 128). MTP depth 1.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig


CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,               # dense-layer FFN (first_k_dense layers)
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    first_k_dense=3,
    moe_d_ff=2048,            # assigned d_ff: routed-expert hidden dim
    activation="silu",
    rope_theta=10000.0,
    mtp_depth=1,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attention="mla",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        num_experts=8,
        experts_per_token=2,
        num_shared_experts=1,
        first_k_dense=1,
        moe_d_ff=32,
        mtp_depth=1,
    )
