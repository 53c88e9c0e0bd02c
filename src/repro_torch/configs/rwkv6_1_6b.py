"""rwkv6-1.6b — Finch: attention-free, data-dependent decay. [arXiv:2404.05892]

Assigned: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
Head size 64 (32 heads); per-head (64, 64) wkv state → O(1) decode state.
Time-mix uses the Finch data-dependent decay w = exp(-exp(w0 + lora(x)))
with token-shift low-rank interpolation.
"""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,               # d_model / rwkv_head_size
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    attention="none",
    rwkv_head_size=64,
    # the chunk-parallel time mix (models/ssm.rwkv_time_mix_chunked) over
    # chunks of 1024 tokens for prefill; 0 selects the per-step scan
    rwkv_chunk=1024,
    activation="relu2",         # rwkv channel-mix uses squared relu
    gated_ffn=False,
    norm="layernorm",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        attention="none",
        rwkv_head_size=16,
        activation="relu2",
        gated_ffn=False,
        norm="layernorm",
    )
