"""LM architecture configuration: the counterpart of ``repro.configs.base``'s
``MLAConfig``, ``ModelConfig``, ``TrainConfig`` and ``ShardingConfig``
(copied field for field, so a config built here and one built there
describe the same model, the same training run and the same mesh knobs).

Every architecture gets one ``repro_torch/configs/<id>.py`` exposing
``CONFIG`` (the published shape) and ``smoke()`` (a reduced same-family
config for CPU tests); ``repro_torch.configs.get_config(name)`` is the
registry.  The port serves every family of the reference: dense, MoE
(GQA and MLA), hybrid, ssm, audio and vlm.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads

    # --- attention flavour ---
    attention: str = "gqa"           # gqa | mla | hybrid_parallel | none
    # sequences longer than this use blockwise (flash-style) attention;
    # below it the full (S, S) score matrix is materialized (§Perf lever)
    attn_chunk_threshold: int = 8192
    window: Optional[int] = None     # sliding-window size (None = full)
    global_attn_layers: Tuple[int, ...] = ()   # layers forced to full attn
    rope_theta: float = 10000.0
    mla: Optional[MLAConfig] = None

    # --- FFN / MoE ---
    activation: str = "silu"
    gated_ffn: bool = True
    num_experts: int = 0             # 0 = dense
    experts_per_token: int = 0
    num_shared_experts: int = 0
    first_k_dense: int = 0           # leading dense layers in a MoE stack
    moe_d_ff: Optional[int] = None   # expert hidden dim (default d_ff)
    moe_capacity_factor: float = 1.25

    # --- SSM (mamba / hymba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- rwkv6 ---
    rwkv_head_size: int = 64
    rwkv_chunk: int = 0       # 0 = per-step scan; >0 = chunk-parallel form

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq_len: int = 0         # precomputed frame embeddings (stub)

    # --- vlm (internvl) ---
    vision_tokens: int = 0           # precomputed patch embeddings (stub)
    vision_dim: int = 0

    # --- misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # MTP (deepseek multi-token prediction) — extra head depth (0 = off)
    mtp_depth: int = 0

    # --- embedding-bag integration (the paper's technique) ---
    vocab_sharding: str = "row"      # row | replicated  (paper RW vs baseline)
    vocab_rw_impl: str = "allgather" # allgather | a2a   (see core/embedding_bag)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.num_heads))
        if self.num_experts and self.moe_d_ff is None:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # --- derived ---
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """True iff decode state is O(1)/O(window) — long_500k eligibility."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # all assigned archs decode (whisper via its decoder)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + stacked blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        H, KH = self.num_heads, self.num_kv_heads
        per_layer = 0
        if self.attention == "mla" and self.mla:
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += d * m.q_lora_rank + m.q_lora_rank * H * qk_hd
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += H * m.v_head_dim * d
        elif self.attention in ("gqa", "hybrid_parallel"):
            per_layer += d * H * hd + 2 * d * KH * hd + H * hd * d
        if self.attention == "hybrid_parallel" or self.family == "ssm" and self.name.startswith("hymba"):
            pass
        ffn = d * ff * (3 if self.gated_ffn else 2)
        n_moe = self.num_layers - self.first_k_dense if self.is_moe else 0
        n_dense = self.num_layers - n_moe
        per_moe = (self.num_experts + self.num_shared_experts) * \
            d * (self.moe_d_ff or ff) * (3 if self.gated_ffn else 2) + \
            d * self.num_experts
        total = n_dense * (per_layer + ffn) + n_moe * (per_layer + per_moe)
        total += V * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        per_expert = d * (self.moe_d_ff or self.d_ff) * (3 if self.gated_ffn else 2)
        n_moe = self.num_layers - self.first_k_dense
        inactive = n_moe * (self.num_experts - self.experts_per_token) * per_expert
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """LM training's knobs: the reference's ``TrainConfig``, field for
    field."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_accum: int = 1
    optimizer_state_dtype: str = "float32"   # float32 | bfloat16 | int8
    remat: bool = True
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """The mesh-level knobs of a ``ParallelContext``: the reference's
    ``ShardingConfig``, field for field.

    On the simulated ranks of one card (``core/parallel.py``) only
    ``decode_kv_seq_sharded`` changes what runs: True takes decode
    attention's flash-decode over the ranks' slices of the cache, False
    the local attention over the whole cache.  ``fsdp``,
    ``sequence_parallel`` and ``logits_vocab_sharded`` are layouts in the
    reference (parameter and activation sharding hints to GSPMD) that
    change no value; the port keeps every tensor whole and models none of
    them.  ``embed_rs_dtype`` has no reader in the reference either: a
    field with no behaviour."""
    fsdp: bool = True                 # shard params/opt-state over data axes
    sequence_parallel: bool = True    # shard activations over model between blocks
    embed_rs_dtype: str = "float32"   # reduce-scatter dtype for pooled embeds
    logits_vocab_sharded: bool = True # never materialize replicated logits
    decode_kv_seq_sharded: bool = True  # flash-decode over model axis
