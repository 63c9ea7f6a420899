"""Model configuration (the port's own copy of ``repro.models.config``).

One frozen dataclass with every field of the JAX package's ``ModelConfig``,
so a JAX config converts with ``ModelConfig(**dataclasses.asdict(cfg))``.
Family semantics:

  dense   — attention + MLP every layer
  moe     — attention + (shared+routed top-k) MoE every `moe_every` layers
  ssm     — Mamba2/SSD blocks only (attention-free)
  hybrid  — Jamba-style: 1 attention layer per `attn_every` layers, MoE every
            `moe_every` layers, SSD otherwise
  vlm     — dense decoder LM with precomputed patch embeddings in front
  audio   — enc-dec (Whisper): encoder over precomputed frame embeddings,
            decoder with cross-attention (``models.encdec``)

The port runs every family; the serve path admits the dense, MoE and VLM
ones without MLA, as the JAX scheduler does.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention
    qkv_bias: bool = False
    rope_theta: float = 1e4
    attn_chunk: int = 1024         # flash chunk (train/prefill)
    flash_threshold: int = 2048    # use chunked flash above this seq len

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0
    moe_every: int = 1             # MoE on layers where (i % moe_every)==moe_offset
    moe_offset: int = 0
    moe_d_ff: int = 0
    moe_dispatch_blocks: int = 0   # block-local dispatch (= data shards); 0 = global
    dense_layers: int = 0          # leading dense-MLP layers (DeepSeek-V2: 1)
    capacity_factor: float = 1.25

    # MLA (DeepSeek-V2)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM / hybrid
    attn_every: int = 0            # hybrid: attention on layers (i % attn_every)==attn_offset
    attn_offset: int = 0
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # enc-dec (audio)
    encoder_layers: int = 0
    encoder_seq: int = 0           # whisper-base: 1500 frames
    cross_attention: bool = False

    # vlm
    vision_tokens: int = 0

    # numerics / structure
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots (checkpoint policy)
    decode_uniform_length: bool = False  # batch-uniform decode: DUS cache update
    logits_softcap: float = 0.0
    unroll: bool = False           # python-unroll layer scans (dry-run probes)
    ssd_vectorized: bool = False   # vectorize SSD chunks (probes: exact flops)

    @property
    def d_inner(self) -> int:      # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' — the mixer of layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "attn" if (i % self.attn_every) == self.attn_offset else "ssm"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'mlp' | 'moe' — the FFN of layer i."""
        if self.moe_experts and i >= self.dense_layers and (
            i % self.moe_every
        ) == self.moe_offset:
            return "moe"
        return "mlp"

    @property
    def pattern_period(self) -> int:
        """Length of the repeating layer pattern (for scan-stacking)."""
        import math
        p = 1
        if self.family == "hybrid":
            p = math.lcm(p, self.attn_every)
        if self.moe_experts:
            p = math.lcm(p, self.moe_every)
        return p

    def validate(self) -> None:
        assert self.num_heads % self.num_kv_heads == 0
        if self.family in ("hybrid",):
            assert self.attn_every > 0
            assert self.num_layers % self.pattern_period == 0, (
                self.num_layers, self.pattern_period
            )
        if self.moe_experts:
            assert self.moe_top_k > 0 and self.moe_d_ff > 0
        if self.family == "audio":
            assert self.encoder_layers > 0 and self.cross_attention
        if self.family != "ssm" and not self.mla:
            pass  # head_dim free-standing (e.g. Nemo: 128 with d_model/H=160)
