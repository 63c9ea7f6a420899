"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
every other layer [arXiv:2403.19887]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    moe_experts=16, moe_top_k=2, moe_every=2, moe_offset=1, moe_d_ff=24576,
    attn_every=8, attn_offset=4,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    moe_experts=4, moe_top_k=2, moe_every=2, moe_offset=1, moe_d_ff=96,
    attn_every=8, attn_offset=4,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
    dtype="float32", param_dtype="float32", remat=False,
)
