"""deepseek-v2-236b [moe] — MLA kv_lora=512(+64 rope), 2 shared + 160 routed
top-6, leading dense layer [arXiv:2405.04434].

Note: d_ff=12288 is the dense (layer-0) FFN width; the assigned d_ff=1536 is
the per-expert width (moe_d_ff)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128, head_dim=128,
    d_ff=12288, vocab_size=102400,
    moe_experts=160, moe_top_k=6, moe_shared=2, moe_d_ff=1536, dense_layers=1,
    mla=True, q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
    qk_rope_dim=64, v_head_dim=128,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=160, vocab_size=512,
    moe_experts=8, moe_top_k=2, moe_shared=2, moe_d_ff=48, dense_layers=1,
    mla=True, q_lora_rank=32, kv_lora_rank=24, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16,
    dtype="float32", param_dtype="float32", remat=False,
)
