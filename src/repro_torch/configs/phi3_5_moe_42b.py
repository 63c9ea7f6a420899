"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2, GQA kv=8
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    moe_experts=16, moe_top_k=2, moe_d_ff=6400,
)

SMOKE = ModelConfig(
    name="phi35-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512,
    moe_experts=4, moe_top_k=2, moe_d_ff=96,
    dtype="float32", param_dtype="float32", remat=False,
)
