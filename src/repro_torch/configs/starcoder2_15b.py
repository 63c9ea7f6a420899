"""starcoder2-15b [dense] — GQA kv=4, RoPE [arXiv:2402.19173]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512,
    dtype="float32", param_dtype="float32", remat=False,
)
