"""qwen1.5-110b [dense] — GQA kv=8, QKV bias [hf:Qwen/Qwen1.5-110B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=49152, vocab_size=152064, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=512, qkv_bias=True,
    dtype="float32", param_dtype="float32", remat=False,
)
