"""mistral-nemo-12b [dense] — GQA kv=8, head_dim=128 (not d/H), 128k ctx
[hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="nemo-smoke", family="dense",
    num_layers=3, d_model=80, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=512, rope_theta=1e6,
    dtype="float32", param_dtype="float32", remat=False,
)
