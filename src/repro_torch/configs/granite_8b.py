"""granite-8b [dense] — llama-arch code model, GQA kv=8 [arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49152, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=512, tie_embeddings=True,
    dtype="float32", param_dtype="float32", remat=False,
)
