"""internvl2-2b [vlm] — InternViT frontend STUB (input_specs provides patch
embeddings) + InternLM2 backbone [arXiv:2404.16821]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92672,  # 92553 padded to a 256 multiple
    vision_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=512, vision_tokens=8,
    dtype="float32", param_dtype="float32", remat=False,
)
