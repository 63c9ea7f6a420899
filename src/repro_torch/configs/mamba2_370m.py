"""mamba2-370m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=1, num_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50432,  # 50280 padded to a 256 multiple (TP divisibility)
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=4, d_model=64, num_heads=1, num_kv_heads=1, head_dim=16,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
    dtype="float32", param_dtype="float32", remat=False,
)
