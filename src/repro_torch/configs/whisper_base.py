"""whisper-base [audio] — enc-dec, conv frontend STUB (input_specs provides
frame embeddings) [arXiv:2212.04356]. 6 encoder + 6 decoder layers."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=52224,  # 51865 padded to a 256 multiple (TP divisibility)
    encoder_layers=6, encoder_seq=1500, cross_attention=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    encoder_layers=2, encoder_seq=24, cross_attention=True,
    dtype="float32", param_dtype="float32", remat=False,
)
