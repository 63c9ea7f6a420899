from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_step_,
    adamw_update,
    cosine_lr,
)
from repro_torch.optim.compress import (
    compressed_pmean,
    dequantize_int8,
    quantize_int8,
)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
    "quantize_int8", "dequantize_int8", "compressed_pmean", "adamw_step_",
]
