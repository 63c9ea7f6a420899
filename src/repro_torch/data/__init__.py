from repro_torch.data.pipeline import (
    DataConfig,
    Pipeline,
    batch_at_step,
    to_device,
)

__all__ = ["DataConfig", "Pipeline", "batch_at_step", "to_device"]
