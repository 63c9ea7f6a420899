from repro_torch.train.step import make_train_step

__all__ = ["make_train_step"]
