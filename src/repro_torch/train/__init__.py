from repro_torch.train.trainer import Trainer, TrainConfig

__all__ = ["Trainer", "TrainConfig"]
