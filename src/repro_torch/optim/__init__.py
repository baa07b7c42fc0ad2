from repro_torch.optim.optimizer import (
    Optimizer, adamw, adafactor, make_optimizer, cosine_schedule,
)

__all__ = [
    "Optimizer", "adamw", "adafactor", "make_optimizer", "cosine_schedule",
]
