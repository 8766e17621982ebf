from repro_torch.optim.optimizers import (
    Optimizer, sgd, momentum, adam, adamw, make_optimizer, apply_updates)
from repro_torch.optim.schedule import make_schedule

__all__ = ["Optimizer", "sgd", "momentum", "adam", "adamw",
           "make_optimizer", "apply_updates", "make_schedule"]
