from repro_torch.optim.adagrad_math import adagrad_leaf_update
from repro_torch.optim.optimizers import (
    Optimizer,
    adagrad,
    adamw,
    get_optimizer,
    sgd,
)

__all__ = ["Optimizer", "adagrad", "adagrad_leaf_update", "adamw",
           "get_optimizer", "sgd"]
