"""Plain PyTorch version of the fused modified-AdaGrad kernel (K2).

It is the optimizer's own per-leaf update
(``repro_torch.optim.adagrad_math.adagrad_leaf_update``), so the kernel's
reference and ``repro_torch.optim.adagrad`` cannot drift.
"""
from __future__ import annotations

from repro_torch.optim.adagrad_math import adagrad_leaf_update


def adagrad_ref(p, g, acc, *, lr: float, beta: float = 1.0,
                weight_decay: float = 0.0):
    return adagrad_leaf_update(p, g, acc, lr=lr, beta=beta,
                               weight_decay=weight_decay)
