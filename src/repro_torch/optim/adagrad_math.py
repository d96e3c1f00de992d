"""The paper's modified-AdaGrad update as ONE per-leaf function.

    acc' = acc + g²;   θ' = θ − α · g / sqrt(β + acc')

Port of ``repro.optim.adagrad_math``.  The optimizer
(``repro_torch.optim.optimizers.adagrad``), the plain versions of both
kernels (``repro_torch.kernels.adagrad.ref`` and ``.server_step.ref``) use
this function, and both CUDA kernels replay its float32 operation order
with separately rounded multiplies and adds, so on the card a kernel is
bit-equal to this function run eagerly.

All arithmetic is float32 whatever the parameter dtype (the accumulator is
f32 state); the new parameter is cast back to the parameter's dtype last.
"""
from __future__ import annotations

import torch


def adagrad_leaf_update(p, g, acc, *, lr: float, beta: float = 1.0,
                        weight_decay: float = 0.0):
    """One leaf's modified-AdaGrad step: ``(p, g, acc) -> (p', acc')``.

    ``p``/``g`` may be any float dtype; ``acc`` must be f32.  The f32
    operation order is the JAX package's (``adagrad_math.py:31-36``) and
    the contract the kernels are bit-equal to: change it only together
    with them."""
    gf = g.float()
    if weight_decay:
        gf = gf + weight_decay * p.float()
    a = acc + torch.square(gf)
    step = lr * gf * torch.rsqrt(beta + a)
    return (p.float() - step).to(p.dtype), a


__all__ = ["adagrad_leaf_update"]
