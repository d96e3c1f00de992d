"""Plain PyTorch version of the fused federated server-step kernel (K1).

It composes the two pieces the kernel fuses, in the kernel's operation
order: a left-to-right f32 sum of ``coeff_m · g_m`` (member m's clip scale
× work weight), then the modified-AdaGrad per-leaf update
(``repro_torch.optim.adagrad_math.adagrad_leaf_update``, the function the
optimizer runs).  On the card the kernel is bit-equal to this run eagerly.
"""
from __future__ import annotations

from repro_torch.optim.adagrad_math import adagrad_leaf_update


def weighted_member_sum(g_stack, coeffs):
    """Σ_m coeffs[m] · g_stack[m] in f32, accumulated left to right — the
    kernel's (and TreeServerStep's) exact order."""
    g = coeffs[0] * g_stack[0].float()
    for m in range(1, g_stack.shape[0]):
        g = g + coeffs[m] * g_stack[m].float()
    return g


def server_step_ref(p, g_stack, acc, coeffs, *, lr: float, beta: float = 1.0,
                    weight_decay: float = 0.0):
    """``p``/``acc``: any shape; ``g_stack``: (M, *p.shape); ``coeffs``:
    (M,).  Returns (p', acc'): p' in p's dtype, acc' f32."""
    g = weighted_member_sum(g_stack, coeffs.float())
    return adagrad_leaf_update(p, g, acc, lr=lr, beta=beta,
                               weight_decay=weight_decay)
