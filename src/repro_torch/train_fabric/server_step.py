"""The server-side round update (port of ``repro.train_fabric.server_step``).

After a federated round's barrier closes, the server turns the arrived
per-member gradients into the next round's weights:

    clip each member's gradient  →  work-weighted mean  →  optimizer

  * :class:`TreeServerStep` — the reference: a leafwise weighted mean (f32,
    left to right over members) followed by the optimizer.  Works with any
    :class:`~repro_torch.optim.Optimizer`.
  * :class:`FusedServerStep` — the paper's modified AdaGrad as ONE kernel
    launch per round: every leaf is flattened into one f32 buffer on the
    params' device and ``kernels/server_step`` (CUDA on the card, its plain
    version on the CPU) does clip-weighted mean + accumulator + update in
    one pass.

Gradients may arrive as host numpy trees (from the wire) or as tensors;
both steps move them to the params' device.  Both consume the same
per-member coefficients from :func:`member_coeffs`, computed once per round
on the unflattened trees, and replay one operation order, so the two are
bitwise equal on the CPU and on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.server_step.ops import server_step_update
from repro_torch.optim import Optimizer
from repro_torch.tree import as_tensor, tree_flatten, tree_leaves, tree_map

__all__ = ["ServerStep", "TreeServerStep", "FusedServerStep",
           "member_coeffs", "member_grad_norms", "param_count"]


def param_count(params) -> int:
    """Total scalar parameters in a tree."""
    return int(sum(leaf.numel() if isinstance(leaf, torch.Tensor)
                   else np.size(leaf) for leaf in tree_leaves(params)))


def member_grad_norms(grads: Sequence) -> torch.Tensor:
    """(M,) f32 global L2 norm of each member's gradient tree.

    Per-leaf squared sums are added left to right in flatten order (dict
    keys sorted, as in JAX) — one reduction order shared by every
    ServerStep, so clip coefficients never differ between them."""
    norms = []
    for g in grads:
        s = None
        for leaf in tree_leaves(g):
            q = torch.sum(torch.square(as_tensor(leaf).float()))
            s = q if s is None else s + q
        norms.append(torch.sqrt(s).cpu())
    return torch.stack(norms)


def member_coeffs(grads: Sequence, works: Sequence[float],
                  clip_norm: Optional[float] = None) -> torch.Tensor:
    """(M,) f32 CPU tensor: each member's normalised work weight times its
    clip scale ``min(1, clip_norm / ‖g_m‖₂)``.  The weighted mean of
    clipped gradients is then simply ``Σ_m coeff_m · g_m``."""
    w = torch.tensor(list(works), dtype=torch.float32)
    w = w / torch.sum(w)
    if clip_norm is not None:
        norms = member_grad_norms(grads)
        w = w * torch.clamp(clip_norm / torch.clamp(norms, min=1e-12),
                            max=1.0)
    return w


class ServerStep:
    """Interface: ``step(grads, works, params, opt_state)`` →
    ``(new_params, new_opt_state)``, where ``grads`` is the round's list
    of arrived per-member gradient trees and ``works`` their work weights
    (same order)."""

    name = "abstract"

    def step(self, grads: Sequence, works: Sequence[float], params,
             opt_state):
        raise NotImplementedError


class TreeServerStep(ServerStep):
    """Reference implementation: clip → leafwise weighted mean (f32, left
    to right over members, each leaf reduced in one pass) →
    ``opt.update``.  The operation order is the one the fused kernel
    replays."""

    name = "tree_map"

    def __init__(self, opt: Optimizer, *, clip_norm: Optional[float] = None):
        self.opt = opt
        self.clip_norm = clip_norm

    def step(self, grads, works, params, opt_state):
        coeffs = member_coeffs(grads, works, self.clip_norm)
        dev = as_tensor(tree_leaves(params)[0]).device
        c = coeffs.to(dev)

        def fuse(*leaves):
            acc = c[0] * as_tensor(leaves[0], dev).float()
            for m in range(1, len(leaves)):
                acc = acc + c[m] * as_tensor(leaves[m], dev).float()
            return acc

        gmean = tree_map(fuse, *grads)
        return self.opt.update(gmean, opt_state, params)


def _flat32(leaves) -> torch.Tensor:
    return torch.cat([as_tensor(leaf).reshape(-1).float()
                      for leaf in leaves])


class FusedServerStep(ServerStep):
    """The modified-AdaGrad server step as one fused kernel launch.

    Every leaf is flattened and concatenated into a single f32 buffer on
    the params' device (each leaf's dtype is restored on the way out), the
    M member gradients are stacked and uploaded as one (M, n) buffer, and
    ``server_step_update`` performs clip-weighted mean + accumulator +
    parameter update in one pass.  Only the paper's optimizer is fused;
    constructing this against another optimizer raises."""

    name = "fused"

    def __init__(self, opt: Optimizer, *, lr: float, beta: float = 1.0,
                 weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None):
        if opt.name != "adagrad":
            raise ValueError(
                f"FusedServerStep fuses the paper's modified AdaGrad; "
                f"got optimizer {opt.name!r} (use TreeServerStep)")
        self.opt = opt
        self.lr, self.beta, self.weight_decay = lr, beta, weight_decay
        self.clip_norm = clip_norm

    def step(self, grads, works, params, opt_state):
        coeffs = member_coeffs(grads, works, self.clip_norm)
        leaves_p, tdef = tree_flatten(params)
        leaves_p = [as_tensor(leaf) for leaf in leaves_p]
        dev = leaves_p[0].device
        pf = _flat32(leaves_p)
        af = _flat32(tdef.flatten_up_to(opt_state["acc"])).to(dev)
        gf = torch.stack([_flat32(tdef.flatten_up_to(g))
                          for g in grads]).to(dev)
        po, ao = server_step_update(
            pf, gf, af, coeffs.to(dev), lr=self.lr, beta=self.beta,
            weight_decay=self.weight_decay)
        new_p, new_a, off = [], [], 0
        for leaf in leaves_p:
            sz = leaf.numel()
            new_p.append(po[off:off + sz].view(leaf.shape).to(leaf.dtype))
            new_a.append(ao[off:off + sz].view(leaf.shape))
            off += sz
        return tdef.unflatten(new_p), {"acc": tdef.unflatten(new_a)}
