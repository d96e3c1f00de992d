"""Optimizers over trees of tensors (port of ``repro.optim.optimizers``).

The default is the paper's **modified AdaGrad** (Sukiyaki §3.1):

    θ_{t} = θ_{t-1} − α · g_t / sqrt(β + Σ_{u<=t} g_u²)

— plain AdaGrad with the stabilising constant β *inside* the square root,
so early steps (tiny accumulated squared gradient) don't explode.  With
``use_kernel=True`` all the leaves of a step go through the fused CUDA
kernel in ``repro_torch/kernels/adagrad`` together: one launch a step for
a tree of one dtype (the JAX package launches its Pallas kernel once a
leaf), every leaf's result the same as its own launch would give.

Under a mesh the leaves are DTensors.  The kernel takes plain tensors, so
each leaf's update runs on its local shard (:func:`local_shards`): the
gradient is first brought to the parameter's placements (a ``Partial()``
gradient reduced), the accumulator likewise, and the results are wrapped
back with the parameter's placements.  The other optimizers run their
torch ops on the DTensors.

Every optimizer has the JAX package's interface:
``Optimizer(init(params), update(grads, state, params) -> (params, state))``.
Updates are functional: new tensors, the inputs left as they are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.optim.adagrad_math import adagrad_leaf_update
from repro_torch.sharding.spec import is_dtensor
from repro_torch.tree import tree_flatten, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (params, state)
    name: str = ""


def _zeros_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


def _leafwise(one, n_out: int, params, *trees):
    """Apply ``one(p, *leaves)``, which returns ``n_out`` values, leaf by
    leaf; returns ``n_out`` trees shaped like ``params``."""
    flat_p, tdef = tree_flatten(params)
    flats = [tdef.flatten_up_to(t) for t in trees]
    outs = [one(p, *xs) for p, *xs in zip(flat_p, *flats)]
    return tuple(tdef.unflatten([o[i] for o in outs]) for i in range(n_out))


def local_shards(p, *others):
    """``(p, *others)`` as plain tensors for a kernel: for a DTensor ``p``,
    its local shard, and each of ``others`` (its gradient, its optimizer
    state) redistributed to ``p``'s placements first, so that a gradient
    in a ``Partial()`` placement is reduced before the kernel reads it.
    Plain tensors pass through."""
    if not is_dtensor(p):
        return (p, *others)
    mesh, pl = p.device_mesh, tuple(p.placements)
    out = [p.to_local()]
    for t in others:
        if tuple(t.placements) != pl:
            t = t.redistribute(mesh, pl)
        out.append(t.to_local().contiguous())
    return tuple(out)


def like(p, local):
    """``local`` (a shard computed from ``p``'s local shard) as a DTensor
    placed as ``p`` is; plain when ``p`` is plain."""
    if not is_dtensor(p):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              shape=p.shape, stride=p.stride(),
                              run_check=False)


def adagrad(lr: float, beta: float = 1.0, weight_decay: float = 0.0,
            use_kernel: bool = False) -> Optimizer:
    """The paper's modified AdaGrad.  ``beta`` is the paper's β."""
    kw = dict(lr=lr, beta=beta, weight_decay=weight_decay)
    if use_kernel:
        # imported here: the kernel's plain version imports this package
        from repro_torch.kernels.adagrad.ops import adagrad_update_leaves

    def init(params):
        return {"acc": tree_map(_zeros_f32, params)}

    def update(grads, state, params):
        if use_kernel:
            flat_p, tdef = tree_flatten(params)
            loc = [local_shards(p, g, a) for p, g, a in zip(
                flat_p, tdef.flatten_up_to(grads),
                tdef.flatten_up_to(state["acc"]))]
            new_p, new_acc = adagrad_update_leaves(
                [x[0] for x in loc], [x[1] for x in loc],
                [x[2] for x in loc], **kw)
            new_p = [like(p, x) for p, x in zip(flat_p, new_p)]
            new_acc = [like(p, x) for p, x in zip(flat_p, new_acc)]
            return tdef.unflatten(new_p), {"acc": tdef.unflatten(new_acc)}
        new_p, new_acc = _leafwise(
            lambda p, g, a: adagrad_leaf_update(p, g, a, **kw),
            2, params, grads, state["acc"])
        return new_p, {"acc": new_acc}

    return Optimizer(init, update, "adagrad")


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params),
                "t": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params):
        t = state["t"] + 1
        bc1 = 1.0 - b1 ** t.float()
        bc2 = 1.0 - b2 ** t.float()

        def one(p, g, m, v):
            gf = g.float()
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * torch.square(gf)
            step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + lr * weight_decay * p.float()
            return (p.float() - step).to(p.dtype), m, v

        new_p, m, v = _leafwise(one, 3, params, grads, state["m"], state["v"])
        return new_p, {"m": m, "v": v, "t": t}

    return Optimizer(init, update, "adamw")


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"mom": tree_map(_zeros_f32, params)}
        return {}

    def update(grads, state, params):
        if momentum:
            def one(p, g, m):
                m = momentum * m + g.float()
                return (p.float() - lr * m).to(p.dtype), m
            new_p, mom = _leafwise(one, 2, params, grads, state["mom"])
            return new_p, {"mom": mom}
        new_p = tree_map(
            lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
            params, grads)
        return new_p, state

    return Optimizer(init, update, "sgd")


def get_optimizer(name: str, lr: float, *, adagrad_beta: float = 1.0,
                  weight_decay: float = 0.0, **kw) -> Optimizer:
    if name == "adagrad":
        return adagrad(lr, beta=adagrad_beta, weight_decay=weight_decay, **kw)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay, **kw)
    if name == "sgd":
        return sgd(lr, **kw)
    raise KeyError(f"unknown optimizer {name!r}")


__all__ = ["Optimizer", "adagrad", "adamw", "get_optimizer", "sgd"]
