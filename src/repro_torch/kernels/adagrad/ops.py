"""Public wrappers of the fused modified-AdaGrad kernel (K2).

:func:`adagrad_update_leaves` takes a list of leaves, checks them, then
dispatches by their device: CUDA tensors launch ``kernel.cu`` on the
current stream (or raise), one launch for each (p dtype, g dtype) pair
present and each :data:`MAX_LEAVES` leaves of it; CPU tensors run the plain
version in ``ref.py`` leaf by leaf; meta tensors get empty outputs and
count the launches the card would make (the dry-run's route).
:func:`adagrad_update` is the same for a list of one.  Each wrapper adds
one to its own ``launches`` for every launch it makes, and nothing else
does; the meta route adds to ``meta_launches`` instead.  :func:`work` is
the kernel's useful work, reported on every route to an open accounting
mode.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.adagrad.ref import adagrad_ref
from repro_torch.kernels.build import (accounted, launch, meta_launch,
                                       refuse_dtensor, route)

_DTYPES = (torch.float32, torch.bfloat16)
#: leaves a launch takes (kernel.cu's kMaxLeaves)
MAX_LEAVES = 64

_PP = ctypes.POINTER(ctypes.c_void_p)
_ARGTYPES = [_PP, _PP, _PP, _PP, _PP, ctypes.POINTER(ctypes.c_longlong),
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_float]


def _check(p, g, acc) -> None:
    for name, t in (("p", p), ("g", g), ("acc", acc)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        refuse_dtensor(name, t)
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, p "
                             f"{tuple(p.shape)}")
    if p.dtype not in _DTYPES or g.dtype not in (p.dtype, torch.float32):
        raise TypeError(f"p must be float32 or bfloat16 and g in p's dtype "
                        f"or float32, got {p.dtype} and {g.dtype}")
    if acc.dtype != torch.float32:
        raise TypeError(f"acc must be float32, got {acc.dtype}")


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def work(ps, gs) -> tuple:
    """(flops, bytes) of one call over leaves ``ps`` with gradients
    ``gs``.  Bytes: p, g and acc read and p' and acc' written once.
    Operations: 7 an element (g*g, the add into acc, beta + acc', its
    rsqrt, lr*g, the product and the subtraction)."""
    nbytes = sum(p.numel() * (2 * p.element_size() + g.element_size() + 8)
                 for p, g in zip(ps, gs))
    return 7 * sum(p.numel() for p in ps), nbytes


def _launch_groups(ps, gs) -> list:
    """The leaves of each launch: those of one (p dtype, g dtype) pair,
    empty leaves left out, :data:`MAX_LEAVES` at a time."""
    pairs: dict = {}
    for i, (p, g) in enumerate(zip(ps, gs)):
        if p.numel():
            pairs.setdefault((p.dtype, g.dtype), []).append(i)
    return [leaves[lo:lo + MAX_LEAVES] for leaves in pairs.values()
            for lo in range(0, len(leaves), MAX_LEAVES)]


def _update(counter, ps, gs, accs, lr, beta, weight_decay):
    """The checked leaves' update; each launch adds one to
    ``counter.launches`` (on the meta route, to ``counter.meta_launches``).
    """
    if not ps:
        return [], []
    where = route(ps[0].device, "adagrad")
    with accounted("adagrad", work(ps, gs)):
        if where == "cpu":
            outs = [adagrad_ref(p, g, a, lr=lr, beta=beta,
                                weight_decay=weight_decay)
                    for p, g, a in zip(ps, gs, accs)]
            return [o[0] for o in outs], [o[1] for o in outs]
        p_out = [torch.empty_like(p) for p in ps]
        acc_out = [torch.empty_like(a) for a in accs]
        for part in _launch_groups(ps, gs):
            if where == "meta":
                meta_launch(counter)
                continue
            launch(counter, "adagrad", "repro_adagrad_update_leaves",
                   _ARGTYPES, ps[0].device,
                   *(_pointers([ts[i] for i in part])
                     for ts in (ps, gs, accs, p_out, acc_out)),
                   (ctypes.c_longlong * len(part))(
                       *(ps[i].numel() for i in part)),
                   len(part), int(ps[part[0]].dtype == torch.bfloat16),
                   int(gs[part[0]].dtype == torch.bfloat16), float(lr),
                   float(beta), int(bool(weight_decay)),
                   float(weight_decay))
    return p_out, acc_out


def adagrad_update_leaves(ps, gs, accs, *, lr: float, beta: float = 1.0,
                          weight_decay: float = 0.0):
    """Every leaf's modified-AdaGrad step: lists ``ps``, ``gs``, ``accs``
    of one length, leaf i as :func:`adagrad_update` takes it, all on one
    device.  Returns ``(list of p', list of acc')``, each leaf's bit-equal
    to its own :func:`adagrad_update`."""
    ps, gs, accs = list(ps), list(gs), list(accs)
    if not len(ps) == len(gs) == len(accs):
        raise ValueError(f"need lists of one length, got {len(ps)} p, "
                         f"{len(gs)} g and {len(accs)} acc")
    for p, g, acc in zip(ps, gs, accs):
        _check(p, g, acc)
    devices = {p.device for p in ps}
    if len(devices) > 1:
        raise ValueError(f"leaves on more than one device: {devices}")
    return _update(adagrad_update_leaves, ps, gs, accs, lr, beta,
                   weight_decay)


def adagrad_update(p, g, acc, *, lr: float, beta: float = 1.0,
                   weight_decay: float = 0.0):
    """One leaf's modified-AdaGrad step ``(p, g, acc) -> (p', acc')``:
    ``p`` f32 or bf16, ``g`` in ``p``'s dtype or f32, ``acc`` f32, one
    shape, contiguous, on one device.  ``p'`` is in ``p``'s dtype, ``acc'``
    f32."""
    _check(p, g, acc)
    (p_out,), (acc_out,) = _update(adagrad_update, [p], [g], [acc], lr,
                                   beta, weight_decay)
    return p_out, acc_out


adagrad_update.launches = 0
adagrad_update_leaves.launches = 0
adagrad_update.meta_launches = 0
adagrad_update_leaves.meta_launches = 0

__all__ = ["MAX_LEAVES", "adagrad_update", "adagrad_update_leaves", "work"]
