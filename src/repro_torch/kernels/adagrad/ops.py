"""Public wrapper of the fused modified-AdaGrad kernel (K2).

:func:`adagrad_update` checks its tensors, then dispatches by their device:
CUDA tensors launch ``kernel.cu`` on the current stream (or raise), CPU
tensors run the plain version in ``ref.py``.  Only a launch adds one to
``adagrad_update.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.adagrad.ref import adagrad_ref
from repro_torch.kernels.build import launch, runs_kernel

_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
             ctypes.c_float]


def _check(p, g, acc) -> None:
    for name, t in (("p", p), ("g", g), ("acc", acc)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
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


def adagrad_update(p, g, acc, *, lr: float, beta: float = 1.0,
                   weight_decay: float = 0.0):
    """One leaf's modified-AdaGrad step ``(p, g, acc) -> (p', acc')``:
    ``p`` f32 or bf16, ``g`` in ``p``'s dtype or f32, ``acc`` f32, one
    shape, contiguous, on one device.  ``p'`` is in ``p``'s dtype, ``acc'``
    f32."""
    _check(p, g, acc)
    if not runs_kernel(p.device, "adagrad"):
        return adagrad_ref(p, g, acc, lr=lr, beta=beta,
                           weight_decay=weight_decay)
    p_out, acc_out = torch.empty_like(p), torch.empty_like(acc)
    if p.numel():
        launch(adagrad_update, "adagrad", "repro_adagrad_update", _ARGTYPES,
               p.device, p.data_ptr(), g.data_ptr(), acc.data_ptr(),
               p_out.data_ptr(), acc_out.data_ptr(), p.numel(),
               int(p.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16),
               float(lr), float(beta), int(bool(weight_decay)),
               float(weight_decay))
    return p_out, acc_out


adagrad_update.launches = 0

__all__ = ["adagrad_update"]
