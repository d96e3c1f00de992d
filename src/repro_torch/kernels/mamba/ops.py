"""Public wrapper of the Mamba selective-scan kernel (K4).

:func:`mamba_scan` checks its tensors, then dispatches by their device:
CUDA tensors launch ``kernel.cu`` on the current stream (or raise), CPU
tensors run the plain version in ``ref.py``, meta tensors get empty
outputs (the dry-run's route).  Only a launch adds one to
``mamba_scan.launches``, and only the meta route to
``mamba_scan.meta_launches``; :func:`work` is the kernel's useful work,
reported on every route to an open accounting mode.  The kernel has no backward (nor has the JAX
package's), so an input that requires grad is refused.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (accounted, launch, meta_launch,
                                       refuse_dtensor, route)
from repro_torch.kernels.mamba.ref import mamba_scan_ref

D_STATES = (8, 16, 32)
_DTYPES = (torch.float32, torch.bfloat16)

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]


def _check(dt, x, b_t, c_t, a, h0) -> None:
    named = (("dt", dt), ("x", x), ("b_t", b_t), ("c_t", c_t), ("a", a),
             ("h0", h0))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        refuse_dtensor(name, t)
        if t.device != dt.device:
            raise ValueError(f"{name} is on {t.device}, dt on {dt.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad, but mamba_scan has no "
                             f"backward")
    if x.dtype not in _DTYPES or b_t.dtype != x.dtype or c_t.dtype != x.dtype:
        raise TypeError(f"x, b_t, c_t must share a dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {b_t.dtype}, {c_t.dtype}")
    for name, t in (("dt", dt), ("a", a), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if dt.dim() != 3 or b_t.dim() != 3:
        raise ValueError(f"dt must be (B, T, DI) and b_t (B, T, ds), got "
                         f"{tuple(dt.shape)} and {tuple(b_t.shape)}")
    b, t, di = dt.shape
    ds = b_t.shape[2]
    if (x.shape != dt.shape or b_t.shape != (b, t, ds)
            or c_t.shape != (b, t, ds) or a.shape != (di, ds)
            or h0.shape != (b, di, ds)):
        raise ValueError(
            f"shapes disagree: dt/x {tuple(dt.shape)}, {tuple(x.shape)}; "
            f"b_t/c_t {tuple(b_t.shape)}, {tuple(c_t.shape)}; a "
            f"{tuple(a.shape)}; h0 {tuple(h0.shape)}")
    if ds not in D_STATES or 0 in (b, t, di):
        raise ValueError(f"need ds in {D_STATES} and non-empty inputs, got "
                         f"dt {tuple(dt.shape)}, ds {ds}")


def work(dt, x, b_t, c_t, a, h0) -> tuple:
    """(flops, bytes) of one call.  Bytes: dt, x, b_t, c_t, a and h0 read
    and y and hT (f32) written once.  Operations: 6 per state element a
    step (dt*a, da*h, dx*b, their sum, h*c and its add into y) and 1 per
    channel a step (dx = dt*x); the exps are not counted (kernel.cu notes
    their own limit)."""
    b, t, di = dt.shape
    nbytes = (sum(z.numel() * z.element_size()
                  for z in (dt, x, b_t, c_t, a, h0))
              + 4 * dt.numel() + 4 * h0.numel())
    return b * t * di * (6 * b_t.shape[2] + 1), nbytes


def mamba_scan(dt, x, b_t, c_t, a, h0):
    """The selective scan ``h_t = exp(dt_t a) h + (dt_t x_t) b_t``,
    ``y_t = h_t c_t``: dt (B, T, DI) f32; x (B, T, DI) and b_t, c_t
    (B, T, ds) f32 or bf16 (one dtype); a (DI, ds) f32, already negative;
    h0 (B, DI, ds) f32; ds in {8, 16, 32}; all contiguous on one device.
    Returns (y (B, T, DI) f32, hT (B, DI, ds) f32)."""
    _check(dt, x, b_t, c_t, a, h0)
    where = route(dt.device, "mamba_scan")
    with accounted("mamba", work(dt, x, b_t, c_t, a, h0)):
        if where == "cpu":
            return mamba_scan_ref(dt, x, b_t, c_t, a, h0)
        b, t, di = dt.shape
        y = torch.empty_like(dt)
        hT = torch.empty_like(h0)
        if where == "meta":
            meta_launch(mamba_scan)
            return y, hT
        launch(mamba_scan, "mamba", "repro_mamba_scan", _ARGTYPES,
               dt.device, dt.data_ptr(), x.data_ptr(), b_t.data_ptr(),
               c_t.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
               hT.data_ptr(), b, t, di, b_t.shape[2],
               int(x.dtype == torch.bfloat16))
    return y, hT


mamba_scan.launches = 0
mamba_scan.meta_launches = 0

__all__ = ["D_STATES", "mamba_scan", "work"]
