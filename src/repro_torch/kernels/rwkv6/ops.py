"""Public wrapper of the RWKV-6 WKV kernel (K5).

:func:`wkv` checks its tensors, then dispatches by their device: CUDA
tensors launch ``kernel.cu`` on the current stream (or raise), CPU tensors
run the plain version in ``ref.py``, meta tensors get empty outputs (the
dry-run's route).  Only a launch adds one to ``wkv.launches``, and only
the meta route to ``wkv.meta_launches``; :func:`work` is the kernel's
useful work, reported on every route to an open accounting mode.  The kernel has no backward (nor has the JAX package's),
so an input that requires grad is refused.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (accounted, launch, meta_launch,
                                       refuse_dtensor, route)
from repro_torch.kernels.rwkv6.ref import wkv_ref

HEAD_DIMS = (32, 64)
_DTYPES = (torch.float32, torch.bfloat16)

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]


def _check(r, k, v, w, u, s0) -> None:
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        refuse_dtensor(name, t)
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad, but wkv has no "
                             f"backward")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share a dtype, float32 or bfloat16; "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("w", w), ("u", u), ("s0", s0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, hd), got {tuple(r.shape)}")
    b, t, h, hd = r.shape
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or u.shape != (h, hd) or s0.shape != (b, h, hd, hd)):
        raise ValueError(
            f"shapes disagree: r/k/v/w {tuple(r.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}, {tuple(w.shape)}; u {tuple(u.shape)}; "
            f"s0 {tuple(s0.shape)}")
    if hd not in HEAD_DIMS or 0 in (b, t, h):
        raise ValueError(f"need hd in {HEAD_DIMS} and non-empty inputs, "
                         f"got r {tuple(r.shape)}")


def work(r, k, v, w, u, s0) -> tuple:
    """(flops, bytes) of one call.  Bytes: r, k, v, w, u and s0 read and y
    and sT written once.  Operations: the function's least, not the 7 of
    the order the kernel rounds in.  y_j = sum_i r_i S_ij + v_j sum_i r_i
    u_i k_i is 2 per state element a step (a multiply and an add) plus 5
    per column (3 for the row sum, 2 to fold it in); S'_ij = w_i S_ij +
    k_i v_j is 3 per element."""
    b, t, h, hd = r.shape
    nbytes = (4 * r.numel() * r.element_size() + 4 * w.numel()
              + 4 * u.numel() + 8 * s0.numel())
    return b * t * h * (5 * hd * hd + 5 * hd), nbytes


def wkv(r, k, v, w, u, s0):
    """The WKV-6 recurrence: r/k/v (B, T, H, hd) f32 or bf16, w (B, T, H,
    hd) f32 decay, u (H, hd) f32 bonus, s0 (B, H, hd, hd) f32 state; hd in
    {32, 64}; all contiguous on one device.  Returns (y (B, T, H, hd) in
    r's dtype, sT (B, H, hd, hd) f32)."""
    _check(r, k, v, w, u, s0)
    where = route(r.device, "wkv")
    with accounted("rwkv6", work(r, k, v, w, u, s0)):
        if where == "cpu":
            return wkv_ref(r, k, v, w, u, s0)
        b, t, h, hd = r.shape
        y = torch.empty_like(r)
        sT = torch.empty_like(s0)
        if where == "meta":
            meta_launch(wkv)
            return y, sT
        launch(wkv, "rwkv6", "repro_wkv", _ARGTYPES, r.device,
               r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
               u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(), b,
               t, h, hd, int(r.dtype == torch.bfloat16))
    return y, sT


wkv.launches = 0
wkv.meta_launches = 0

__all__ = ["HEAD_DIMS", "wkv", "work"]
