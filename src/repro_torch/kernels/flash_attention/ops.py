"""Public wrapper of the flash attention kernel (K3).

:func:`flash_attention` takes the model's (B, S, H, hd) layout, checks its
tensors, then dispatches by their device: CUDA tensors launch ``kernel.cu``
on the current stream (or raise), CPU tensors run the plain version in
``ref.py``, meta tensors get an empty output (the dry-run's route).  Only
a launch adds one to ``flash_attention.launches``, and only the meta route
to ``flash_attention.meta_launches``; :func:`work` is the kernel's useful
work, reported on every route to an open accounting mode.  The
kernel has no backward (nor has the JAX package's), so an input that
requires grad is refused.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels.build import (accounted, launch, meta_launch,
                                       refuse_dtensor, route)
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float]


def _check(q, k, v, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        refuse_dtensor(name, t)
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, hd), got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad, but flash_attention "
                             f"has no backward")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or hkv == 0 or hq % hkv):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS or 0 in (b, sq, skv):
        raise ValueError(f"need hd in {HEAD_DIMS} and non-empty inputs, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask leaves visible, positions aligned
    top-left as the kernel's: query i sees keys 0..min(i, Skv - 1) when
    ``causal`` (else all), and with ``window`` > 0 only those past
    i - window."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq,
                                                                  np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(q, k, v, *, causal: bool = True, window: int = 0) -> tuple:
    """(flops, bytes) of one call.  Bytes: q, k, v read and out written
    once.  Operations: the two products (2 flops a multiply-add each) over
    the pairs the mask leaves visible, whatever route computes them."""
    b, sq, hq, hd = q.shape
    pairs = visible_pairs(sq, k.shape[1], causal, window)
    return (4 * b * hq * hd * pairs,
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size())


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd) in q's
    dtype; f32 or bf16, hd in {32, 64, 128}, Hq a multiple of Hkv, all
    contiguous on one device.  Query and key positions both count from 0;
    ``window`` > 0 keeps keys with ``kpos > qpos - window``.  A row that
    sees no key is 0."""
    _check(q, k, v, window)
    where = route(q.device, "flash-attention")
    with accounted("flash_attention", work(q, k, v, causal=causal,
                                           window=window)):
        if where == "cpu":    # contiguous, as the kernel writes it
            return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window).transpose(1, 2).contiguous()
        b, sq, hq, hd = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        if where == "meta":
            meta_launch(flash_attention)
            return out
        launch(flash_attention, "flash_attention", "repro_flash_attention",
               _ARGTYPES, q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), b, sq, skv, hq, hkv, hd,
               int(q.dtype == torch.bfloat16), int(bool(causal)),
               int(window), 1.0 / math.sqrt(hd))
    return out


flash_attention.launches = 0
flash_attention.meta_launches = 0

__all__ = ["HEAD_DIMS", "flash_attention", "visible_pairs", "work"]
