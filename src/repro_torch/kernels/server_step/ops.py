"""Public wrapper of the fused federated server-step kernel (K1).

:func:`server_step_update` checks its tensors, then dispatches by their
device: CUDA tensors launch ``kernel.cu`` on the current stream (or raise),
CPU tensors run the plain version in ``ref.py``, meta tensors get empty
outputs (the dry-run's route).  Only a launch adds one to
``server_step_update.launches``, and only the meta route to
``server_step_update.meta_launches``; :func:`work` is the kernel's useful
work, reported on every route to an open accounting mode.

The gradient stack may be pitched: its rows are contiguous and lie ``ld``
elements apart, ``ld >= n`` (``buf[:, :n]`` of an ``(M, ld)`` buffer, as
``FusedServerStep`` builds it), so that every row can start on a 16-byte
boundary whatever ``n`` is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (accounted, launch, meta_launch,
                                       refuse_dtensor, route)
from repro_torch.kernels.server_step.ref import server_step_ref

#: Members a call takes (kernel.cu instantiates 1..8 and loops beyond).
MAX_MEMBERS = 48 * 1024 // 4

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
             ctypes.c_float]


def _check(p, g_stack, acc, coeffs) -> int:
    """Raise on what the kernel does not take; return the stack's row
    pitch ``ld`` in elements."""
    named = (("p", p), ("g_stack", g_stack), ("acc", acc),
             ("coeffs", coeffs))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        refuse_dtensor(name, t)
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if name != "g_stack" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m = g_stack.shape[0] if g_stack.dim() else 0
    if not 1 <= m <= MAX_MEMBERS:
        raise ValueError(f"g_stack must stack 1..{MAX_MEMBERS} members, "
                         f"got shape {tuple(g_stack.shape)}")
    if (acc.shape != p.shape or g_stack.shape[1:] != p.shape
            or coeffs.shape != (m,)):
        raise ValueError(
            f"shapes disagree: p {tuple(p.shape)}, acc {tuple(acc.shape)}, "
            f"g_stack {tuple(g_stack.shape)}, coeffs {tuple(coeffs.shape)}")
    if not g_stack[0].is_contiguous():
        raise ValueError(f"each row of g_stack must be contiguous, got "
                         f"strides {g_stack.stride()}")
    n = p.numel()
    ld = g_stack.stride(0) if m > 1 else n
    if ld < n:
        raise ValueError(f"g_stack's rows lie {ld} elements apart, fewer "
                         f"than the {n} of a row")
    return ld


def work(p, g_stack, acc, coeffs) -> tuple:
    """(flops, bytes) of one call.  Bytes: p, acc and M gradient rows read
    and p' and acc' written once, and the M coefficients.  Operations:
    about 2M + 7 an element (kernel.cu's header)."""
    n, m = p.numel(), g_stack.shape[0]
    return (2 * m + 7) * n, (m + 4) * 4 * n + 4 * m


def server_step_update(p, g_stack, acc, coeffs, *, lr: float,
                       beta: float = 1.0, weight_decay: float = 0.0):
    """Fused clip×weight mean + modified-AdaGrad update.

    ``p``/``acc``: f32, any shape, contiguous; ``g_stack``: f32
    (M, *p.shape), each row contiguous, rows ``ld >= p.numel()`` elements
    apart; ``coeffs``: f32 (M,), contiguous — each member's clip scale ×
    normalised work weight, left on its device (the call never reads it
    back); all on one device.  Returns ``(p', acc')`` f32 in ``p``'s
    shape."""
    ld = _check(p, g_stack, acc, coeffs)
    where = route(p.device, "server-step")
    with accounted("server_step", work(p, g_stack, acc, coeffs)):
        if where == "cpu":
            return server_step_ref(p, g_stack, acc, coeffs, lr=lr,
                                   beta=beta, weight_decay=weight_decay)
        p_out, acc_out = torch.empty_like(p), torch.empty_like(acc)
        if not p.numel():
            return p_out, acc_out
        if where == "meta":
            meta_launch(server_step_update)
            return p_out, acc_out
        launch(server_step_update, "server_step",
               "repro_server_step_pitched", _ARGTYPES, p.device,
               p.data_ptr(), g_stack.data_ptr(), acc.data_ptr(),
               coeffs.data_ptr(), p_out.data_ptr(), acc_out.data_ptr(),
               p.numel(), ld, g_stack.shape[0], float(lr), float(beta),
               int(bool(weight_decay)), float(weight_decay))
    return p_out, acc_out


server_step_update.launches = 0
server_step_update.meta_launches = 0

__all__ = ["MAX_MEMBERS", "server_step_update", "work"]
