"""Plain PyTorch version of the Mamba selective-scan kernel (K4): the
recurrence of ``repro.kernels.mamba.ref.mamba_scan_ref`` as a Python loop
over time.

Every product and sum is its own elementwise operation, each rounded once,
in the kernel's order: ``da = exp(dt_t a)``, ``h = da h + (dt_t x_t) b_t``,
and ``y = sum_s h_s c_s`` added from s = 0 up.  So on the card the kernel
and this version can agree bit for bit.
"""
from __future__ import annotations

import torch


def mamba_scan_ref(dt, x, b_t, c_t, a, h0):
    """dt, x: (B, T, DI); b_t, c_t: (B, T, ds); a: (DI, ds) f32, already
    negative (``-exp(A_log)``); h0: (B, DI, ds) f32 -> (y (B, T, DI) f32,
    hT (B, DI, ds) f32).  The D-skip is the caller's."""
    h = h0.float()
    af = a.float()[None]
    ys = []
    for t in range(dt.shape[1]):
        dt_t, x_t, b_tt, c_tt = (z[:, t].float() for z in (dt, x, b_t, c_t))
        da = torch.exp(dt_t[:, :, None] * af)
        h = da * h + (dt_t * x_t)[:, :, None] * b_tt[:, None, :]
        y = torch.zeros_like(dt_t)
        for s in range(h.shape[2]):
            y = y + h[:, :, s] * c_tt[:, s, None]
        ys.append(y)
    return torch.stack(ys, dim=1), h
