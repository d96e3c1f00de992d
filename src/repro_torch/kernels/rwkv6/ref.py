"""Plain PyTorch version of the RWKV-6 WKV kernel (K5): the recurrence of
``repro.kernels.rwkv6.ref.wkv_ref`` as a Python loop over time.

Every product and sum is its own elementwise operation, each rounded once,
and ``y`` is summed over the key index from 0 up: the kernel does the same
operations in the same order, so on the card the two agree bit for bit.
"""
from __future__ import annotations

import torch


def wkv_ref(r, k, v, w, u, s0):
    """r/k/v/w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd) ->
    (y (B, T, H, hd) in r's dtype, sT (B, H, hd, hd) f32)."""
    s = s0.float()
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = (z[:, t].float() for z in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]
        att = s + uf * kv
        y = torch.zeros_like(v_t)
        for i in range(att.shape[2]):
            y = y + r_t[..., i, None] * att[..., i, :]
        ys.append(y)
        s = w_t[..., :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s
