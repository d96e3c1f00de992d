"""Plain PyTorch version of the flash attention kernel (K3).

It is ``repro.kernels.flash_attention.ref.attention_ref`` in PyTorch, with
one difference the kernel shares: a query row that sees no key (possible
only with a window, or with more queries than keys) comes out 0, where the
JAX oracle averages every value uniformly.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd) in q's
    dtype.  Both positions count from 0."""
    _, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqe,bhke->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    w = torch.where(mask.any(-1, keepdim=True), w, 0.0)
    return torch.einsum("bhqk,bhke->bhqe", w, v.float()).to(q.dtype)
