"""Selective SSM (Mamba-1) block for the Jamba hybrid architecture.

The port of ``repro.models.mamba``, with the same parameter tree.  The
selective scan runs in the Mamba kernel (K4), one launch per call over the
whole sequence (prefill) or one token (decode), with the state carried
inside the kernel.  K4 has no backward (nor has the JAX package's kernel),
so a training pass (``differentiable``) runs :func:`_scan_chunk`, the port
of the JAX package's differentiable scan, a step loop of torch ops over
chunks of ``SCAN_CHUNK`` steps, each recomputed in the backward pass.  The
projections, the depthwise causal conv (whose last ``d_conv - 1`` inputs
are the decode state), the D-skip and the SiLU gate are torch ops, as they
are jnp ops there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.mamba.ops import mamba_scan
from repro_torch.models.layers import chunked_scan
from repro_torch.sharding.spec import (Param, init_device, on_local_shards,
                                       param, shard_act)

SCAN_CHUNK = 256


def _dims(cfg):
    d_inner = cfg.mamba.expand * cfg.d_model
    dt_rank = cfg.mamba.dt_rank or max(cfg.d_model // 16, 1)
    return d_inner, dt_rank, cfg.mamba.d_state, cfg.mamba.d_conv


def init_mamba(generator, cfg):
    d_inner, dt_rank, d_state, d_conv = _dims(cfg)
    dev = init_device(generator)
    # S4D-real initialisation for A
    a = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(d_inner, 1)
    return {
        "in_x": param(generator, (cfg.d_model, d_inner), ("embed", "mamba")),
        "in_z": param(generator, (cfg.d_model, d_inner), ("embed", "mamba")),
        "conv_w": param(generator, (d_conv, d_inner), (None, "mamba"),
                        scale=1.0 / math.sqrt(d_conv)),
        "conv_b": Param(torch.zeros(d_inner, device=dev), ("mamba",)),
        "x_proj": param(generator, (d_inner, dt_rank + 2 * d_state),
                        ("mamba", None)),
        "dt_w": param(generator, (dt_rank, d_inner), (None, "mamba"),
                      scale=dt_rank ** -0.5),
        "dt_b": Param(torch.full((d_inner,), -4.6, device=dev),
                      ("mamba",)),                       # softplus ~ 0.01
        "A_log": Param(torch.log(a), ("mamba", None)),
        "D": Param(torch.ones(d_inner, device=dev), ("mamba",)),
        "out": param(generator, (d_inner, cfg.d_model), ("mamba", "embed"),
                     scale=1.0 / math.sqrt(d_inner)),
    }


def _ssm_inputs(p, cfg, xh):
    """xh: (B, T, d_inner) post-conv -> (dt, B_t, C_t), all f32."""
    _, dt_rank, d_state, _ = _dims(cfg)
    proj = xh @ p["x_proj"].to(xh.dtype)
    dt_low, b_t, c_t = torch.split(proj, [dt_rank, d_state, d_state], -1)
    dt = F.softplus((dt_low @ p["dt_w"].to(xh.dtype)).float() + p["dt_b"])
    return dt, b_t.float(), c_t.float()


def _scan_chunk(a_log, dt, b_t, c_t, xh, h0):
    """Sequential selective scan over one chunk, in torch ops that autograd
    differentiates (the JAX package's ``_scan_chunk``).

    dt: (B,T,di) f32; b_t/c_t: (B,T,ds) f32; xh: (B,T,di); h0: (B,di,ds)
    f32.  Returns (y (B,T,di) f32, hT)."""
    a = -torch.exp(a_log)                                 # (di, ds)
    h, ys = h0, []
    for dt_t, b_tt, c_tt, x_tt in zip(*(z.unbind(1) for z in (
            dt, b_t, c_t, xh.float()))):
        da = torch.exp(dt_t[:, :, None] * a[None])        # (B, di, ds)
        dbx = (dt_t * x_tt)[:, :, None] * b_tt[:, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bds,bs->bd", h, c_tt))
    return torch.stack(ys, dim=1), h


def mamba_forward(p, cfg, x, *, state=None, differentiable=False):
    """Full-sequence forward (and, at S = 1, a decode step).  x: (B, S, D).
    ``differentiable``: the scan in torch ops (:func:`_scan_chunk` over
    ``SCAN_CHUNK``-step chunks), for training; else K4, which refuses
    inputs that require grad.

    Returns (y, final_state) where state = (ssm_h, conv_tail):
      ssm_h (B, d_inner, d_state) f32, conv_tail (B, d_conv-1, d_inner)."""
    d_inner, _, d_state, d_conv = _dims(cfg)
    b, s, _ = x.shape
    xz = shard_act(x @ p["in_x"].to(x.dtype), "batch", "seq", "mamba")
    z = shard_act(x @ p["in_z"].to(x.dtype), "batch", "seq", "mamba")

    # depthwise causal conv over seq
    tail = (state[1].to(xz.dtype) if state is not None
            else torch.zeros((b, d_conv - 1, d_inner), dtype=xz.dtype,
                             device=x.device))
    xp = torch.cat([tail, xz], dim=1)
    conv_w = p["conv_w"].to(xz.dtype)
    xh = sum(xp[:, i:i + s, :] * conv_w[i] for i in range(d_conv))
    xh = F.silu(xh + p["conv_b"].to(xz.dtype))

    dt, b_t, c_t = _ssm_inputs(p, cfg, xh)
    h0 = (state[0] if state is not None
          else torch.zeros((b, d_inner, d_state), dtype=torch.float32,
                           device=x.device))
    # under a mesh, each rank's batch and mamba (inner) shard alone: K4
    # takes plain tensors, and the torch-op scan's steps run as local ops
    # rather than DTensor ops
    seq, bd = {"batch": 0, "inner": 2}, {"batch": 0}
    hh = {"batch": 0, "inner": 1}
    if differentiable:
        y, hT = on_local_shards(
            lambda a_log, *z: chunked_scan(_scan_chunk, a_log, z[:4], z[4],
                                           SCAN_CHUNK),
            dt, {0: "batch", 2: "inner"},
            [(p["A_log"], {"inner": 0}), (dt, seq), (b_t, bd), (c_t, bd),
             (xh, seq), (h0, hh)], (seq, hh))
    else:
        # (d_inner, ds), rounded in A_log's dtype as the JAX package's
        # ``-exp(a_log)`` is, then f32 as K4 takes it
        a = (-torch.exp(p["A_log"])).float()
        y, hT = on_local_shards(
            mamba_scan, dt, {0: "batch", 2: "inner"},
            [(dt, seq), (xh.float(), seq), (b_t, bd), (c_t, bd),
             (a, {"inner": 0}), (h0, hh)], (seq, hh))

    y = (y + xh.float() * p["D"]).to(x.dtype)
    y = shard_act(y * F.silu(z), "batch", "seq", "mamba")
    out = y @ p["out"].to(x.dtype)
    return shard_act(out, "batch", "seq", None), (hT, xp[:, s:, :])


def mamba_decode_step(p, cfg, x, state):
    """Single-token decode.  x: (B, 1, D); state as in mamba_forward."""
    return mamba_forward(p, cfg, x, state=state)


def mamba_init_state(cfg, batch: int, dtype=torch.bfloat16, device="cuda"):
    d_inner, _, d_state, d_conv = _dims(cfg)
    dev = resolve_device(device)
    return (torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                        device=dev),
            torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                        device=dev))
