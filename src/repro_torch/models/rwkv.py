"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.

The port of ``repro.models.rwkv``.  The hallmark of RWKV-6 over v5 is the
*data-dependent* per-channel decay ``w_t = exp(-exp(w0 + lora_w(x_t)))``.
State per head is an (hd, hd) key-value outer-product matrix:

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

The recurrence runs in the WKV kernel (K5), one launch per layer over the
whole sequence (prefill) or one token (decode).  K5 has no backward (nor
has the JAX package's kernel), so a training pass (``differentiable``) runs
:func:`_wkv_chunk`, the port of the JAX package's differentiable scan, a
step loop of torch ops over chunks of ``SCAN_CHUNK`` steps, each recomputed
in the backward pass.  Layer parameters keep the JAX package's stacked
layout; the layers are a Python loop.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.rwkv6.ops import wkv
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer, stack_layers
from repro_torch.sharding.spec import (Param, init_device, on_local_shards,
                                       param, shard_act)

SCAN_CHUNK = 256
DECAY_LORA = 64


def _dims(cfg):
    hd = cfg.rwkv.head_size
    return cfg.d_model // hd, hd


def init_time_mix(generator, cfg):
    h, hd = _dims(cfg)
    d = cfg.d_model
    dev = init_device(generator)

    def half():
        return Param(torch.full((d,), 0.5, device=dev), (None,))

    # per-channel decay base: spread across channels (RWKV init)
    w0 = -5.0 + 8.0 * (torch.arange(d, dtype=torch.float32, device=dev)
                       / max(d - 1, 1)) ** 3.0
    return {
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_g": half(),
        "mu_w": half(),
        "w_r": param(generator, (d, d), ("embed", "rwkv_head")),
        "w_k": param(generator, (d, d), ("embed", "rwkv_head")),
        "w_v": param(generator, (d, d), ("embed", "rwkv_head")),
        "w_g": param(generator, (d, d), ("embed", "rwkv_head")),
        "w_o": param(generator, (d, d), ("rwkv_head", "embed"),
                     scale=1.0 / math.sqrt(d)),
        # data-dependent decay LoRA (the Finch mechanism)
        "w0": Param(w0, (None,)),
        "w_lora_a": param(generator, (d, DECAY_LORA), ("embed", None),
                          scale=0.01),
        "w_lora_b": param(generator, (DECAY_LORA, d), (None, "rwkv_head"),
                          scale=0.01),
        "u": param(generator, (h, hd), ("rwkv_head", None), scale=0.1),
        "ln_scale": Param(torch.ones(d, device=dev), (None,)),
        "ln_bias": Param(torch.zeros(d, device=dev), (None,)),
    }


def init_channel_mix(generator, cfg):
    d = cfg.d_model
    dev = init_device(generator)
    return {
        "mu_k": Param(torch.full((d,), 0.5, device=dev), (None,)),
        "mu_r": Param(torch.full((d,), 0.5, device=dev), (None,)),
        "w_k": param(generator, (d, cfg.d_ff), ("embed", "mlp")),
        "w_v": param(generator, (cfg.d_ff, d), ("mlp", "embed"),
                     scale=1.0 / math.sqrt(cfg.d_ff)),
        "w_r": param(generator, (d, d), ("embed", None)),
    }


def _shift(x, prev):
    """Token shift: x_{t-1} with ``prev`` (B, D) as the t=0 predecessor."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _group_norm(y, scale, bias, heads: int, eps: float = 1e-5):
    """Per-head group norm on (B, T, D)."""
    b, t, d = y.shape
    yf = y.reshape(b, t, heads, d // heads).float()
    mu = yf.mean(-1, keepdim=True)
    var = (yf - mu).square().mean(-1, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + eps)
    return (yf.reshape(b, t, d) * scale + bias).to(y.dtype)


def _wkv_chunk(u, r, k, v, w, s0):
    """Sequential WKV over one chunk, in torch ops that autograd
    differentiates (the JAX package's ``_wkv_chunk``).

    r/k/v: (B,T,H,hd); w: (B,T,H,hd) decay in (0,1); s0: (B,H,hd,hd) f32.
    Returns (y (B,T,H,hd) f32, sT)."""
    s, ys = s0, []
    for r_t, k_t, v_t, w_t in zip(*(z.float().unbind(1)
                                    for z in (r, k, v, w))):  # (B,H,hd)
        kv = k_t[..., :, None] * v_t[..., None, :]            # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t,
                               s + u[None, :, :, None] * kv))
        s = w_t[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def time_mix_forward(p, cfg, x, *, state=None, differentiable=False):
    """x: (B, S, D) -> (y, (wkv_state, shift_prev)).  ``differentiable``:
    the WKV in torch ops (:func:`_wkv_chunk` over ``SCAN_CHUNK``-step
    chunks), for training; else K5, which refuses inputs that require
    grad."""
    h, hd = _dims(cfg)
    b, s, d = x.shape
    prev = (state[1].to(x.dtype) if state is not None
            else torch.zeros((b, d), dtype=x.dtype, device=x.device))
    xs = _shift(x, prev)
    xr = _mix(x, xs, p["mu_r"])
    xk = _mix(x, xs, p["mu_k"])
    xv = _mix(x, xs, p["mu_v"])
    xg = _mix(x, xs, p["mu_g"])
    xw = _mix(x, xs, p["mu_w"])

    r = xr @ p["w_r"].to(x.dtype)
    k = xk @ p["w_k"].to(x.dtype)
    v = xv @ p["w_v"].to(x.dtype)
    g = F.silu(xg @ p["w_g"].to(x.dtype))
    # data-dependent decay (Finch): w_t = exp(-exp(w0 + lora(x_w))), in
    # f32 whatever the parameters' dtype (jnp promotes the bf16 LoRA
    # weights and w0 against the f32 tanh; torch's product does not)
    lora = torch.tanh(xw.float()) @ p["w_lora_a"].float()
    w = torch.exp(-torch.exp(p["w0"].float()
                             + lora @ p["w_lora_b"].float()))  # (B,S,D) f32

    def heads_(z):
        return shard_act(z.reshape(b, s, h, hd).contiguous(), "batch",
                         "seq", "rwkv_head", None)

    s0 = (state[0] if state is not None
          else torch.zeros((b, h, hd, hd), dtype=torch.float32,
                           device=x.device))
    # under a mesh, each rank's batch and rwkv_head shard alone: K5 takes
    # plain tensors, and the torch-op scan's steps run as local ops
    # rather than DTensor ops
    bh, hh = {"batch": 0, "head": 2}, {"batch": 0, "head": 1}
    rh = heads_(r)
    seqs = [(rh, bh), (heads_(k), bh), (heads_(v), bh), (heads_(w), bh)]
    if differentiable:
        y, sT = on_local_shards(
            lambda u, *z: L.chunked_scan(_wkv_chunk, u, z[:4], z[4],
                                         SCAN_CHUNK),
            rh, {0: "batch", 2: "head"},
            [(p["u"], {"head": 0}), *seqs, (s0, hh)], (bh, hh))
    else:
        y, sT = on_local_shards(
            wkv, rh, {0: "batch", 2: "head"},
            [*seqs, (p["u"].float(), {"head": 0}), (s0, hh)], (bh, hh))
    y = y.reshape(b, s, d).to(x.dtype)
    y = _group_norm(y, p["ln_scale"], p["ln_bias"], h) * g
    out = y @ p["w_o"].to(x.dtype)
    return shard_act(out, "batch", "seq", None), (sT, x[:, -1, :])


def channel_mix_forward(p, cfg, x, *, state=None):
    """x: (B, S, D) -> (y, shift_prev)."""
    b, s, d = x.shape
    prev = (state.to(x.dtype) if state is not None
            else torch.zeros((b, d), dtype=x.dtype, device=x.device))
    xs = _shift(x, prev)
    xk = _mix(x, xs, p["mu_k"])
    xr = _mix(x, xs, p["mu_r"])
    k = F.relu(xk @ p["w_k"].to(x.dtype)).square()
    k = shard_act(k, "batch", "seq", "mlp")
    kv = k @ p["w_v"].to(x.dtype)
    r = torch.sigmoid(xr @ p["w_r"].to(x.dtype))
    return shard_act(r * kv, "batch", "seq", None), x[:, -1, :]


def rwkv_init_state(cfg, batch: int, dtype=torch.bfloat16, device="cuda"):
    h, hd = _dims(cfg)
    device = resolve_device(device)
    return {
        "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                           device=device),
        "shift_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
        "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
    }


# ---------------------------------------------------------------------------
# Full-model assembly (attention-free decoder)
# ---------------------------------------------------------------------------


def init_block(generator, cfg):
    dev = init_device(generator)

    def ln():
        return {"scale": Param(torch.ones(cfg.d_model, device=dev), (None,)),
                "bias": Param(torch.zeros(cfg.d_model, device=dev), (None,))}

    return {"ln1": ln(), "ln2": ln(), "tm": init_time_mix(generator, cfg),
            "cm": init_channel_mix(generator, cfg)}


def init_model(generator, cfg):
    return {
        "embed": L.init_embedding(generator, cfg),
        "embed_norm": L.init_norm(cfg, generator=generator),
        "blocks": stack_layers(lambda: init_block(generator, cfg),
                               cfg.num_layers),
        "final_norm": L.init_norm(cfg, generator=generator),
        "head": L.init_lm_head(generator, cfg),
    }


def _apply_block(bp, cfg, x, *, state=None, differentiable=False):
    tm_state = (state["wkv"], state["shift_tm"]) if state is not None else None
    h, (wkv_state, shift_tm) = time_mix_forward(
        bp["tm"], cfg, L.apply_norm(bp["ln1"], cfg, x), state=tm_state,
        differentiable=differentiable)
    x = x + h
    cm_state = state["shift_cm"] if state is not None else None
    h, shift_cm = channel_mix_forward(
        bp["cm"], cfg, L.apply_norm(bp["ln2"], cfg, x), state=cm_state)
    x = x + h
    return x, {"wkv": wkv_state, "shift_tm": shift_tm.to(x.dtype),
               "shift_cm": shift_cm.to(x.dtype)}


def _embed(params, cfg, tokens, dtype):
    x = L.embed_tokens(params["embed"], cfg, tokens, dtype)
    return L.apply_norm(params["embed_norm"], cfg, x)


def _run(params, cfg, x, states):
    """Every block in turn, each from its state (or zeros for ``None``);
    returns (x, the blocks' new states stacked per key)."""
    out = []
    for i in range(cfg.num_layers):
        x, st = _apply_block(layer(params["blocks"], i), cfg, x,
                             state=states(i))
        out.append(st)
    return x, {key: torch.stack([st[key] for st in out]) for key in out[0]}


def forward_train(params, cfg, tokens, *, dtype=torch.bfloat16, window=None,
                  remat=True, compute_logits=True, differentiable=False):
    """Full sequence from zero states: (logits, aux_loss 0, features).
    ``differentiable``: the WKV in torch ops, for training (K5 refuses
    inputs that require grad).  ``remat``: while autograd records, each
    block runs under ``torch.utils.checkpoint`` and is recomputed in the
    backward pass, as the JAX package's ``jax.checkpoint(body)``.  The
    blocks' final states are dropped as each block ends."""
    def body(bp, x):
        return _apply_block(bp, cfg, x, differentiable=differentiable)[0]

    x = _embed(params, cfg, tokens, dtype)
    for i in range(cfg.num_layers):
        x = L.checkpointed(body, layer(params["blocks"], i), x,
                           enabled=remat)
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = (L.lm_logits(params["head"], params["embed"], cfg, x)
              if compute_logits else None)
    return logits, torch.zeros((), device=x.device), x


def init_cache(cfg, batch: int, cache_len: int = 0, *, window=None,
               dtype=torch.bfloat16, device="cuda"):
    """RWKV's 'cache' is the recurrent state (O(1) in sequence length)."""
    state = rwkv_init_state(cfg, batch, dtype, device)
    return {key: torch.stack([v] * cfg.num_layers)
            for key, v in state.items()}


def prefill(params, cfg, tokens, *, dtype=torch.bfloat16, window=None,
            cache_len=None, full=None):
    """Full-sequence forward: (last_logits (B,1,V), the blocks' final
    states).  The state is the scan's output, placed as the scan placed
    it under a mesh; ``full`` (the other families' cache maker) is
    unused."""
    x = _embed(params, cfg, tokens, dtype)
    x, cache = _run(params, cfg, x, lambda i: None)
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = L.lm_logits(params["head"], params["embed"], cfg, x[:, -1:])
    return logits, cache


def decode_step(params, cfg, cache, token, index, *, dtype=torch.bfloat16,
                window=None):
    """token: (B, 1) int; index: the token's absolute position (a host int
    or a 0-d int32 tensor), unread: the recurrent state carries the
    position, as in the JAX package.

    Returns (logits (B,1,V), the blocks' new states): new tensors, the
    ones read stay as they were (``launch.serve.DecodeGraph`` copies them
    back)."""
    x = _embed(params, cfg, token, dtype)
    x, cache = _run(params, cfg, x,
                    lambda i: {key: v[i] for key, v in cache.items()})
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = L.lm_logits(params["head"], params["embed"], cfg, x)
    return logits, cache
