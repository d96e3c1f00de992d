"""Jamba-style hybrid assembly: Mamba+attention 1:7 interleave, MoE every
other layer.

The port of ``repro.models.hybrid``, with the same parameter tree: the
layer stack is cut into *periods* of ``attn_layer_period`` sublayers, the
periods are stacked on a leading axis, and within a period the Mamba
mixers, the dense FFNs and the MoE FFNs are stacked again.  The forward
pass loops over the periods in Python where the JAX package scans.

Training (``forward_train(differentiable=True)``) takes the torch-op
attention and the torch-op selective scan, since K3 and K4 have no
backward, and under ``remat`` recomputes each period in the backward pass.

The cache holds, per period, the attention layer's KV ring (``k``, ``v``,
``pos``; decode writes it in place) and every Mamba layer's SSM state and
conv tail (``ssm``, ``conv``; decode hands back new tensors).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.mamba import _dims as mamba_dims
from repro_torch.models.mamba import init_mamba, mamba_forward
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.transformer import layer, stack_layers
from repro_torch.sharding.spec import Param, init_device


def _period_layout(cfg):
    p = cfg.attn_layer_period
    attn_pos = cfg.attn_layer_offset
    moe_every = cfg.moe_layer_period
    layout = []
    for i in range(p):
        mixer = "attn" if i == attn_pos else "mamba"
        ffn = ("moe" if (cfg.is_moe and i % moe_every == moe_every - 1)
               else "dense")
        layout.append((mixer, ffn))
    return layout


def _counts(cfg):
    """(periods, Mamba layers a period)."""
    layout = _period_layout(cfg)
    if cfg.num_layers % len(layout):
        raise ValueError(f"{cfg.num_layers} layers are not whole periods "
                         f"of {len(layout)}")
    return (cfg.num_layers // len(layout),
            sum(m == "mamba" for m, _ in layout))


def init_model(generator, cfg):
    """-> Param tree of the hybrid decoder on ``generator``'s device (the
    meta device for ``None``)."""
    layout = _period_layout(cfg)
    p_len = len(layout)
    n_periods, n_mamba = _counts(cfg)
    n_dense = sum(f == "dense" for _, f in layout)
    n_moe = sum(f == "moe" for _, f in layout)
    dev = init_device(generator)

    def norms():
        return {"scale": Param(torch.ones((p_len, cfg.d_model), device=dev),
                               ("layers", None))}

    def init_period():
        pp = {
            "norm1": norms(),
            "norm2": norms(),
            "attn": L.init_attention(generator, cfg),
            "mamba": stack_layers(lambda: init_mamba(generator, cfg),
                                  n_mamba),
            "dense": stack_layers(lambda: L.init_mlp(generator, cfg),
                                  n_dense),
        }
        if n_moe:
            pp["moe"] = stack_layers(lambda: init_moe(generator, cfg), n_moe)
        return pp

    return {
        "embed": L.init_embedding(generator, cfg),
        "periods": stack_layers(init_period, n_periods),
        "final_norm": L.init_norm(cfg, generator=generator),
        "head": L.init_lm_head(generator, cfg),
    }


def _apply_period(pp, cfg, x, *, positions, mode, attn_cache=None,
                  mamba_state=None, cache_index=None, window=0,
                  differentiable=False):
    """One period.  mode: train | prefill | decode.  ``differentiable``:
    attention and the scan in torch ops, for training.

    Returns (x, aux, new_attn_cache, (ssm, conv) stacked over the period's
    Mamba layers)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mi = di = mo = 0
    new_attn_cache = None
    new_states = []
    for i, (mixer, ffn) in enumerate(_period_layout(cfg)):
        xn = L.apply_norm({"scale": pp["norm1"]["scale"][i]}, cfg, x)
        if mixer == "attn":
            if mode == "decode":
                h, new_attn_cache = L.attention(
                    pp["attn"], cfg, xn, positions=positions, window=window,
                    cache=attn_cache, cache_index=cache_index)
            else:
                h, new_attn_cache = L.attention(
                    pp["attn"], cfg, xn, positions=positions, window=window,
                    differentiable=differentiable)
        else:
            st = ((mamba_state[0][mi], mamba_state[1][mi])
                  if mamba_state is not None else None)
            h, new_st = mamba_forward(layer(pp["mamba"], mi), cfg, xn,
                                      state=st,
                                      differentiable=differentiable)
            new_states.append(new_st)
            mi += 1
        x = x + h
        xn = L.apply_norm({"scale": pp["norm2"]["scale"][i]}, cfg, x)
        if ffn == "moe":
            cf = (max(2.0, cfg.moe.capacity_factor) if mode == "decode"
                  else None)
            h, a = apply_moe(layer(pp["moe"], mo), cfg, xn,
                             capacity_factor=cf)
            aux = aux + a
            mo += 1
        else:
            h = L.apply_mlp(layer(pp["dense"], di), cfg, xn)
            di += 1
        x = x + h
    states = (torch.stack([s for s, _ in new_states]),
              torch.stack([c for _, c in new_states]))
    return x, aux, new_attn_cache, states


def forward_train(params, cfg, tokens, *, dtype=torch.bfloat16, window=None,
                  remat=True, compute_logits=True, differentiable=False):
    """Full sequence from zero states: (logits, aux_loss (the MoE layers'
    sum), features).  ``differentiable``: attention and the scan in torch
    ops, for training (K3 and K4 refuse inputs that require grad).
    ``remat``: while autograd records, each period runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass, as
    the JAX package's ``jax.checkpoint(body)``."""
    window = cfg.sliding_window if window is None else window
    x = L.embed_tokens(params["embed"], cfg, tokens, dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def body(pp, x):
        return _apply_period(pp, cfg, x, positions=positions, mode="train",
                             window=window,
                             differentiable=differentiable)[:2]

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in range(_counts(cfg)[0]):
        x, a = L.checkpointed(body, layer(params["periods"], p), x,
                              enabled=remat)
        aux = aux + a
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = (L.lm_logits(params["head"], params["embed"], cfg, x)
              if compute_logits else None)
    return logits, aux, x


def init_cache(cfg, batch: int, cache_len: int, *, window=None,
               dtype=torch.bfloat16, device="cuda", full=L.full_whole):
    """Hybrid cache: attention ring buffers + mamba states, per period,
    each leaf made by ``full`` (``transformer.init_cache``)."""
    window = cfg.sliding_window if window is None else window
    dev = resolve_device(device)
    n_periods, n_mamba = _counts(cfg)
    size = min(window, cache_len) if window else cache_len
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    d_inner, _, d_state, d_conv = mamba_dims(cfg)
    kv_shape = (n_periods, batch, size, kv, hd)
    return {
        "k": full("k", kv_shape, 0, dtype, dev),
        "v": full("v", kv_shape, 0, dtype, dev),
        "pos": full("pos", (n_periods, size), -1, torch.int32, dev),
        "ssm": full("ssm", (n_periods, n_mamba, batch, d_inner, d_state), 0,
                    torch.float32, dev),
        "conv": full("conv", (n_periods, n_mamba, batch, d_conv - 1,
                              d_inner), 0, dtype, dev),
    }


def prefill(params, cfg, tokens, *, dtype=torch.bfloat16, window=None,
            cache_len: int | None = None, full=L.full_whole):
    """Full-sequence forward that also builds the cache, each leaf made by
    ``full`` (:func:`init_cache`).  Returns (last_logits (B,1,V),
    cache)."""
    window = cfg.sliding_window if window is None else window
    x = L.embed_tokens(params["embed"], cfg, tokens, dtype)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, cache_len or s, window=window, dtype=dtype,
                       device=x.device, full=full)
    size = cache["pos"].shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    keep, slots = L.prefill_slots(positions, size)
    for p in range(_counts(cfg)[0]):
        x, _, (k, v), (ssm, conv) = _apply_period(
            layer(params["periods"], p), cfg, x, positions=positions,
            mode="prefill", window=window)
        L.write_rows(cache["k"][p], 1, slots, k[:, s - len(keep):])
        L.write_rows(cache["v"][p], 1, slots, v[:, s - len(keep):])
        L.write_rows(cache["pos"][p], 0, slots, keep)
        L.write_rows(cache["ssm"], 0, p, ssm[None])
        L.write_rows(cache["conv"], 0, p, conv[None])
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = L.lm_logits(params["head"], params["embed"], cfg, x[:, -1:])
    return logits, cache


def decode_step(params, cfg, cache, token, index, *, dtype=torch.bfloat16,
                window=None):
    """token: (B, 1) int; index: the token's absolute position, a host int
    or a 0-d int32 tensor on the params' device (``layers.decode_index``),
    read by the attention layers with tensor ops alone.

    Returns (logits (B,1,V), cache): the KV ring is updated in place, the
    SSM states and conv tails are new tensors (the ones read stay as they
    were; ``launch.serve.DecodeGraph`` copies them back)."""
    window = cfg.sliding_window if window is None else window
    x = L.embed_tokens(params["embed"], cfg, token, dtype)
    index = L.decode_index(index, cache["k"])
    ssm, conv = [], []
    for p in range(_counts(cfg)[0]):
        x, _, _, (s_p, c_p) = _apply_period(
            layer(params["periods"], p), cfg, x, positions=None,
            mode="decode", window=window,
            attn_cache=(cache["k"][p], cache["v"][p], cache["pos"][p]),
            cache_index=index,
            mamba_state=(cache["ssm"][p], cache["conv"][p]))
        ssm.append(s_p)
        conv.append(c_p.to(cache["conv"].dtype))
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = L.lm_logits(params["head"], params["embed"], cfg, x)
    return logits, dict(cache, ssm=torch.stack(ssm), conv=torch.stack(conv))
