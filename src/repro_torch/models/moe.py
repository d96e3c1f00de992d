"""Mixture-of-Experts FFN: top-k token-choice routing with capacity-bounded
sort-based dispatch (no (tokens, E, C) one-hot blow-up).

The port of ``repro.models.moe``'s local dispatch (``_apply_moe_local``):
assignments (token, k) are ranked within their expert in stable arrival
order (a stable argsort and a searchsorted), scattered into an (E, C, D)
buffer, the expert products run batched over all E experts, and the
results are gathered back and combined with the normalised router weights.
Assignments beyond an expert's capacity are dropped (standard token-choice
behaviour).  The expert products are torch matrix products, as the JAX
package leaves them to XLA: no kernel of the repository computes them.

The JAX package's expert-parallel ``shard_map`` path
(``_apply_moe_sharded``) is not ported: it needs a mesh, and comes with the
sharding slice (ROADMAP.md, Queue 1 item 7).  On one device the JAX
package takes the local path too.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import mlp_act
from repro_torch.sharding.spec import param, shard_act


def init_moe(generator, cfg, d_ff: int | None = None):
    d_ff = d_ff or cfg.d_ff
    e = cfg.moe.num_experts
    p = {
        "router": param(generator, (cfg.d_model, e), ("embed", None),
                        scale=0.02),
        "w_up": param(generator, (e, cfg.d_model, d_ff),
                      ("expert", "embed", "mlp"),
                      scale=1.0 / math.sqrt(cfg.d_model)),
        "w_down": param(generator, (e, d_ff, cfg.d_model),
                        ("expert", "mlp", "embed"),
                        scale=1.0 / math.sqrt(d_ff)),
    }
    if cfg.act == "swiglu":
        p["w_gate"] = param(generator, (e, cfg.d_model, d_ff),
                            ("expert", "embed", "mlp"),
                            scale=1.0 / math.sqrt(cfg.d_model))
    return p


def router_topk(logits, k: int):
    """fp32 softmax over experts, take top-k, renormalise.
    -> (probs, weights, idx)."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, idx = torch.topk(probs, k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, weights, idx


def _positions_within_expert(e_flat, num_experts: int):
    """Rank of each assignment within its expert (stable arrival order)."""
    nk = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=e_flat.device,
                               dtype=sorted_e.dtype))
    pos_sorted = torch.arange(nk, device=e_flat.device) - seg_start[sorted_e]
    return torch.zeros(nk, dtype=torch.int32, device=e_flat.device).index_put(
        (order,), pos_sorted.to(torch.int32))


def expert_capacity(n: int, moe, capacity_factor: float | None = None) -> int:
    """Slots per expert for ``n`` tokens: ``ceil(n k / E * capf)``, at least
    2k, rounded up to a multiple of 8."""
    capf = capacity_factor or moe.capacity_factor
    cap = max(int(math.ceil(n * moe.num_experts_per_tok / moe.num_experts
                            * capf)), 2 * moe.num_experts_per_tok)
    return (cap + 7) // 8 * 8


def _route(p, cfg, xf, capacity_factor):
    """Router, top-k and ranks of the (n, D) tokens ``xf``:
    (cap, probs (n, E), weights (n, k), e_flat (n k,), pos (n k,))."""
    cap = expert_capacity(xf.shape[0], cfg.moe, capacity_factor)
    logits = xf @ p["router"].to(xf.dtype)
    probs, weights, idx = router_topk(logits, cfg.moe.num_experts_per_tok)
    e_flat = idx.reshape(-1)
    return (cap, probs, weights, e_flat,
            _positions_within_expert(e_flat, cfg.moe.num_experts))


def apply_moe(p, cfg, x, *, capacity_factor: float | None = None):
    """x: (B, S, D) -> (y, aux_loss): single-device dispatch (the JAX
    package's ``_apply_moe_local``)."""
    moe = cfg.moe
    e, k = moe.num_experts, moe.num_experts_per_tok
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    cap, probs, weights, e_flat, pos = _route(p, cfg, xf, capacity_factor)
    tok = torch.arange(n, device=x.device).repeat_interleave(k)
    keep = pos < cap
    cpos = pos.clamp_max(cap - 1).long()

    # dispatch: (E, C, D) buffer; a dropped assignment adds zeros
    vals = xf[tok] * keep[:, None].to(x.dtype)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((e_flat, cpos), vals, accumulate=True)
    buf = shard_act(buf, "expert", "capacity", None)

    h = torch.bmm(buf, p["w_up"].to(x.dtype))
    g = (torch.bmm(buf, p["w_gate"].to(x.dtype)) if cfg.act == "swiglu"
         else None)
    h = shard_act(mlp_act(cfg, h, g), "expert", "capacity", "mlp")
    out_buf = torch.bmm(h, p["w_down"].to(x.dtype))
    out_buf = shard_act(out_buf, "expert", "capacity", None)

    # combine
    contrib = out_buf[e_flat, cpos] * (
        weights.reshape(-1)[:, None] * keep[:, None]).to(x.dtype)
    y = contrib.reshape(n, k, d).sum(1).reshape(b, s, d)
    y = shard_act(y, "batch", "seq", None)

    # load-balance auxiliary loss (Switch-style)
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).index_add(
        0, e_flat, keep.float())
    frac_tokens = counts / counts.sum().clamp_min(1.0)
    frac_probs = probs.mean(0)
    aux = e * (frac_tokens * frac_probs).sum() * moe.router_aux_loss_coef
    return y, aux


def dispatch_load(p, cfg, x, *, capacity_factor: float | None = None):
    """What :func:`apply_moe` would drop on ``x`` (B, S, D): (capacity,
    assignments per expert (E,), (B, S) bool: the tokens with a dropped
    assignment).  For the serving checks, which must know whether two
    passes routed alike."""
    b, s, d = x.shape
    cap, _, _, e_flat, pos = _route(p, cfg, x.reshape(b * s, d),
                                    capacity_factor)
    loads = torch.bincount(e_flat, minlength=cfg.moe.num_experts)
    dropped = (pos >= cap).reshape(b * s, -1).any(-1).reshape(b, s)
    return cap, loads, dropped


__all__ = ["apply_moe", "dispatch_load", "expert_capacity", "init_moe",
           "router_topk"]
