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

Under a sharding context whose ``expert`` rule names a mesh axis that
divides E, a DTensor input takes the expert-parallel path
(:func:`_apply_moe_sharded`, the port of the JAX package's ``shard_map``
dispatch): every rank routes and scatters its own tokens locally, computes
only its model shard's experts, and the partial outputs are summed over
the ``model`` axis with explicit, autograd-aware collectives over the
mesh's process groups.  Anything else takes the local dispatch; a DTensor
there is first gathered whole (``on_local_shards`` with nothing split):
its ranks are global (arrival order over every token, and the capacity
counts them all), so it cannot run on shards.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import mlp_act
from repro_torch.sharding.collectives import (gather_over, local_in,
                                              local_out, sum_over)
from repro_torch.sharding.spec import (axis_sizes, current_ctx, is_dtensor,
                                       on_local_shards, param, placements,
                                       shard_act, to_pspec)


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
    """x: (B, S, D) -> (y, aux_loss).

    Dispatched as the JAX package's ``apply_moe``: the expert-parallel
    path under a context whose ``expert`` rule names a mesh axis dividing
    E (and, here, for a DTensor ``x``), else the local dispatch."""
    ctx = current_ctx()
    if ctx is not None and ctx.mesh is not None and is_dtensor(x):
        expert_ax = ctx.rules.get("expert")
        if expert_ax is not None and cfg.moe.num_experts % \
                axis_sizes(ctx.mesh)[expert_ax] == 0:
            return _apply_moe_sharded(p, cfg, x, ctx,
                                      capacity_factor=capacity_factor)
    if is_dtensor(x):
        # the local dispatch's ranks and capacity count every token: it
        # runs on the whole tensors, gathered, alike on every rank
        keys = sorted(p)
        return on_local_shards(
            lambda x_, *ws: _apply_moe_local(dict(zip(keys, ws)), cfg, x_,
                                             capacity_factor=capacity_factor),
            x, {}, [(x, {})] + [(p[k], {}) for k in keys], ({}, {}))
    return _apply_moe_local(p, cfg, x, capacity_factor=capacity_factor)


def _apply_moe_local(p, cfg, x, *, capacity_factor: float | None = None):
    """Single-shard dispatch (reference semantics)."""
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


def _flat_axes(ax) -> tuple:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def _apply_moe_sharded(p, cfg, x, ctx, *, capacity_factor=None):
    """Expert-parallel MoE (the JAX package's ``shard_map`` dispatch):
    each rank routes and scatters its own tokens locally into an
    (E, C_local, D) buffer, computes only its ``model`` shard's E/n
    experts, and the partial outputs are summed over ``model``.

    Collectives a layer: the expert weights all-gathered over the FSDP
    axis (the ``embed`` rule's axes that shard them), the (tokens, D)
    outputs summed over ``model``, and the auxiliary loss averaged over
    the whole mesh.  When the batch is replicated over the FSDP axis and
    ``cap * n_fsdp < D`` (a few tokens a step, as in decode), the weights
    stay resident instead: each FSDP shard multiplies its D-slice of the
    dispatch buffer, the partial hidden states are summed and the outputs
    gathered over the FSDP axis.  ``x`` and every weight are DTensors on
    ``ctx.mesh``; returns (y, aux) as DTensors, y placed as ``x`` is."""
    mesh, rules = ctx.mesh, ctx.rules
    sizes = axis_sizes(mesh)
    moe = cfg.moe
    e, k = moe.num_experts, moe.num_experts_per_tok
    b, s, d = x.shape

    model_ax = rules.get("expert")
    batch_axes = tuple(a for a in _flat_axes(rules.get("batch"))
                       if b % max(sizes[a], 1) == 0)
    x_pl = placements(to_pspec(("batch", None, None),
                               dict(rules) | {"batch": batch_axes or None},
                               mesh=mesh, shape=x.shape), mesh)
    axes3 = {"w_up": ("expert", "embed", "mlp"),
             "w_gate": ("expert", "embed", "mlp"),
             "w_down": ("expert", "mlp", "embed"),
             "router": ("embed", None)}
    specs = {k2: to_pspec(axes3[k2], rules, mesh=mesh, shape=p[k2].shape)
             for k2 in p}

    # weight FSDP axes: the embed rule's axes (bar the expert axis) that
    # actually shard the weights
    def fsdp_of(k2, dim):
        return tuple(a for a in _flat_axes(specs[k2][dim]) if a != model_ax)

    fsdp_axes = fsdp_of("w_up", 1)
    n_fsdp = 1
    for a in fsdp_axes:
        n_fsdp *= sizes[a]
    n_model = sizes[model_ax]
    e_loc = e // n_model

    x_loc = local_in(x, mesh, x_pl)
    p_loc = {k2: local_in(v, mesh, placements(specs[k2], mesh))
             for k2, v in p.items()}
    bl, sl, _ = x_loc.shape
    n = bl * sl
    cap = expert_capacity(n, moe, capacity_factor)

    router = gather_over(p_loc["router"], mesh, fsdp_of("router", 0), 0)
    xf = x_loc.reshape(n, d)
    logits = xf @ router.to(xf.dtype)
    probs, weights, idx = router_topk(logits, k)
    e_flat = idx.reshape(-1)
    tok = torch.arange(n, device=xf.device).repeat_interleave(k)
    pos = _positions_within_expert(e_flat, e)
    keep = pos < cap
    cpos = pos.clamp_max(cap - 1).long()

    vals = xf[tok] * keep[:, None].to(xf.dtype)
    buf = torch.zeros((e, cap, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_put((e_flat, cpos), vals, accumulate=True)

    # this model shard computes only its own experts
    e0 = mesh.get_local_rank(model_ax) * e_loc
    buf_loc = buf[e0:e0 + e_loc]

    batch_uses_fsdp = any(a in batch_axes for a in fsdp_axes)
    use_partial = (bool(fsdp_axes) and not batch_uses_fsdp
                   and cap * n_fsdp < d
                   and fsdp_of("w_down", 2) == fsdp_axes)
    if use_partial:
        # partial-sum schedule: weights stay resident
        d_loc = d // n_fsdp
        di = 0
        for a in fsdp_axes:
            di = di * sizes[a] + mesh.get_local_rank(a)
        buf_slice = buf_loc[:, :, di * d_loc:(di + 1) * d_loc]
        h = torch.bmm(buf_slice, p_loc["w_up"].to(xf.dtype))
        g = (torch.bmm(buf_slice, p_loc["w_gate"].to(xf.dtype))
             if "w_gate" in p_loc else None)
        h = sum_over(h, mesh, fsdp_axes)
        if g is not None:
            g = sum_over(g, mesh, fsdp_axes)
        h = mlp_act(cfg, h, g)
        out_part = torch.bmm(h, p_loc["w_down"].to(xf.dtype))
        out_buf = gather_over(out_part, mesh, fsdp_axes, 2)
    else:
        # weight-gather schedule
        w_up = gather_over(p_loc["w_up"], mesh, fsdp_of("w_up", 1), 1)
        w_down = gather_over(p_loc["w_down"], mesh, fsdp_of("w_down", 2), 2)
        h = torch.bmm(buf_loc, w_up.to(xf.dtype))
        g = (torch.bmm(buf_loc, gather_over(
            p_loc["w_gate"], mesh, fsdp_of("w_gate", 1), 1).to(xf.dtype))
            if "w_gate" in p_loc else None)
        h = mlp_act(cfg, h, g)
        out_buf = torch.bmm(h, w_down.to(xf.dtype))

    # combine this shard's experts' contributions, sum over expert shards
    le = e_flat - e0
    mine = (le >= 0) & (le < e_loc) & keep
    contrib = out_buf[le.clamp(0, e_loc - 1), cpos]
    contrib = contrib * (weights.reshape(-1)[:, None]
                         * mine[:, None]).to(xf.dtype)
    y = contrib.reshape(n, k, d).sum(1)
    y = sum_over(y, mesh, (model_ax,)).reshape(bl, sl, d)

    counts = torch.zeros(e, dtype=torch.float32, device=xf.device).index_add(
        0, e_flat, keep.float())
    frac_tokens = counts / counts.sum().clamp_min(1.0)
    aux = e * (frac_tokens * probs.mean(0)).sum() * moe.router_aux_loss_coef
    # the same scalar on every rank: the mean over the whole mesh
    aux = sum_over(aux, mesh, tuple(sizes)) / mesh.size()
    return local_out(y, mesh, x_pl), local_out(
        aux, mesh, placements((), mesh))


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
