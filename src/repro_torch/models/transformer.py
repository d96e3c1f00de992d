"""Decoder-only transformer assembly: the dense, MoE and vlm families.

The port of ``repro.models.transformer``.  Layer parameters keep the JAX
package's *stacked* layout (a leading ``layers`` axis on every leaf of
``params["blocks"]``), so a JAX tree carries across leaf for leaf; the
forward pass loops over the stack in Python where the JAX package scans.
A MoE model (``cfg.is_moe``) has the MoE FFN of ``models/moe.py`` in every
block, called as this module's ``apply_moe``; decode runs it at capacity
factor ``max(2.0, cfg.moe.capacity_factor)``, as the JAX package does.  A
``vlm`` model prepends its (B, P, D) patch embeddings, projected by
``patch_proj``, to the token embeddings, so its positions, logits and
cache cover P + S.

Modes:
  * ``forward_train``: full sequence, returns (logits, aux_loss, features);
    with ``differentiable`` a pass autograd can differentiate (attention
    in torch ops, each block rematerialised in the backward pass under
    ``remat``), else a forward pass through K3 (no backward)
  * ``prefill``: full sequence, returns (logits_last, cache)
  * ``decode_step``: one token against a KV cache (ring buffer when a
    sliding window is configured), updated in place
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.sharding.spec import Param, param
from repro_torch.tree import tree_flatten, tree_map


def stack_layer_axes(tree):
    """Prepend the 'layers' logical axis to every Param of a stack."""
    return tree_map(lambda p: Param(p.value, ("layers",) + p.axes), tree)


def stack_layers(init_one, n: int):
    """``n`` blocks of ``init_one()`` stacked on a leading axis, each leaf
    written into one preallocated tensor (peak memory: the stack and one
    block), with the 'layers' axis prepended.  One block is stacked as a
    view of itself, with no copy."""
    first = init_one()
    if n == 1:
        return stack_layer_axes(tree_map(lambda p: Param(p.value[None],
                                                         p.axes), first))
    leaves, tdef = tree_flatten(first)
    stacked = [torch.empty((n,) + tuple(p.value.shape), dtype=p.value.dtype,
                           device=p.value.device) for p in leaves]
    for i in range(n):
        block = leaves if i == 0 else tdef.flatten_up_to(init_one())
        for dst, p in zip(stacked, block):
            dst[i].copy_(p.value)
    return stack_layer_axes(tdef.unflatten(
        [Param(v, p.axes) for v, p in zip(stacked, leaves)]))


def layer(blocks, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda x: x[i], blocks)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_block(generator, cfg, *, moe_block: bool):
    p = {
        "attn_norm": L.init_norm(cfg, generator=generator),
        "attn": L.init_attention(generator, cfg),
        "ffn_norm": L.init_norm(cfg, generator=generator),
    }
    if moe_block:
        p["moe"] = init_moe(generator, cfg)
    else:
        p["mlp"] = L.init_mlp(generator, cfg)
    return p


def init_model(generator, cfg):
    """-> Param tree of the dense, MoE or vlm decoder on ``generator``'s
    device (the meta device for ``None``)."""
    p = {
        "embed": L.init_embedding(generator, cfg),
        "blocks": stack_layers(
            lambda: init_block(generator, cfg, moe_block=cfg.is_moe),
            cfg.num_layers),
        "final_norm": L.init_norm(cfg, generator=generator),
        "head": L.init_lm_head(generator, cfg),
    }
    if cfg.family == "vlm":
        # the projector stub: patch embeddings arrive pre-extracted, and
        # one linear maps them into d_model
        p["patch_proj"] = {"w": param(generator, (cfg.d_model, cfg.d_model),
                                      ("embed", None), scale=0.02)}
    return p


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------


def _apply_block(bp, cfg, x, *, positions, window, cache=None,
                 cache_index=None, differentiable=False):
    """-> (x, aux_loss (None without MoE), new_cache)."""
    h, new_cache = L.attention(
        bp["attn"], cfg, L.apply_norm(bp["attn_norm"], cfg, x),
        positions=positions, window=window, cache=cache,
        cache_index=cache_index, differentiable=differentiable)
    x = x + h
    hn = L.apply_norm(bp["ffn_norm"], cfg, x)
    if "moe" in bp:
        cf = (max(2.0, cfg.moe.capacity_factor) if cache is not None
              else None)
        h, aux = apply_moe(bp["moe"], cfg, hn, capacity_factor=cf)
    else:
        h, aux = L.apply_mlp(bp["mlp"], cfg, hn), None
    return x + h, aux, new_cache


def _embed_inputs(params, cfg, tokens, patches, dtype):
    x = L.embed_tokens(params["embed"], cfg, tokens, dtype)
    if cfg.family == "vlm":
        pe = torch.einsum("bpd,de->bpe", patches.to(dtype),
                          params["patch_proj"]["w"].to(dtype))
        x = torch.cat([pe, x], dim=1)
    return x


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------


def forward_train(params, cfg, tokens, *, patches=None,
                  dtype=torch.bfloat16, window=None, remat=True,
                  compute_logits=True, differentiable=False):
    """tokens: (B, S_text); vlm: ``patches`` (B, P, D) prepended, so
    S = P + S_text.  Returns (logits, aux_loss, features): ``features``
    are the pre-head hidden states (the paper's split point).

    ``differentiable``: attention in torch ops, for training (K3 refuses
    inputs that require grad).  ``remat``: while autograd records, each
    block runs under ``torch.utils.checkpoint`` and is recomputed in the
    backward pass, as the JAX package's ``jax.checkpoint(body)``."""
    window = cfg.sliding_window if window is None else window
    x = _embed_inputs(params, cfg, tokens, patches, dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def body(bp, x):
        return _apply_block(bp, cfg, x, positions=positions, window=window,
                            differentiable=differentiable)[:2]

    aux = torch.zeros((), device=x.device)
    for i in range(cfg.num_layers):
        x, a = L.checkpointed(body, layer(params["blocks"], i), x,
                              enabled=remat)
        if a is not None:
            aux = aux + a
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = (L.lm_logits(params["head"], params["embed"], cfg, x)
              if compute_logits else None)
    return logits, aux, x


def init_cache(cfg, batch: int, cache_len: int, *, window=None,
               dtype=torch.bfloat16, device="cuda", full=L.full_whole):
    """Every layer's KV ring (``pos``: each slot's position, -1 empty).
    ``full(key, shape, fill, dtype, device)`` makes each leaf: whole by
    default, this rank's shard alone with a sharded prefill's maker."""
    window = cfg.sliding_window if window is None else window
    device = resolve_device(device)
    size = min(window, cache_len) if window else cache_len
    shape = (cfg.num_layers, batch, size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {
        "k": full("k", shape, 0, dtype, device),
        "v": full("v", shape, 0, dtype, device),
        "pos": full("pos", (cfg.num_layers, size), -1, torch.int32, device),
    }


def prefill(params, cfg, tokens, *, patches=None, dtype=torch.bfloat16,
            window=None, cache_len: int | None = None, full=L.full_whole):
    """Full-sequence forward that also builds the KV cache, each leaf made
    by ``full`` (:func:`init_cache`).

    Returns (last_logits (B,1,V), cache).  The cache covers positions
    [0, S) (ring-compressed to the window if one is set); for vlm S counts
    the P patch positions before the text."""
    window = cfg.sliding_window if window is None else window
    x = _embed_inputs(params, cfg, tokens, patches, dtype)
    b, s, _ = x.shape
    cache_len = cache_len or s
    cache = init_cache(cfg, b, cache_len, window=window, dtype=dtype,
                       device=x.device, full=full)
    size = cache["pos"].shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    keep, slots = L.prefill_slots(positions, size)
    for i in range(cfg.num_layers):
        x, _, (k, v) = _apply_block(layer(params["blocks"], i), cfg, x,
                                    positions=positions, window=window)
        L.write_rows(cache["k"][i], 1, slots, k[:, s - len(keep):])
        L.write_rows(cache["v"][i], 1, slots, v[:, s - len(keep):])
        L.write_rows(cache["pos"][i], 0, slots, keep)
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = L.lm_logits(params["head"], params["embed"], cfg, x[:, -1:])
    return logits, cache


def decode_step(params, cfg, cache, token, index, *, dtype=torch.bfloat16,
                window=None):
    """token: (B, 1) int; index: the token's absolute position (for vlm it
    counts the P patch positions), a host int or a 0-d int32 tensor on the
    params' device (``layers.decode_index``: an int is filled into one).
    No use of it reads back to the host, so the step can be captured in a
    CUDA graph and replayed at any index.

    Returns (logits (B,1,V), cache): the cache is updated in place."""
    window = cfg.sliding_window if window is None else window
    x = L.embed_tokens(params["embed"], cfg, token, dtype)
    index = L.decode_index(index, cache["k"])
    for i in range(cfg.num_layers):
        x, _, _ = _apply_block(
            layer(params["blocks"], i), cfg, x, positions=None,
            window=window,
            cache=(cache["k"][i], cache["v"][i], cache["pos"][i]),
            cache_index=index)
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = L.lm_logits(params["head"], params["embed"], cfg, x)
    return logits, cache
