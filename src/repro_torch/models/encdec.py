"""Whisper-style encoder-decoder backbone, the port of
``repro.models.encdec``.

The mel-spectrogram and conv feature extractor is a stub, as in the JAX
package: ``frames`` arrive as precomputed (B, T_enc, d_model) embeddings.
Positions are fixed sinusoids (no RoPE).  The tree is the JAX package's
(``embed, enc_blocks, enc_norm, dec_blocks, final_norm, head``, each block
stack with a leading ``layers`` axis), so a JAX tree carries across leaf
for leaf.  The encoder's self-attention (non-causal) and the decoder's
self- and cross-attention over the whole sequence run K3; decode keeps a
self-attention KV cache (written in place) and reads the cross K/V the
prefill computed.  Training (``forward_train(differentiable=True)``) runs
every attention in torch ops, since K3 has no backward, and under
``remat`` recomputes each decoder block in the backward pass (the encoder
is not recomputed, as in the JAX package).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer, stack_layers
from repro_torch.sharding.spec import shard_act


def _init_enc_block(generator, cfg):
    return {
        "attn_norm": L.init_norm(cfg, generator=generator),
        "attn": L.init_attention(generator, cfg),
        "ffn_norm": L.init_norm(cfg, generator=generator),
        "mlp": L.init_mlp(generator, cfg),
    }


def _init_dec_block(generator, cfg):
    return {
        "attn_norm": L.init_norm(cfg, generator=generator),
        "attn": L.init_attention(generator, cfg),
        "cross_norm": L.init_norm(cfg, generator=generator),
        "cross": L.init_attention(generator, cfg, cross=True),
        "ffn_norm": L.init_norm(cfg, generator=generator),
        "mlp": L.init_mlp(generator, cfg),
    }


def init_model(generator, cfg):
    """-> Param tree of the encoder-decoder on ``generator``'s device (the
    meta device for ``None``)."""
    return {
        "embed": L.init_embedding(generator, cfg),
        "enc_blocks": stack_layers(lambda: _init_enc_block(generator, cfg),
                                   cfg.encoder_layers),
        "enc_norm": L.init_norm(cfg, generator=generator),
        "dec_blocks": stack_layers(lambda: _init_dec_block(generator, cfg),
                                   cfg.num_layers),
        "final_norm": L.init_norm(cfg, generator=generator),
        "head": L.init_lm_head(generator, cfg),
    }


def encode(params, cfg, frames, *, dtype=torch.bfloat16,
           differentiable=False):
    """frames: (B, T_enc, D) stub embeddings -> (B, T_enc, D).
    ``differentiable``: the attention in torch ops, for training."""
    t = frames.shape[1]
    x = frames.to(dtype) + L.sinusoidal_positions(
        t, cfg.d_model, device=frames.device).to(dtype)[None]
    x = shard_act(x, "batch", "seq", None)
    positions = torch.arange(t, dtype=torch.int32, device=x.device)
    for i in range(cfg.encoder_layers):
        bp = layer(params["enc_blocks"], i)
        h, _ = L.attention(bp["attn"], cfg,
                           L.apply_norm(bp["attn_norm"], cfg, x),
                           positions=positions, causal=False, use_rope=False,
                           differentiable=differentiable)
        x = x + h
        x = x + L.apply_mlp(bp["mlp"], cfg,
                            L.apply_norm(bp["ffn_norm"], cfg, x))
    return L.apply_norm(params["enc_norm"], cfg, x)


def _dec_block(bp, cfg, x, enc_out, *, positions, cache=None,
               cross_cache=None, cache_index=None, differentiable=False):
    """One decoder block.  Full sequence (``cache is None``): cross K/V
    projected from ``enc_out``; decode: ``cache`` the self-attention
    (k, v, pos) and ``cross_cache`` the cross (k, v).  ``differentiable``:
    both attentions in torch ops, for training.  Returns (x, the
    self-attention's (k, v[, pos]), the cross (k, v))."""
    h, new_cache = L.attention(
        bp["attn"], cfg, L.apply_norm(bp["attn_norm"], cfg, x),
        positions=positions, causal=True, use_rope=False, cache=cache,
        cache_index=cache_index, differentiable=differentiable)
    x = x + h
    h, cross_kv = L.attention(
        bp["cross"], cfg, L.apply_norm(bp["cross_norm"], cfg, x),
        positions=positions, encoder_out=enc_out, cache=cross_cache,
        use_rope=False, differentiable=differentiable)
    x = x + h
    x = x + L.apply_mlp(bp["mlp"], cfg, L.apply_norm(bp["ffn_norm"], cfg, x))
    return x, new_cache, cross_kv


def _embed_decoder(params, cfg, tokens, dtype):
    s = tokens.shape[1]
    x = L.embed_tokens(params["embed"], cfg, tokens, dtype)
    return x + L.sinusoidal_positions(
        s, cfg.d_model, device=x.device).to(dtype)[None]


def forward_train(params, cfg, tokens, *, frames, dtype=torch.bfloat16,
                  window=None, remat=True, compute_logits=True,
                  differentiable=False):
    """The encoder over ``frames``, then the whole decoder sequence:
    (logits, aux_loss 0, features).  ``differentiable``: every attention
    in torch ops, for training (K3 refuses inputs that require grad).
    ``remat``: while autograd records, each decoder block runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass, as
    the JAX package's ``jax.checkpoint(body)`` over ``dec_blocks``."""
    enc_out = encode(params, cfg, frames, dtype=dtype,
                     differentiable=differentiable)
    x = _embed_decoder(params, cfg, tokens, dtype)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)

    def body(bp, x, enc_out):
        return _dec_block(bp, cfg, x, enc_out, positions=positions,
                          differentiable=differentiable)[0]

    for i in range(cfg.num_layers):
        x = L.checkpointed(body, layer(params["dec_blocks"], i), x, enc_out,
                           enabled=remat)
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = (L.lm_logits(params["head"], params["embed"], cfg, x)
              if compute_logits else None)
    return logits, torch.zeros((), device=x.device), x


def init_cache(cfg, batch: int, cache_len: int, *, window=None,
               dtype=torch.bfloat16, device="cuda", full=L.full_whole):
    """Self-attention KV ring per decoder layer, and the cross K/V over
    the ``encoder_seq_len`` frames, each leaf made by ``full``
    (``transformer.init_cache``)."""
    window = cfg.sliding_window if window is None else window
    dev = resolve_device(device)
    size = min(window, cache_len) if window else cache_len
    kv, hd, lyr = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    cross = (lyr, batch, cfg.encoder_seq_len, kv, hd)
    return {
        "k": full("k", (lyr, batch, size, kv, hd), 0, dtype, dev),
        "v": full("v", (lyr, batch, size, kv, hd), 0, dtype, dev),
        "pos": full("pos", (lyr, size), -1, torch.int32, dev),
        "cross_k": full("cross_k", cross, 0, dtype, dev),
        "cross_v": full("cross_v", cross, 0, dtype, dev),
    }


def prefill(params, cfg, tokens, *, frames, dtype=torch.bfloat16,
            window=None, cache_len: int | None = None, full=L.full_whole):
    """Encode the frames, run the decoder prompt, build the self and cross
    caches, each leaf made by ``full`` (:func:`init_cache`).  The cross
    K/V are computed once, by the cross-attention (the JAX package
    computes them a second time for the cache).  Returns (last_logits
    (B,1,V), cache)."""
    window = cfg.sliding_window if window is None else window
    if frames.shape[1] != cfg.encoder_seq_len:
        raise ValueError(f"frames hold {frames.shape[1]} positions, the "
                         f"cross cache {cfg.encoder_seq_len} "
                         f"(encoder_seq_len)")
    enc_out = encode(params, cfg, frames, dtype=dtype)
    b, s = tokens.shape
    cache = init_cache(cfg, b, cache_len or s, window=window, dtype=dtype,
                       device=enc_out.device, full=full)
    x = _embed_decoder(params, cfg, tokens, dtype)
    size = cache["pos"].shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    keep, slots = L.prefill_slots(positions, size)
    for i in range(cfg.num_layers):
        x, (k, v), (ck, cv) = _dec_block(layer(params["dec_blocks"], i),
                                         cfg, x, enc_out,
                                         positions=positions)
        L.write_rows(cache["k"][i], 1, slots, k[:, s - len(keep):])
        L.write_rows(cache["v"][i], 1, slots, v[:, s - len(keep):])
        L.write_rows(cache["pos"][i], 0, slots, keep)
        L.write_rows(cache["cross_k"], 0, i, ck[None])
        L.write_rows(cache["cross_v"], 0, i, cv[None])
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = L.lm_logits(params["head"], params["embed"], cfg, x[:, -1:])
    return logits, cache


def decode_step(params, cfg, cache, token, index, *, dtype=torch.bfloat16,
                window=None):
    """token: (B, 1) int; index: the token's absolute position, a host int
    or a 0-d int32 tensor on the params' device (``layers.decode_index``).
    Its sinusoid is the table's row ``min(index, max_seq_len - 1)``, as
    the JAX package's, computed alone and clamped on the device.

    Returns (logits (B,1,V), cache): the self-attention cache is updated
    in place, the cross K/V are read."""
    x = L.embed_tokens(params["embed"], cfg, token, dtype)
    index = L.decode_index(index, cache["k"])
    x = x + L.sinusoidal_position(index, cfg.d_model, cfg.max_seq_len,
                                  device=x.device).to(dtype)[None]
    for i in range(cfg.num_layers):
        x, _, _ = _dec_block(
            layer(params["dec_blocks"], i), cfg, x, None, positions=None,
            cache=(cache["k"][i], cache["v"][i], cache["pos"][i]),
            cross_cache=(cache["cross_k"][i], cache["cross_v"][i]),
            cache_index=index)
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = L.lm_logits(params["head"], params["embed"], cfg, x)
    return logits, cache
