"""A dense decoder with grouped-query attention (GQA), in plain float32
PyTorch: Minitron-4B's block (arXiv:2407.14679; Nemotron's layout), the
layout of its parameters, how the benchmark draws them, and the forward
pass over whole sequences.

Each block: layer norm, causal GQA attention with rotary positions (the
halves of each head rotated, base ``rope_theta``) and no biases, added to
the residual; layer norm, an MLP with a squared ReLU, added to the
residual.  A final layer norm, and an untied output head.  The attention
is computed whole (the scores of every pair, the future masked), in
blocks of query rows so that it fits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import layer_norm, remat

QUERY_BLOCK = 1024


def layout(cfg: dict) -> list:
    """``[(path, shape, init)]`` of every parameter, in the order of the
    tree the program takes (per-layer leaves stacked on a leading axis).
    A matrix is normal with std 1/sqrt(fan-in), and the two that end a
    residual branch (``wo``, ``w_down``) that times 1/sqrt(2·num_layers),
    as GPT-2 initialises them."""
    d, f, v, n = (cfg["d_model"], cfg["d_ff"], cfg["vocab_size"],
                  cfg["num_layers"])
    h, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    scale, bias = ("normal", 1.0, 0.1), ("normal", 0.0, 0.1)
    res = 1.0 / math.sqrt(2 * n)

    def normal(std):
        return ("normal", 0.0, std)

    block = [
        (("attn_norm", "scale"), (n, d), scale),
        (("attn_norm", "bias"), (n, d), bias),
        (("attn", "wq"), (n, d, h, hd), normal(1.0 / math.sqrt(d))),
        (("attn", "wk"), (n, d, kv, hd), normal(1.0 / math.sqrt(d))),
        (("attn", "wv"), (n, d, kv, hd), normal(1.0 / math.sqrt(d))),
        (("attn", "wo"), (n, h, hd, d), normal(res / math.sqrt(h * hd))),
        (("ffn_norm", "scale"), (n, d), scale),
        (("ffn_norm", "bias"), (n, d), bias),
        (("mlp", "w_up"), (n, d, f), normal(1.0 / math.sqrt(d))),
        (("mlp", "w_down"), (n, f, d), normal(res / math.sqrt(f))),
    ]
    return ([(("embed", "table"), (v, d), normal(0.02))]
            + [(("blocks",) + p, s, i) for p, s, i in block]
            + [(("final_norm", "scale"), (d,), scale),
               (("final_norm", "bias"), (d,), bias),
               (("head", "w"), (d, v), normal(1.0 / math.sqrt(d)))])


def _rope(x, theta: float):
    """x: (B, T, N, hd); position t rotates channel pair (j, j + hd/2) by
    t·theta^(-2j/hd)."""
    t, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, x, cfg):
    b, t, d = x.shape
    h, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = _rope((x @ p["wq"].reshape(d, h * hd)).reshape(b, t, h, hd),
              cfg["rope_theta"])
    k = _rope((x @ p["wk"].reshape(d, kv * hd)).reshape(b, t, kv, hd),
              cfg["rope_theta"])
    v = (x @ p["wv"].reshape(d, kv * hd)).reshape(b, t, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2).transpose(1, 2)  # (B, H, T, hd)
    v = v.repeat_interleave(h // kv, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    pos = torch.arange(t, device=x.device)
    outs = []
    for q0 in range(0, t, QUERY_BLOCK):
        qb = q[:, :, q0:q0 + QUERY_BLOCK]
        s = (qb @ k.transpose(2, 3)) / math.sqrt(hd)
        future = pos[None, :] > pos[q0:q0 + QUERY_BLOCK, None]
        s = s.masked_fill(future, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ v)
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, t, h * hd)
    return out @ p["wo"].reshape(h * hd, d)


def _block(bp, x, cfg):
    x = x + _attention(bp["attn"], layer_norm(x, **bp["attn_norm"]), cfg)
    hn = layer_norm(x, **bp["ffn_norm"])
    return x + F.relu(hn @ bp["mlp"]["w_up"]).square() @ bp["mlp"]["w_down"]


class Model:
    """``features(params, tokens)``: the final-normed hidden states (B, T,
    D); ``logits(head, feats)``."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    def features(self, params, tokens):
        x = params["embed"]["table"][tokens.long()]
        blocks = params["blocks"]
        for i in range(self.cfg["num_layers"]):
            bp = {g: {k: v[i] for k, v in blocks[g].items()} for g in blocks}
            x = remat(lambda x_, bp_=bp: _block(bp_, x_, self.cfg), x)
        return layer_norm(x, **params["final_norm"])

    @staticmethod
    def logits(head, feats):
        return feats @ head["w"]
