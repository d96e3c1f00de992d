"""RWKV-6 "Finch" (arXiv:2404.05892) in plain float32 PyTorch: the layout
of its parameters, how the benchmark draws them, and the forward pass over
whole sequences.

Each block is a time mix and a channel mix, each after a layer norm, each
added to the residual stream.  The time mix's recurrence, per head, with a
data-dependent decay ``w_t = exp(-exp(w0 + tanh(x_w) A B))``:

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

is computed here in chunks of ``CHUNK`` steps in its closed form (the
decays between two steps as the exponential of a difference of cumulative
log decays, always at most 0, so nothing overflows), not step by step as
the program runs it: the same sums in another order.

Departures from the published model, all of them the configuration's:
the token-shift mixes are static per channel (``mu_*``, no data-dependent
LoRA on them), the decay LoRA has ``decay_lora_dim`` columns, the output
group norm is per head with eps 1e-5, the channel mix squares a ReLU, and
the embedding is layer-normed before the first block.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import layer_norm, remat

CHUNK = 32


def layout(cfg: dict) -> list:
    """``[(path, shape, init)]`` of every parameter, in the order of the
    tree the program takes; ``init`` is how the benchmark draws it
    (``bench.core.weights``).  Per-layer leaves are stacked on a leading
    axis of ``num_layers``.  A matrix is normal with std 1/sqrt(fan-in),
    and the two that end a residual branch (``w_o``, the channel mix's
    ``w_v``) that times 1/sqrt(2·num_layers), as GPT-2 initialises them:
    unscaled, the gradient of 24 layers grows ~500-fold over 2 layers'
    and its f32 rounding is amplified to 5-90% of a leaf's norm."""
    d, f, v, n = (cfg["d_model"], cfg["d_ff"], cfg["vocab_size"],
                  cfg["num_layers"])
    hd = cfg["rwkv"]["head_size"]
    h, lora = d // hd, cfg["decay_lora_dim"]

    def mat(a, b, std=None):
        return (n, a, b), ("normal", 0.0, std or 1.0 / math.sqrt(a))

    def vec(init):
        return (n, d), init

    mix = ("uniform", 0.0, 1.0)
    scale, bias = ("normal", 1.0, 0.1), ("normal", 0.0, 0.1)
    res = 1.0 / math.sqrt(2 * n)     # a residual branch's output, GPT-2's
    out = [(("embed", "table"), (v, d), ("normal", 0.0, 0.02)),
           (("embed_norm", "scale"), (d,), scale),
           (("embed_norm", "bias"), (d,), bias)]
    block = [
        (("ln1", "scale"), vec(scale)), (("ln1", "bias"), vec(bias)),
        (("ln2", "scale"), vec(scale)), (("ln2", "bias"), vec(bias)),
        (("tm", "mu_r"), vec(mix)), (("tm", "mu_k"), vec(mix)),
        (("tm", "mu_v"), vec(mix)), (("tm", "mu_g"), vec(mix)),
        (("tm", "mu_w"), vec(mix)),
        (("tm", "w_r"), mat(d, d)), (("tm", "w_k"), mat(d, d)),
        (("tm", "w_v"), mat(d, d)), (("tm", "w_g"), mat(d, d)),
        (("tm", "w_o"), mat(d, d, res / math.sqrt(d))),
        (("tm", "w0"), vec(("decay", -5.0, 8.0, 3.0, 0.1))),
        (("tm", "w_lora_a"), mat(d, lora, 0.01)),
        (("tm", "w_lora_b"), mat(lora, d, 0.01)),
        (("tm", "u"), ((n, h, hd), ("normal", 0.0, 0.1))),
        (("tm", "ln_scale"), vec(scale)), (("tm", "ln_bias"), vec(bias)),
        (("cm", "mu_k"), vec(mix)), (("cm", "mu_r"), vec(mix)),
        (("cm", "w_k"), mat(d, f)),
        (("cm", "w_v"), mat(f, d, res / math.sqrt(f))),
        (("cm", "w_r"), mat(d, d)),
    ]
    out += [(("blocks",) + p, shape, init) for p, (shape, init) in block]
    out += [(("final_norm", "scale"), (d,), scale),
            (("final_norm", "bias"), (d,), bias),
            (("head", "w"), (d, v), ("normal", 0.0, 1.0 / math.sqrt(d)))]
    return out


def wkv(r, k, v, logw, u, s0):
    """The recurrence over (B, H, T, K) inputs from state ``s0`` (B, H, K,
    K), in chunks of ``CHUNK`` steps: (y (B, H, T, K), final state)."""
    t_all = r.shape[2]
    ys, s = [], s0
    for c0 in range(0, t_all, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        y, s = _wkv_chunk(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                          logw[:, :, sl], u, s)
        ys.append(y)
    return torch.cat(ys, dim=2), s


def _wkv_chunk(r, k, v, logw, u, s0):
    c = r.shape[2]
    cum = torch.cumsum(logw, dim=2)              # log decay through step t
    before = cum - logw                          # ... through step t - 1
    # decay from step i+1 to step t-1, for i < t: before_t - cum_i <= 0
    diff = before[:, :, :, None, :] - cum[:, :, None, :, :]
    past = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    decay = torch.exp(torch.where(past[None, None, :, :, None], diff,
                                  float("-inf")))
    att = torch.einsum("bhtk,bhik,bhtik->bhti", r, k, decay)
    bonus = (r * u[None, :, None, :] * k).sum(-1, keepdim=True)
    y = (att @ v + bonus * v
         + (r * torch.exp(before)) @ s0)
    last = cum[:, :, -1:, :]                     # (B, H, 1, K)
    s = (torch.exp(last).transpose(2, 3) * s0
         + (k * torch.exp(last - cum)).transpose(2, 3) @ v)
    return y, s


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _time_mix(p, x, hd: int):
    b, t, d = x.shape
    h = d // hd
    xs = _shift(x)

    def mix(mu):
        return x + (xs - x) * mu

    r = mix(p["mu_r"]) @ p["w_r"]
    k = mix(p["mu_k"]) @ p["w_k"]
    v = mix(p["mu_v"]) @ p["w_v"]
    g = F.silu(mix(p["mu_g"]) @ p["w_g"])
    logw = -torch.exp(p["w0"] + torch.tanh(mix(p["mu_w"])) @ p["w_lora_a"]
                      @ p["w_lora_b"])

    def heads(z):
        return z.reshape(b, t, h, hd).transpose(1, 2)

    s0 = torch.zeros(b, h, hd, hd, dtype=x.dtype, device=x.device)
    y, _ = wkv(heads(r), heads(k), heads(v), heads(logw), p["u"], s0)
    y = layer_norm(y.transpose(1, 2), 1.0, 0.0).reshape(b, t, d)
    y = (y * p["ln_scale"] + p["ln_bias"]) * g
    return y @ p["w_o"]


def _channel_mix(p, x):
    xs = _shift(x)
    k = F.relu((x + (xs - x) * p["mu_k"]) @ p["w_k"]).square()
    r = torch.sigmoid((x + (xs - x) * p["mu_r"]) @ p["w_r"])
    return r * (k @ p["w_v"])


def _block(bp, x, hd):
    x = x + _time_mix(bp["tm"], layer_norm(x, **bp["ln1"]), hd)
    return x + _channel_mix(bp["cm"], layer_norm(x, **bp["ln2"]))


class Model:
    """``features(params, tokens)``: the final-normed hidden states (B, T,
    D); ``logits(head, feats)``."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    def features(self, params, tokens):
        hd = self.cfg["rwkv"]["head_size"]
        x = layer_norm(params["embed"]["table"][tokens.long()],
                       **params["embed_norm"])
        blocks = params["blocks"]
        for i in range(self.cfg["num_layers"]):
            bp = {g: {k: v[i] for k, v in blocks[g].items()} for g in blocks}
            x = remat(lambda x_, bp_=bp: _block(bp_, x_, hd), x)
        return layer_norm(x, **params["final_norm"])

    @staticmethod
    def logits(head, feats):
        return feats @ head["w"]
