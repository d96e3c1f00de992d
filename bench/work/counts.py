"""The benchmark's own count of the work a step or a call needs, from the
configuration and the cell's shapes alone: matrix-product operations,
and the bytes a kernel's operation must move.  Counted per operation of
the model, not per kernel of the program, so a kernel that is replaced
or fused is held to the same bound.

Conventions: a multiply-add is 2 operations; causal attention counts the
pairs it needs (a query and every key at or before it), not a masked
square; recomputation is not counted (a rematerialised forward is the
program's choice, not the model's need); the backward of a product is
twice its forward.  Bytes count each input read once and each output
written once, f32.
"""
from __future__ import annotations

import math

F32 = 4

#: NVIDIA H100 SXM5 data sheet, dense rates at 700 W.
PEAK_TF32 = 495e12     # the peak every mfu and product roofline uses
PEAK_F32 = 67e12       # f32 outside the tensor cores, quoted beside it
HBM_BYTES_PER_S = 3.35e12


def causal_pairs(s: int) -> int:
    """(query, key) pairs of causal attention over ``s`` positions."""
    return s * (s + 1) // 2


def n_params(layout) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout)


def _layer_token_flops(cfg: dict) -> int:
    """Products of one layer for one token, attention's pairs excepted."""
    d, f = cfg["d_model"], cfg["d_ff"]
    if cfg["family"] == "ssm":
        hd = cfg["rwkv"]["head_size"]
        h, lora = d // hd, cfg["decay_lora_dim"]
        time_mix = 5 * d * d + 2 * d * lora
        channel_mix = 2 * d * f + d * d
        # the recurrence: the readout r·S and the state's update, each a
        # multiply-add per entry of every head's (hd, hd) state
        return 2 * (time_mix + channel_mix) + 4 * h * hd * hd
    h, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    return 2 * (d * h * hd + 2 * d * kv * hd + h * hd * d + 2 * d * f)


def _pair_flops(cfg: dict) -> int:
    """Products of one layer for one (query, key) pair: q·k and p·v."""
    if cfg["family"] == "ssm":
        return 0
    return 4 * cfg["num_heads"] * cfg["head_dim"]


def forward_flops(cfg: dict, batch: int, seq: int) -> int:
    """The backbone's forward over ``batch`` sequences of ``seq`` tokens
    (no output head)."""
    per_layer = (batch * seq * _layer_token_flops(cfg)
                 + batch * causal_pairs(seq) * _pair_flops(cfg))
    return cfg["num_layers"] * per_layer


def head_flops(cfg: dict, tokens: int) -> int:
    return 2 * cfg["d_model"] * cfg["vocab_size"] * tokens


def train_step_flops(cfg: dict, batch: int, seq: int) -> int:
    """One split_concurrent step: the backbone's forward and backward
    (3x its forward); the head four times over the step's tokens: the
    clients' forward and the gradient they send back through the stale
    head, the server's forward and its gradient of the head."""
    return (3 * forward_flops(cfg, batch, seq)
            + 4 * head_flops(cfg, batch * seq))


def serve_call_flops(cfg: dict, batch: int, prompt: int, gen: int) -> int:
    """One ``generate`` call: the prefill over the prompts (the head at
    the last position alone), then ``gen`` decode steps of one token a
    sequence, each attending to every position before it and its own."""
    decode_pairs = sum(prompt + i + 1 for i in range(gen))
    decode = cfg["num_layers"] * batch * (gen * _layer_token_flops(cfg)
                                          + decode_pairs * _pair_flops(cfg))
    return (forward_flops(cfg, batch, prompt) + decode
            + head_flops(cfg, batch * (gen + 1)))


def adagrad_bytes(params: int) -> int:
    """The modified-AdaGrad update of ``params`` f32 parameters: reads the
    parameter, its gradient and its accumulator, writes the parameter and
    the accumulator."""
    return 5 * F32 * params


def wkv_bytes(batch: int, steps: int, heads: int, hd: int) -> int:
    """One layer's WKV over ``steps`` tokens: r, k, v, the decay and the
    output (B, T, H, hd) each, the bonus u (H, hd), the state in and out
    (B, H, hd, hd) each."""
    return F32 * (5 * batch * steps * heads * hd + heads * hd
                  + 2 * batch * heads * hd * hd)


def attention_work(batch: int, sq: int, skv: int, hq: int, hkv: int,
                   hd: int, causal: bool) -> tuple:
    """(operations, bytes) of one attention call: q and the output
    (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd)."""
    pairs = causal_pairs(sq) if causal else sq * skv
    flops = 4 * batch * hq * hd * pairs
    nbytes = F32 * 2 * batch * hd * (sq * hq + skv * hkv)
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peak: float = PEAK_TF32) -> float:
    """The least time the chip could take: operations over ``peak`` or
    bytes over the memory's rate, whichever is larger."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)
