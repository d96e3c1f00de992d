"""Logical-axis -> mesh-axis rule tables, one per distribution strategy.

Mesh axes: ('pod', 'data', 'model') multi-pod, ('data', 'model') single pod.
Logical axes used by the models:

  batch        activation batch dim                 -> ('pod','data')
  seq          sequence (only sharded for long KV)  -> usually None
  vocab        vocab dim of embedding / lm head
  embed        d_model dim of weights (FSDP shard)
  mlp          FFN hidden dim
  heads        attention query heads
  kv_heads     attention kv heads
  expert       MoE expert dim
  capacity     MoE dispatch buffer token dim
  mamba        mamba inner dim
  rwkv_head    rwkv head dim
  layers       stacked-layer leading dim (never sharded)
  conv_out     CNN channels
"""
from __future__ import annotations

from typing import Mapping

_DATA = ("pod", "data")  # resolved against the actual mesh axis names


def _filter(rules: Mapping, mesh_axes) -> dict:
    """Drop mesh axes that don't exist in the current mesh (e.g. 'pod')."""
    out = {}
    for k, v in rules.items():
        if v is None:
            out[k] = None
        elif isinstance(v, tuple):
            kept = tuple(a for a in v if a in mesh_axes)
            out[k] = kept if len(kept) > 1 else (kept[0] if kept else None)
        else:
            out[k] = v if v in mesh_axes else None
    return out


# FSDP over 'data' + tensor/expert parallel over 'model'.  This is the
# modern baseline mapping; also used for all inference shapes.
FSDP_TP = {
    "batch": _DATA,
    "seq": None,
    "kv_seq": "data",      # sequence-sharded KV cache for long decode
    "vocab": "model",
    "embed": "data",
    "mlp": "model",
    "heads": "model",
    "kv_heads": None,      # kv heads are few (<=8); replicate, shard q heads
    "expert": "model",
    "capacity": "data",
    "mamba": "model",
    "rwkv_head": "model",
    "layers": None,
    "conv_out": None,
}

# MLitB-style pure data parallelism: weights replicated, grads all-reduced.
DP_FULL = {k: None for k in FSDP_TP} | {"batch": _DATA, "kv_seq": None}

# Paper's split strategy.  Head placement, measured on the 16x16 dry-run
# (see EXPERIMENTS.md §Perf, iteration 0):
#   * ('data','model') "parameter-server" vocab sharding — the literal
#     mapping of "FC on the server" — makes GSPMD all-gather the full-batch
#     dlogits over the data axis: 16x head FLOPs, +105 GiB temp at train_4k.
#     The paper's byte-saving regime requires B·S < 2·V (small batches); at
#     train_4k B·S ≈ 1M >> 2V.  Kept as the opt-in 'split_server_sharded'
#     rule set for decode/small-batch fine-tuning regimes.
#   * default SPLIT therefore places the head like FSDP_TP; the paper's
#     transferable contribution on a fast-interconnect mesh is the
#     CONCURRENCY (stale client head + feature-replay server training),
#     which removes the head-update from the critical path.
SPLIT = dict(FSDP_TP) | {
    "head_vocab": "model",
    "head_embed": "data",
}
SPLIT_PS = dict(FSDP_TP) | {
    "head_vocab": ("data", "model"),
    "head_embed": None,
}
FSDP_TP = dict(FSDP_TP) | {"head_vocab": "model", "head_embed": "data"}
DP_FULL = dict(DP_FULL) | {"head_vocab": None, "head_embed": None}

AXIS_RULES = {
    "dp_full": DP_FULL,
    "fsdp_tp": FSDP_TP,
    "split_concurrent": SPLIT,
    "split_sequential": SPLIT,
    "split_server_sharded": SPLIT_PS,
}


def rules_for_strategy(strategy: str, mesh_axes) -> dict:
    """Logical-axis -> mesh-axis rule table for a strategy, filtered to
    the axes present on ``mesh_axes``."""
    if strategy not in AXIS_RULES:
        raise KeyError(f"unknown strategy {strategy!r}; known {sorted(AXIS_RULES)}")
    return _filter(AXIS_RULES[strategy], tuple(mesh_axes))
