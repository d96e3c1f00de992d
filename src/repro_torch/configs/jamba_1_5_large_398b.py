"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

72 layers = 9 periods of (7 mamba + 1 attention); MoE every other layer.
[arXiv:2403.19887]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    qkv_bias=False,
    norm="rmsnorm",
    act="swiglu",
    moe=MoEConfig(num_experts=16, num_experts_per_tok=2),
    moe_layer_period=2,        # every other layer's FFN is MoE
    attn_layer_period=8,       # 1 attention layer per 8 (1:7 attn:mamba)
    attn_layer_offset=4,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="jamba-smoke",
        num_layers=2,              # 1 mamba + 1 attention
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=1024,
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2),
        moe_layer_period=2,
        attn_layer_period=2,
        attn_layer_offset=1,
    )
