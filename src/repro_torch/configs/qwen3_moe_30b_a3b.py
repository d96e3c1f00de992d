"""Qwen3-30B-A3B — 128-expert top-8 MoE, qk_norm, GQA kv=4. [hf:Qwen/Qwen3-30B-A3B]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,  # per-expert FFN width (fine-grained experts)
    vocab_size=151936,
    head_dim=128,
    qkv_bias=False,
    qk_norm=True,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, num_experts_per_tok=8),
    source="hf:Qwen/Qwen3-30B-A3B",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen3-moe-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=128,
        vocab_size=1024,
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2),
    )
