"""DBRX-132B — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    qkv_bias=False,
    norm="layernorm",
    act="swiglu",
    rope_theta=500000.0,
    moe=MoEConfig(num_experts=16, num_experts_per_tok=4),
    source="hf:databricks/dbrx-base",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="dbrx-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=448,
        vocab_size=1024,
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2),
    )
