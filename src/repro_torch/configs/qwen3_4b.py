"""Qwen3-4B — dense, qk_norm, GQA kv=8. [hf:Qwen/Qwen3-8B family]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=False,
    qk_norm=True,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen3-4b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=704,
        vocab_size=1024,
    )
