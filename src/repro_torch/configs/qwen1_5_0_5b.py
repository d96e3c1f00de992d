"""Qwen1.5-0.5B — dense, QKV bias, MHA (kv=16). [hf:Qwen/Qwen1.5-0.5B]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen1.5-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=704,
        vocab_size=1024,
    )
