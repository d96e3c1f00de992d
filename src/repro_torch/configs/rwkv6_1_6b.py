"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay. [arXiv:2404.05892]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,              # d_model / head_size
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    norm="layernorm",
    act="relu2",               # channel-mix uses squared relu
    rwkv=RWKVConfig(head_size=64),
    source="arXiv:2404.05892",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="rwkv6-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=896,
        vocab_size=1024,
        rwkv=RWKVConfig(head_size=64),
    )
