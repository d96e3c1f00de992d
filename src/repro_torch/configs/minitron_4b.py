"""Minitron-4B — pruned Nemotron, GQA kv=8, squared-relu MLP. [arXiv:2407.14679]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    qkv_bias=False,
    norm="layernorm",
    act="relu2",
    rope_theta=10000.0,
    source="arXiv:2407.14679",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="minitron-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=768,
        vocab_size=1024,
    )
