"""Command-R 35B — dense, GQA kv=8, no biases, layernorm. [hf:CohereForAI/c4ai-command-r-v01]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    qkv_bias=False,
    tie_embeddings=True,
    norm="layernorm",
    act="swiglu",
    rope_theta=8000000.0,
    source="hf:CohereForAI/c4ai-command-r-v01",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="command-r-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=704,
        vocab_size=1024,
    )
