"""Whisper-small — encoder-decoder audio backbone; conv/mel frontend STUBBED.

input_specs() supplies precomputed frame embeddings (B, 1500, d_model).
[arXiv:2212.04356]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    encoder_seq_len=1500,     # 30 s audio -> 1500 frames after conv frontend (stub)
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    source="arXiv:2212.04356",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="whisper-smoke",
        num_layers=2,
        encoder_layers=2,
        encoder_seq_len=64,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
    )
