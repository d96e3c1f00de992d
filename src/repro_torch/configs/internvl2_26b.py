"""InternVL2-26B — InternLM2-20B language backbone; InternViT frontend STUBBED.

input_specs() supplies precomputed patch embeddings (B, num_patches, d_model)
prepended to the token sequence. [arXiv:2404.16821]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    qkv_bias=False,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1000000.0,
    num_patches=256,          # one image tile after pixel-shuffle projector (stub)
    source="arXiv:2404.16821",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        name="internvl2-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=1024,
        num_patches=16,
    )
