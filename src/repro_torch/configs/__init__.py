"""Model configurations the port runs.

``base`` and the ten architecture modules (``qwen3_4b``, ``rwkv6_1_6b``, ...)
are byte copies of ``repro.configs``, as is ``paper_cnn`` (the paper's
CNNs); this package re-exports what ``repro.configs`` exports."""
from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    MambaConfig,
    MoEConfig,
    RWKVConfig,
    RunConfig,
    all_arch_configs,
    get_arch_config,
    get_smoke_config,
)

__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "ArchConfig",
    "InputShape",
    "MambaConfig",
    "MoEConfig",
    "RWKVConfig",
    "RunConfig",
    "all_arch_configs",
    "get_arch_config",
    "get_smoke_config",
]
