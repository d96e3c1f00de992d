"""Run-level config surgery (port of the single-device part of
``repro.launch.steps``).  The rest of that module builds sharded step
functions, which come with sharding (ROADMAP.md, Queue 1 item 7)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, InputShape

LONG_CONTEXT_WINDOW = 8192  # sliding window used by full-attention archs
                            # for the long_500k shape


def arch_for_run(cfg: ArchConfig, shape: InputShape,
                 strategy: str) -> ArchConfig:
    """Apply run-level config surgery: untie heads for split strategies,
    sliding window for long-context decode on full-attention archs."""
    if strategy.startswith("split") and cfg.tie_embeddings:
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    if (shape.name == "long_500k" and not cfg.supports_long_context
            and not cfg.sliding_window):
        cfg = cfg.with_sliding_window(LONG_CONTEXT_WINDOW)
    return cfg


__all__ = ["LONG_CONTEXT_WINDOW", "arch_for_run"]
