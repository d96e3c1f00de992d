"""The port's device rule, in one place."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises ``RuntimeError`` when
    CUDA is asked for on a host that has none (never falls back to the
    CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but CUDA is not "
            f"available; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device"]
