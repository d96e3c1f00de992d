"""Device meshes (port of ``repro.launch.mesh``), as functions, so that
importing this module touches no process group.

A local mesh is a torch ``DeviceMesh`` with ``mesh_dim_names`` ``("data",
"model")`` over the ranks of the default process group: NCCL on ``cuda``
(one card a rank) and gloo on ``cpu``.  Launch its ranks with ``torchrun``
(which sets ``RANK``, ``WORLD_SIZE`` and the rendezvous address), or
initialise the default group yourself before asking for the mesh.
"""
from __future__ import annotations

import os

import torch

from repro_torch.device import resolve_device

#: the production meshes of the JAX package: 16x16 TPU v5e chips a pod,
#: and two pods
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def make_local_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A ``(data, model)`` mesh over the default process group's ranks.

    ``device="cuda"`` (the default) raises without a card, as every entry
    point of the port does; ranks are placed one a card
    (``LOCAL_RANK``).  When no process group exists yet it is initialised
    from the environment ``torchrun`` sets, with NCCL on ``cuda`` and gloo
    on ``cpu``.  Raises ``ValueError`` when the world size is not
    ``data * model``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "no process group: launch the ranks with torchrun, or call "
                "torch.distributed.init_process_group first")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(_backend(dev))
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} "
                         f"ranks, the process group has {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's 16x16 (``multi_pod``: 2x16x16) mesh.  It needs 256
    (512) ranks, and the port runs on one host, so this raises; a
    shape-only mesh for the dry-run tooling comes with it (ROADMAP.md,
    Queue 1 item 8)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    n = 1
    for s in shape:
        n *= s
    raise NotImplementedError(
        f"the {'x'.join(map(str, shape))} {axes} production mesh needs {n} "
        f"ranks; the port builds real meshes only (make_local_mesh), and a "
        f"shape-only mesh comes with the dry-run tooling (ROADMAP.md, "
        f"Queue 1 item 8)")


__all__ = ["PRODUCTION_SHAPES", "make_local_mesh", "make_production_mesh"]
