"""Device meshes (port of ``repro.launch.mesh``), as functions, so that
importing this module touches no process group.

A local mesh is a torch ``DeviceMesh`` with ``mesh_dim_names`` ``("data",
"model")`` over the ranks of the default process group: NCCL on ``cuda``
(one card a rank) and gloo on ``cpu``.  Launch its ranks with ``torchrun``
(which sets ``RANK``, ``WORLD_SIZE`` and the rendezvous address), or
initialise the default group yourself before asking for the mesh.

A shape-only mesh (:func:`make_shape_mesh`, and the JAX package's
production meshes through :func:`make_production_mesh`) is a mesh of any
shape in one process, over a fake process group: it holds DTensors of meta
tensors, for the dry-run.
"""
from __future__ import annotations

import os

import torch

from repro_torch.device import resolve_device

#: the production meshes of the JAX package: 16x16 chips a pod, and two
#: pods
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


def make_shape_mesh(shape, names):
    """A shape-only ``DeviceMesh`` of ``shape`` with dimension ``names``:
    this process is rank 0 of ``prod(shape)`` ranks of a fake process group
    (``torch.testing._internal.distributed.fake_pg``), whose collectives
    return at once and move nothing.  It carries DTensors whose local
    shards are meta tensors, each of rank 0's shape: the dry-run's
    (``launch/dryrun.py``), which runs a step on it for its shapes,
    operations and collectives, never its values.

    The fake group becomes this process's default group (a fake one of
    another size is replaced).  A real default group refuses: a fake group
    beside it would break it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a shape-only {'x'.join(map(str, shape))} mesh needs a fake "
                f"process group, and this process already has a real "
                f"{dist.get_backend()!r} one; build it in a process of its "
                f"own")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's 16x16 (``multi_pod``: 2x16x16) mesh, shape-only
    (:func:`make_shape_mesh`): 256 (512) ranks of a fake process group, for
    the dry-run's meta-device steps."""
    return make_shape_mesh(*PRODUCTION_SHAPES[multi_pod])


__all__ = ["PRODUCTION_SHAPES", "make_local_mesh", "make_production_mesh",
           "make_shape_mesh"]
