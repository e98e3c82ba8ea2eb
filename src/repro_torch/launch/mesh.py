"""Training meshes: their axis names and sizes.

Port of `repro/launch/mesh.py`. The reference's production meshes:
  - single pod:  (16, 16)    axes ("data", "model")          = 256 devices
  - multi pod:   (2, 16, 16) axes ("pod", "data", "model")   = 512 devices

Nothing tells a process of a cluster: where one is wanted, the caller
sets up `torch.distributed` (``init_process_group`` with its address,
world size and rank, as the sharded treecode's `GroupRanks` asks) and a
mesh is built over that group's ranks. One process without a group is
one device, and its mesh is a `MeshShape` description: the axis names
and sizes that `models.config.resolve_spec` reads, with no group behind
it. Functions, not module constants: importing touches no device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh described by its axis sizes and names (the attributes of a
    `DeviceMesh` that the sharding rules read): the reference's
    `AbstractMesh`."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def _group_world() -> int:
    """The world size of the default process group (1 without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _device_mesh(shape, names):
    """A `DeviceMesh` of `shape` over the default group's ranks (CUDA
    devices under NCCL, the CPU otherwise)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's (16, 16) or (2, 16, 16) mesh over a process group
    of exactly that many ranks; raises ValueError otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, have = math.prod(shape), _group_world()
    if have != need:
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} "
            f"needs {need} devices, one process each in a torch.distributed "
            f"group; this process sees {have}")
    return _device_mesh(shape, names)


def make_host_mesh(model_axis: int = 1):
    """(data, model) over the devices there are: the default process
    group's ranks as a `DeviceMesh` where one is up, else this one
    process's device, `MeshShape((1, 1))`."""
    world = _group_world()
    if world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"{world} devices there are")
    shape, names = (world // model_axis, model_axis), ("data", "model")
    if world == 1:
        return MeshShape(shape, names)
    return _device_mesh(shape, names)
