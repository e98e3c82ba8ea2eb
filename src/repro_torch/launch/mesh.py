"""Training meshes: their axis names and sizes.

Port of `repro/launch/mesh.py`. The reference's production meshes:
  - single pod:  (16, 16)    axes ("data", "model")          = 256 devices
  - multi pod:   (2, 16, 16) axes ("pod", "data", "model")   = 512 devices

Nothing tells a process of a cluster but its launcher: under
``torchrun`` `start_group` starts `torch.distributed` from the
environment torchrun sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``) and picks the rank's device; a caller
may also start the group itself (``init_process_group`` with its
address, world size and rank, as the sharded treecode's `GroupRanks`
asks). A mesh is built over that group's ranks. One process without a
group is one device, and its mesh is a `MeshShape` description: the axis
names and sizes that `models.config.resolve_spec` reads, with no group
behind it. Functions, not module constants: importing touches no device.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple


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


def start_group(device: str = "cuda", backend: Optional[str] = None):
    """This rank's device; under torchrun (``WORLD_SIZE`` > 1) the default
    process group is started first from its environment, unless one is up.

    `backend` defaults to NCCL for a CUDA device and gloo for the CPU.
    Under NCCL rank r trains on ``cuda:LOCAL_RANK``, one card a rank: more
    ranks on this host than cards raise ValueError. Under gloo the ranks
    share the cards in turn (all of them ``cuda:0`` on one card), which
    only an explicit ``backend="gloo"`` asks for. ``device="cpu"`` puts
    every rank on the CPU. Nothing falls back to the CPU or to one rank.
    """
    import torch
    import torch.distributed as dist
    kind = torch.device(device).type
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if backend == "nccl" and kind != "cuda":
        raise ValueError(f"NCCL needs CUDA devices, not {device!r}; pass "
                         f"--dist-backend gloo")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        from repro_torch.core.api import resolve_device
        return resolve_device(device)
    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    if kind == "cuda":
        cards = torch.cuda.device_count()
        here = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and here > cards:
            raise ValueError(
                f"{here} ranks on this host and {cards} CUDA device(s): "
                f"NCCL takes one card a rank; pass --dist-backend gloo to "
                f"let the ranks share the cards")
        if not cards:
            raise RuntimeError("no CUDA device; pass --device cpu")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
        torch.cuda.init()       # DeviceMesh then keeps this device
    else:
        dev = torch.device(kind)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return dev


def _device_mesh(shape, names, device_type=None):
    """A `DeviceMesh` of `shape` over the default group's ranks, on
    `device_type` (default: CUDA devices under NCCL, the CPU otherwise)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    kind = device_type or ("cuda" if dist.get_backend() == "nccl"
                           else "cpu")
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The reference's (16, 16) or (2, 16, 16) mesh over a process group
    of exactly that many ranks; raises ValueError otherwise.
    `device_type` as `_device_mesh`'s."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, have = math.prod(shape), _group_world()
    if have != need:
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} "
            f"needs {need} devices, one process each in a torch.distributed "
            f"group; this process sees {have}")
    return _device_mesh(shape, names, device_type)


def make_host_mesh(model_axis: int = 1, device_type: Optional[str] = None):
    """(data, model) over the devices there are: the default process
    group's ranks as a `DeviceMesh` where one is up (on `device_type`,
    as `_device_mesh`'s), else this one process's device,
    `MeshShape((1, 1))`."""
    world = _group_world()
    if world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"{world} devices there are")
    shape, names = (world // model_axis, model_axis), ("data", "model")
    if world == 1:
        return MeshShape(shape, names)
    return _device_mesh(shape, names, device_type)
