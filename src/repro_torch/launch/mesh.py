"""Production mesh descriptions, the port of ``repro.launch.mesh``.

Single pod: 16 x 16 = 256 chips, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 chips, axes (pod, data, model): the "pod"
axis is the slow interconnect across which data parallelism (optionally
with the int8 compressed gradient exchange) runs.

A mesh here is a :class:`MeshSpec`, a device-free description (axis names
and sizes), the counterpart of the JAX package's ``abstract_mesh``: the
sharding rules (``repro_torch.distributed.sharding``) are computed from it
alone.  :func:`device_mesh` turns one into a
``torch.distributed.device_mesh.DeviceMesh`` once a process group of
matching size exists.  Nothing here touches a device or a process group
when it is imported or when a description is made.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis names and sizes of a device mesh, in mesh order."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes "
                             f"{self.axis_sizes}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def abstract_mesh(axis_shapes: Sequence[int],
                  axis_names: Sequence[str]) -> MeshSpec:
    """A device-free mesh for sharding-rule logic and tests."""
    return MeshSpec(tuple(axis_names), tuple(int(n) for n in axis_shapes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def make_host_mesh(shape: Sequence[int], axes: Sequence[str]) -> MeshSpec:
    """Arbitrary small meshes (e.g. (2, 2) over four ranks)."""
    return abstract_mesh(shape, axes)


def device_mesh(mesh: MeshSpec, device_type: str = "cuda"):
    """``mesh`` as a ``DeviceMesh`` over the ranks of the default process
    group, rank ``r`` at the row-major position ``r``; the group's world
    size must equal the mesh's size."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialised process group "
                           "(repro_torch.distributed.process_group)")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"mesh {mesh.shape} has {mesh.size} positions; "
                         f"the process group has {dist.get_world_size()} "
                         "ranks")
    return DeviceMesh(device_type,
                      torch.arange(mesh.size).reshape(mesh.axis_sizes),
                      mesh_dim_names=mesh.axis_names)
