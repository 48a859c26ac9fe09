"""Meshes: the production mesh as a shape-only description, and a host
mesh over the current process group.

The JAX package's ``launch/mesh.py``.  Single pod: (data=16, model=16) =
256 devices.  Multi-pod: (pod=2, data=16, model=16) = 512; the pod axis
carries only batch parallelism (the gradient reduce crosses the
inter-pod link once per step).

``make_production_mesh`` returns a :class:`MeshShape`, ``shape`` (axis ->
size, in axis order) and ``axis_names`` as JAX's ``Mesh`` has them and
nothing more: the sharding rules, the meta-device specs and the dry run
read only those, so no process group of 256 is needed to plan for one.
``make_host_mesh`` builds a torch ``DeviceMesh`` over the process group
this process has joined (``torch.distributed.init_process_group``).
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

DATA_MODEL = ("data", "model")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and sizes, no devices: ``shape`` maps each axis name
    to its size in axis order, as a JAX mesh's ``shape`` does."""

    shape: dict
    axis_names: tuple

    @classmethod
    def of(cls, sizes, names) -> "MeshShape":
        return cls(dict(zip(names, (int(s) for s in sizes))), tuple(names))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod",) + DATA_MODEL if multi_pod else DATA_MODEL
    return MeshShape.of(shape, axes)


def make_host_mesh(n_data: int | None = None, n_model: int = 1,
                   device_type: str = "cuda"):
    """A (data, model) ``DeviceMesh`` over the current process group's
    ranks in order (``n_data`` defaults to the world size over
    ``n_model``); ``device_type`` "cuda" (the default) or "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    n_data = n_data or max(n // n_model, 1)
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=DATA_MODEL)


def axes(mesh) -> dict:
    """{axis name: size} in axis order, of a :class:`MeshShape`, a JAX-like
    mesh (``shape`` a mapping, ``axis_names``) or a torch ``DeviceMesh``
    (``mesh_dim_names``, ``shape`` a tuple)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}
