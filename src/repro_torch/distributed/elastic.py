"""Elastic scaling: rebuild the mesh after a host is lost and reshard
state (the JAX package's ``distributed/elastic.py``).

Protocol (the 're-run' mitigation mapped to pods):
  1. a host is declared failed (hardware fault or START chronic-straggler
     eviction);
  2. the survivors agree on a new rank set (here: the lost ranks are
     dropped, the survivors kept in order);
  3. a new mesh is built with the largest (data', model) grid that fits;
  4. params and optimizer state are restored from the latest checkpoint
     onto the new mesh (``train.checkpoint.restore(..., mesh=, specs=)``
     re-shards), or moved directly by :func:`reshard`;
  5. the data pipeline re-derives its shards from the new topology
     (``SyntheticLM`` is stateless per (seed, step, shard)).

A mesh here is a torch ``DeviceMesh`` over the default process group, or
a :class:`RankGrid` (ranks and axis names, no process group) to plan one.
Building a ``DeviceMesh`` makes its sub-groups with ``new_group``, a
collective over the default group: every process of that group calls
:func:`remesh`, including those left out of the new grid (they get a mesh
in which they have no coordinate, and do not hang).  A process that is
really gone needs a new default group first (a launcher's elastic
restart), which this module does not make.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.distributed import sharding as Sh


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """A (data, model) grid of process ranks with no process group."""

    ranks: np.ndarray
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))


@dataclasses.dataclass
class ElasticState:
    mesh: Any
    generation: int = 0
    failed_devices: tuple = ()


def largest_grid(n_devices: int, model_parallel: int) -> tuple[int, int]:
    """Largest (data, model) grid with the required model parallelism."""
    if n_devices < model_parallel:
        raise ValueError(
            f"need >= {model_parallel} devices, have {n_devices}")
    return n_devices // model_parallel, model_parallel


def mesh_ranks(mesh) -> np.ndarray:
    """The ranks of a ``DeviceMesh`` or a :class:`RankGrid`, in grid
    order."""
    if isinstance(mesh, RankGrid):
        return mesh.ranks
    return mesh.mesh.cpu().numpy()


def remesh(state: ElasticState, lost: Sequence[int],
           model_parallel: int | None = None) -> ElasticState:
    """Drop the ``lost`` ranks and build the next-generation mesh: the
    survivors in order, the largest (data, model) grid they fill."""
    old = mesh_ranks(state.mesh).flatten().tolist()
    gone = set(int(r) for r in lost)
    keep = [r for r in old if r not in gone]
    mp = model_parallel or Sh.mesh_axes(state.mesh).get("model", 1)
    n_data, n_model = largest_grid(len(keep), mp)
    grid = np.array(keep[:n_data * n_model]).reshape(n_data, n_model)
    if isinstance(state.mesh, RankGrid):
        mesh = RankGrid(grid)
    else:
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh(state.mesh.device_type, torch.as_tensor(grid),
                          mesh_dim_names=("data", "model"))
    return ElasticState(mesh=mesh, generation=state.generation + 1,
                        failed_devices=state.failed_devices + tuple(lost))


def reshard(tree: Any, old_mesh, new_mesh, spec_fn) -> Any:
    """Move a tree of DTensors (or plain tensors, the same on every
    process) onto ``new_mesh``: each leaf gathered whole, then every
    process of the new mesh keeps its block under ``spec_fn(tree,
    new_mesh)``'s spec (the checkpoint-free path for small state; large
    state goes through ``train.checkpoint.restore``).  Every process of
    the old mesh takes part in the gathers; a process outside the new
    mesh gets None."""
    del old_mesh   # the leaves carry their own placements
    host = Sh.full_tree(tree)
    if new_mesh.get_coordinate() is None:
        return None
    return Sh.shard_tree(host, spec_fn(host, new_mesh), new_mesh)
