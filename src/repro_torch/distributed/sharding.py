"""Sharding rules: param-tree paths -> partition specs on a mesh, and the
DTensor placements and shard shapes they give.

A copy of the JAX package's ``distributed/sharding.py`` rules:
  * TP over "model": attention head projections, FFN hidden, vocab head,
    MoE experts (EP), mamba inner channels.
  * FSDP (ZeRO-3) over "data": every large matrix additionally sharded on
    a non-TP dimension where that dimension divides evenly (an embed
    table of an odd vocab simply stays replicated along that axis).
  * "pod" stays pure data-parallel (batch), so the cross-pod traffic is a
    single gradient reduce.

A spec is a tuple with one entry per dimension, as a JAX
``PartitionSpec``: ``None`` (not sharded), an axis name, or a tuple of
axis names (sharded over their product, the first the major).  Rules
name the trailing dims; leading layer-stack dims stay ``None``.
Norms, biases and scalars get ``()``, replicated, as JAX's ``P()``.
The quirks stay: FSDP only where the dim divides; experts detected by an
enclosing ``moe`` key and not ``shared``; MLA's ``wkv_a`` with no TP dim.

Meshes are read only through their axis names and sizes
(``launch.mesh.axes``), so a shape-only ``MeshShape``, a JAX-like
namespace or a torch ``DeviceMesh`` all serve.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.launch.mesh import axes as mesh_axes

MODEL_AXIS = "model"
DATA_AXIS = "data"

# rules: leaf-name -> (tp_dim_from_right, fsdp_dim_from_right) or None
# dims are negative indices into the array shape (right-aligned)
_RULES: dict[str, tuple[int | None, int | None]] = {
    # attention
    "wq": (-1, -2), "wk": (-1, -2), "wv": (-1, -2), "wo": (-2, -1),
    # MLA
    "wq_a": (-1, -2), "wq_b": (-1, -2), "wkv_a": (None, -2),
    "wkv_b": (-1, -2),
    # mlp
    "wg": (-1, -2), "wu": (-1, -2), "wd": (-2, -1),
    # embedding / head
    "embed": (-1, -2), "head": (-1, -2),
    # mamba
    "in_proj": (-1, -2), "conv_w": (-1, None), "conv_b": (-1, None),
    "x_proj": (-2, -1), "dt_proj": (-1, -2), "dt_bias": (-1, None),
    "a_log": (-2, None), "skip": (-1, None),
    "out_proj": (-2, -1),
    # router: replicated
    "router": (None, None),
}

# MoE expert tensors: expert dim is third-from-right -> EP over model
_EXPERT_LEAVES = {"wg", "wu", "wd"}


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path_names, leaf)`` over a tree of dicts and lists (a list's
    entries named by their index, as ``jax.tree_util`` paths print)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(list(path), tree)


def is_expert_leaf(path_names) -> bool:
    """An MoE expert stack (..., E, d, f) or (..., E, f, d): EP on E."""
    return (path_names[-1] in _EXPERT_LEAVES and "moe" in path_names
            and "shared" not in path_names)


def _spec_for(path_names: list[str], shape: tuple, mesh,
              fsdp: bool = True, tp: bool = True,
              fsdp_axes: tuple | None = None) -> tuple:
    name = path_names[-1]
    nd = len(shape)
    ax = mesh_axes(mesh)
    spec: list = [None] * nd
    n_model = math.prod(ax[a] for a in ax if a == MODEL_AXIS) if tp else 1
    fsdp_axes = fsdp_axes or (DATA_AXIS,)
    n_data = math.prod(ax[a] for a in fsdp_axes)
    fsdp_spec = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    if is_expert_leaf(path_names):
        # (..., E, d, f) or (..., E, f, d): EP on E; FSDP on d if divisible
        spec[nd - 3] = MODEL_AXIS
        d_dim = nd - 2 if name in ("wg", "wu") else nd - 1
        if fsdp and shape[d_dim] % n_data == 0:
            spec[d_dim] = fsdp_spec
        return tuple(spec)
    rule = _RULES.get(name)
    if rule is None:
        return ()  # norms, biases, scalars: replicated
    tdim, fdim = rule
    if tp and tdim is not None and shape[nd + tdim] % n_model == 0:
        spec[nd + tdim] = MODEL_AXIS
    if fsdp and fdim is not None and nd + fdim >= 0 \
            and shape[nd + fdim] % n_data == 0 \
            and spec[nd + fdim] is None:
        spec[nd + fdim] = fsdp_spec
    return tuple(spec)


def param_specs(params: Any, mesh, fsdp: bool = True, tp: bool = True,
                fsdp_axes: tuple | None = None) -> Any:
    """Spec tree matching ``params`` (tensors of any device, meta too).

    Layouts:
      tp=True,  fsdp=True   ZeRO-3 + TP (default; big MoE)
      tp=True,  fsdp=False  pure TP (state fits n_model shards)
      tp=False, fsdp=True, fsdp_axes=("data","model")
                            pure ZeRO-3 over the whole pod — no TP
                            activation all-reduces at all; best for dense
                            archs whose sharded state fits (the model axis
                            carries FSDP+batch instead of tensor splits)."""
    return tree_map_with_path(
        lambda path, leaf: _spec_for(path, tuple(leaf.shape), mesh,
                                     fsdp=fsdp, tp=tp, fsdp_axes=fsdp_axes),
        params)


def dp_axes(mesh) -> tuple:
    """Batch-sharding axes: ('pod', 'data') when the pod axis exists."""
    ax = mesh_axes(mesh)
    return tuple(a for a in ("pod", DATA_AXIS) if a in ax)


def _dp_if_divisible(dim: int, mesh) -> Any:
    """dp axes (possibly a prefix of them) that evenly divide ``dim``: a
    tuple of two or more, one axis as its name (as a JAX
    ``PartitionSpec`` normalises a 1-tuple), or None."""
    ax = mesh_axes(mesh)
    out = []
    prod = 1
    for a in dp_axes(mesh):
        if dim % (prod * ax[a]) == 0:
            out.append(a)
            prod *= ax[a]
    if not out:
        return None
    return tuple(out) if len(out) > 1 else out[0]


def batch_specs_tree(batch: Any, mesh) -> Any:
    """Shard the leading (batch) dim of every batch leaf over dp axes
    (skipping axes that don't divide — e.g. global_batch=1 decode)."""
    return tree_map_with_path(
        lambda path, leaf: (_dp_if_divisible(leaf.shape[0], mesh),
                            *([None] * (len(leaf.shape) - 1))), batch)


def cache_specs_tree(caches: Any, mesh, seq_axis_sharding: bool = True
                     ) -> Any:
    """KV-cache sharding for serving.

    Default: batch over dp axes and *sequence* over the model axis
    (sequence-parallel flash-decode — the right layout when n_kv_heads <
    model-axis size, which holds for most assigned archs).  Mamba
    recurrent state h (L, B, Di, N) shards Di over model.
    """
    n_model = mesh_axes(mesh).get(MODEL_AXIS, 1)

    def f(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: list = [None] * nd
        if name in ("k", "v"):            # (L, B, Hkv, S, hd)
            spec[nd - 4] = _dp_if_divisible(shape[nd - 4], mesh)
            if seq_axis_sharding and shape[nd - 2] % n_model == 0:
                spec[nd - 2] = MODEL_AXIS
            elif shape[nd - 3] % n_model == 0:
                spec[nd - 3] = MODEL_AXIS  # fall back to kv-head sharding
        elif name in ("c_kv", "k_rope"):  # (L, B, S, d) MLA latents
            spec[nd - 3] = _dp_if_divisible(shape[nd - 3], mesh)
            if seq_axis_sharding and shape[nd - 2] % n_model == 0:
                spec[nd - 2] = MODEL_AXIS
        elif name == "h":                 # (L, B, Di, N) mamba state
            spec[nd - 3] = _dp_if_divisible(shape[nd - 3], mesh)
            if shape[nd - 2] % n_model == 0:
                spec[nd - 2] = MODEL_AXIS
        elif name == "conv":              # (L, B, K-1, Di)
            spec[nd - 3] = _dp_if_divisible(shape[nd - 3], mesh)
            if shape[nd - 1] % n_model == 0:
                spec[nd - 1] = MODEL_AXIS
        elif name == "enc":               # (B, S_enc, d) encoder states
            spec[0] = _dp_if_divisible(shape[0], mesh)
        return tuple(spec)

    return tree_map_with_path(f, caches)


# ------------------------- placements and shard shapes ----------------------


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec: tuple, mesh_shape) -> tuple:
    """One device's block of a ``shape`` array under ``spec``: each dim
    divided (rounded up, as an uneven split pads) by the product of the
    sizes of the axes sharding it.  ``mesh_shape``: a mesh or its
    {axis: size} mapping."""
    ax = mesh_shape if isinstance(mesh_shape, dict) else mesh_axes(
        mesh_shape)
    out = list(shape)
    for dim, entry in enumerate(spec):
        k = math.prod(ax[a] for a in _entry_axes(entry))
        out[dim] = -(-out[dim] // k)
    return tuple(out)


def shard_numel(shape, spec: tuple, mesh_shape) -> int:
    return math.prod(shard_shape(shape, spec, mesh_shape))


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (one per mesh dim, in the
    mesh's order): ``Shard(d)`` on each mesh dim that shards tensor dim
    d, ``Replicate()`` elsewhere.  Where a tuple of axes shards one dim,
    DTensor splits in mesh-dim order, so the tuple must list them in the
    mesh's order (every rule here does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        ax = _entry_axes(entry)
        pos = [names.index(a) for a in ax]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: axes {ax} out of the mesh's "
                             f"order {names}")
        for p in pos:
            out[p] = Shard(dim)
    return tuple(out)


def local_slices(shape, spec: tuple, mesh, coord) -> tuple:
    """The index of the block of a ``shape`` array that the device at mesh
    coordinate ``coord`` (one index per mesh dim) holds under ``spec``,
    as a tuple of slices (DTensor's blocks for even splits)."""
    names = list(mesh_axes(mesh))
    sizes = mesh_axes(mesh)
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        idx, k = 0, 1
        for a in _entry_axes(entry):
            idx = idx * sizes[a] + coord[names.index(a)]
            k *= sizes[a]
        if n % k:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {k} under {spec}")
        step = n // k
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


# ----------------------------- DTensor trees --------------------------------


def coordinate(mesh) -> tuple:
    """This process's coordinate on a torch ``DeviceMesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this process is not in the mesh")
    return tuple(coord)


def shard(full, spec: tuple, mesh):
    """``full`` (the same tensor on every process) as a DTensor on
    ``mesh`` under ``spec``: each process keeps its own block, cut
    locally (no collective)."""
    from torch.distributed.tensor import DTensor
    local = full[local_slices(full.shape, spec, mesh, coordinate(mesh))]
    return DTensor.from_local(local.contiguous(), mesh,
                              placements(spec, mesh), run_check=False,
                              shape=full.shape, stride=full.stride())


def shard_tree(tree, specs, mesh):
    """Every leaf of ``tree`` sharded by the matching spec of ``specs``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_tree(v, s, mesh) for v, s in zip(tree, specs)]
    return shard(tree, specs, mesh)


def full_tree(tree):
    """Every DTensor leaf gathered to the whole tensor (a plain tensor on
    every process); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [full_tree(v) for v in tree]
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def leaf_paths(tree, path: tuple = ()) -> list:
    """The path names of every leaf in ``convert.leaves`` order (dict
    keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, path + (str(i),))]
    return [list(path)]


def spec_leaves(specs) -> list:
    """The specs of a spec tree (tuples are its leaves) in
    ``convert.leaves`` order."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]
