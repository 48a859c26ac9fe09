"""The port's sharding rules (``distributed/sharding.py``) against the JAX
package's, leaf for leaf, for every arch of the registry at full size.

JAX's ``param_specs`` / ``cache_specs_tree`` / ``batch_specs_tree`` read
only a mesh's ``shape`` and ``axis_names``, so a ``SimpleNamespace``
stands in for the production meshes (no 256 devices needed), and JAX's
params and caches are its ``eval_shape`` stand-ins (``models/specs.py``);
the port's are meta tensors.  A JAX ``PartitionSpec`` compares as the
tuple of its entries.  Meshes: (16, 16), (2, 16, 16), (4, 2), (8, 1);
layouts: the default, ``fsdp=False``, and ``tp=False,
fsdp_axes=("data", "model")``.
"""
import functools
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget
from repro.configs.shapes import SHAPES as JSHAPES
from repro.distributed import sharding as JSh
from repro.models import specs as JS
from repro.models.lm import Model as JModel
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import leaves
from repro_torch.distributed import sharding as Sh
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import specs as S
from repro_torch.models.lm import Model

ARCHS = list_archs(assigned_only=False)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}
LAYOUTS = [{}, {"fsdp": False},
           {"tp": False, "fsdp_axes": ("data", "model")}]


def _jmesh(name):
    shape, names = MESHES[name]
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


def _mesh(name):
    return MeshShape.of(*MESHES[name])


def _jspecs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _jpaths(tree):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return JS.params_specs(JModel(jget(arch)))


@functools.lru_cache(maxsize=None)
def _params(arch):
    return S.params_specs(Model(get_config(arch)))


@functools.lru_cache(maxsize=None)
def _jcaches(arch, shape):
    return JS.input_specs(JModel(jget(arch)), JSHAPES[shape])["caches"]


def _decode_shapes(arch):
    return ["decode_32k"] + (["long_500k"] if get_config(arch).family in
                             ("ssm", "hybrid") else [])


def test_production_meshes_are_jax_s():
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        want = MESHES["2x16x16" if multi else "16x16"]
        assert (tuple(m.shape.values()), m.axis_names) == want
        assert m.size == (512 if multi else 256)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, mesh):
    jp, tp = _jparams(arch), _params(arch)
    paths = _jpaths(jp)
    assert len(paths) == len(leaves(tp))
    for kw in LAYOUTS:
        want = _jspecs(JSh.param_specs(jp, _jmesh(mesh), **kw))
        got = Sh.spec_leaves(Sh.param_specs(tp, _mesh(mesh), **kw))
        bad = [(p, g, w) for p, g, w in zip(paths, got, want) if g != w]
        assert len(got) == len(want) and not bad, (kw, bad[:5])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, mesh):
    model = Model(get_config(arch))
    for shape in _decode_shapes(arch):
        sp = SHAPES[shape]
        jc = _jcaches(arch, shape)
        tc = S.cache_specs(model, sp.global_batch, sp.seq_len)
        for seq in (True, False):
            want = _jspecs(JSh.cache_specs_tree(jc, _jmesh(mesh),
                                                seq_axis_sharding=seq))
            got = Sh.spec_leaves(Sh.cache_specs_tree(
                tc, _mesh(mesh), seq_axis_sharding=seq))
            assert got == want, (shape, seq, got, want)


@pytest.mark.parametrize("batch", [1, 8, 256])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_equal_jax(mesh, batch):
    for arch in ARCHS:
        jb = JS.batch_specs(jget(arch), batch, 4096, True)
        tb = S.batch_specs(get_config(arch), batch, 4096, True)
        want = _jspecs(JSh.batch_specs_tree(jb, _jmesh(mesh)))
        got = Sh.spec_leaves(Sh.batch_specs_tree(tb, _mesh(mesh)))
        assert got == want, (arch, got, want)
    assert Sh.dp_axes(_mesh(mesh)) == JSh.dp_axes(_jmesh(mesh))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_shapes_and_placements(mesh):
    """A block is the shape over the axes' sizes (rounded up); the
    placements shard each mesh dim's tensor dim, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    m = _mesh(mesh)
    ax = m.shape
    spec = (None, "model", ("data",) if "pod" not in ax else
            ("pod", "data"))
    shape = (3, 32, 64)
    dp = ax["data"] * ax.get("pod", 1)
    assert Sh.shard_shape(shape, spec, m) == (3, 32 // ax["model"],
                                              -(-64 // dp))
    names = list(ax)
    want = [Replicate()] * len(names)
    want[names.index("model")] = Shard(1)
    want[names.index("data")] = Shard(2)
    if "pod" in ax:
        want[names.index("pod")] = Shard(2)
    assert list(Sh.placements(spec, m)) == want
    with pytest.raises(ValueError):
        Sh.placements((("model", "data"),), m)
