"""The port's meta-device specs (``models/specs.py``) against the JAX
package's ``ShapeDtypeStruct`` specs, for every arch x shape cell.

- ``params_specs`` (``Model.init`` on "meta"): the real init's tree, its
  shapes and dtypes, at the reduced size (the full size does not fit a
  test), and JAX's ``eval_shape(model.init)`` at the full size.
- ``input_specs``: the batch of a train or prefill cell equal to JAX's;
  a decode cell's caches (derived from the layer groups, no prefill run)
  equal to JAX's ``eval_shape(model.prefill)`` caches, leaf for leaf.
"""
import functools

import jax
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.shapes import SHAPES as JSHAPES
from repro.models import specs as JS
from repro.models.lm import Model as JModel
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import leaves
from repro_torch.models import specs as S
from repro_torch.models.lm import Model

ARCHS = list_archs(assigned_only=False)


def _j(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in
            jax.tree_util.tree_leaves(tree)]


def _t(tree):
    return [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for x in leaves(tree)]


@functools.lru_cache(maxsize=None)
def _jmodel(arch):
    return JModel(jget(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_params_have_the_real_init_s_tree(arch):
    cfg = get_reduced(arch)
    real = Model(cfg).init(0, "cpu")
    fake = S.params_specs(Model(cfg))
    assert all(t.device.type == "meta" for t in leaves(fake))
    assert _t(fake) == _t(real)
    assert list(fake) == list(real)
    full = S.params_specs(Model(get_config(arch)))
    assert _t(full) == _j(JS.params_specs(_jmodel(arch)))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch, shape):
    got = S.input_specs(Model(get_config(arch)), SHAPES[shape])
    want = JS.input_specs(_jmodel(arch), JSHAPES[shape])
    assert sorted(got) == sorted(want)
    for key in want:
        assert _t(got[key]) == _j(want[key]), key
    if SHAPES[shape].kind == "decode":
        assert len(got["caches"]) == len(want["caches"])
        assert [sorted(c) for c in got["caches"]] == \
            [sorted(c) for c in want["caches"]]


@pytest.mark.parametrize("with_labels", [True, False])
def test_batch_specs_equal_jax(with_labels):
    for arch in ARCHS:
        for b, s in ((1, 300), (8, 4096)):
            got = S.batch_specs(get_config(arch), b, s, with_labels)
            want = JS.batch_specs(jget(arch), b, s, with_labels)
            assert sorted(got) == sorted(want)
            assert _t(got) == _j(want), arch
            assert all(t.device.type == "meta" for t in got.values())


def test_the_meta_init_allocates_nothing():
    """deepseek-v3 at full size (671 B params) builds in seconds on the
    meta device."""
    params = S.params_specs(Model(get_config("deepseek-v3-671b")))
    n = sum(t.numel() for t in leaves(params))
    assert n == get_config("deepseek-v3-671b").param_count() or n > 6e11
    assert all(t.device == torch.device("meta") for t in leaves(params))
