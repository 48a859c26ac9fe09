"""``convert.from_jax`` / ``to_numpy``: bf16 and fp32 leaves of a JAX
params pytree round-trip exactly, keeping their dtypes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models.lm import Model as JModel
from repro.sim.techniques import baselines as jax_baselines
from repro_torch import convert
from repro_torch.configs import PORTED


@pytest.mark.parametrize("jdt,tdt", [(jnp.bfloat16, torch.bfloat16),
                                     (jnp.float32, torch.float32)])
def test_leaves_round_trip_exactly(jdt, tdt):
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((5, 7), np.float32) * 100, jdt)
    tree = {"w": [np.asarray(a)], "x": {"y": np.asarray(a[0])}}
    got = convert.from_jax(tree, "cpu")
    assert got["w"][0].dtype == tdt and got["x"]["y"].dtype == tdt
    assert got["w"][0].is_contiguous()
    back = convert.to_numpy(got)
    assert back["w"][0].dtype == np.float32
    np.testing.assert_array_equal(back["w"][0], np.asarray(a, np.float32))
    np.testing.assert_array_equal(back["x"]["y"],
                                  np.asarray(a[0], np.float32))


def _converts_leaf_for_leaf(arch):
    """Every leaf keeps its JAX dtype and round-trips exactly; returns
    the port's params."""
    jp = JModel(get_reduced(arch)).init(jax.random.PRNGKey(0))
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(leaves) == len(jax.tree_util.tree_leaves(tp))
    back = convert.to_numpy(tp)
    for (path, want), got, t in zip(leaves, jax.tree_util.tree_leaves(back),
                                    jax.tree_util.tree_leaves(tp)):
        assert str(t.dtype).split(".")[-1] == str(want.dtype), path
        np.testing.assert_array_equal(got, np.asarray(want, np.float32),
                                      err_msg=str(path))
    return tp


def test_lm_params_convert_leaf_for_leaf():
    """The LM's bf16 matrices stay bf16, its fp32 norms stay fp32."""
    tp = _converts_leaf_for_leaf("yi-6b")
    assert tp["g0"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["g0"]["ln1"]["w"].dtype == torch.float32


@pytest.mark.parametrize("arch", [a for a in PORTED if a != "yi-6b"])
def test_every_ported_arch_converts_leaf_for_leaf(arch):
    """The other ported archs (yi-6b is the test above); the MoE router
    stays fp32 beside bf16 experts, and the Mamba layer's fp32 leaves
    (dt_bias, a_log, skip) beside bf16 matrices."""
    tp = _converts_leaf_for_leaf(arch)
    if "moe" in tp["g0"]:
        assert tp["g0"]["moe"]["router"].dtype == torch.float32
        assert tp["g0"]["moe"]["wg"].dtype == torch.bfloat16
    if "mamba" in tp["g0"]:
        mb = tp["g0"]["mamba"]
        assert {k for k, v in mb.items() if v.dtype == torch.float32} == \
            {"dt_bias", "a_log", "skip"}
        assert mb["in_proj"].dtype == torch.bfloat16


def test_leaves_follow_jax_order_and_unflatten_inverts_them():
    """``leaves`` flattens in ``jax.tree_util.tree_leaves`` order (dict
    keys sorted) whatever the dict's insertion order; ``unflatten`` puts
    values back leaf for leaf and keeps the tree's own key order."""
    tree = {"z": np.float32(0), "a": [np.float32(1), {"y": np.float32(2),
                                                      "b": np.float32(3)}],
            "m": {"k": np.float32(4)}}
    tp = convert.from_jax(tree, "cpu")
    got = [float(t) for t in convert.leaves(tp)]
    assert got == [float(x) for x in jax.tree_util.tree_leaves(tree)]
    back = convert.unflatten(tp, [t * 10 for t in convert.leaves(tp)])
    assert list(back) == ["z", "a", "m"]
    assert list(back["a"][1]) == ["y", "b"]
    assert [float(t) for t in convert.leaves(back)] == [10 * x for x in got]


def test_gru_params_carry_over_and_round_trip():
    """IGRU-SD's GRU pytree (``wx``, ``wh``, ``b``, ``head.w``,
    ``head.b``) converts leaf for leaf in fp32 and ``to_numpy`` gives it
    back exactly, in the JAX tree's structure."""
    jp = jax_baselines.gru_init(jax.random.PRNGKey(3), 3, 16)
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert set(tp) == {"wx", "wh", "b", "head"}
    assert set(tp["head"]) == {"w", "b"}
    assert [tuple(t.shape) for t in convert.leaves(tp)] == [
        (48,), (1,), (16, 1), (16, 48), (3, 48)]
    assert all(t.dtype == torch.float32 for t in convert.leaves(tp))
    back = convert.to_numpy(tp)
    want_leaves, want_def = jax.tree_util.tree_flatten(jp)
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for got, want in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(got, np.asarray(want))
