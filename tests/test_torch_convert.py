"""``convert.from_jax`` / ``to_numpy``: bf16 and fp32 leaves of a JAX
params pytree round-trip exactly, keeping their dtypes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models.lm import Model as JModel
from repro_torch import convert


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


def test_lm_params_convert_leaf_for_leaf():
    """The LM's bf16 matrices stay bf16, its fp32 norms stay fp32."""
    jp = JModel(get_reduced("yi-6b")).init(jax.random.PRNGKey(0))
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tp["g0"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["g0"]["ln1"]["w"].dtype == torch.float32
    back = convert.to_numpy(tp)
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32),
                                      err_msg=str(path))
