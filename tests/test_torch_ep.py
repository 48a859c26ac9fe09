"""Expert parallelism in the port's MoE layer (``moe_apply(p_local, cfg, x,
EPContext)``) on 2 gloo ranks (``tests/torch_ranks.py``), against the
JAX package's EP branch and the port's own single-process layer.

Reduced qwen3-moe-30b-a3b and deepseek-v3-671b (its shared expert beside
the routed ones), fp32, training capacity and inference (dropless)
capacity.  The JAX reference is ``moe_apply(p_local, ...,
EPContext("model", 2))`` under ``jax.vmap(..., axis_name="model")`` over
the stacked expert slices (``axis_index`` is the slice, ``psum`` sums
the stacked axis).  Expert 0's router column is raised so that the
training capacity drops copies.  Both hold it to the fp32 bound of
``test_torch_moe.py`` (2e-5), as the port's single-process layer is
held; against the port's single-process layer the EP output is bit for
bit equal (top-2: a token's two copies add in one order either way, and
an invalid copy adds an exact zero).  The per-expert capacity is the
same with or without EP, so the same copies are dropped.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as JMoe
from repro_torch import configs
from repro_torch.models import moe as TMoe
from torch_ranks import spawn

ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v3-671b")
TOL = dict(rtol=2e-5, atol=2e-5)
WORLD = 2


def _case(arch, seed):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype="float32")
    tcfg = dataclasses.replace(configs.get_reduced(arch),
                               param_dtype="float32")
    jp = JMoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    # expert 0 favoured, so the training capacity drops copies
    jp["router"] = jp["router"].at[:, 0].add(1.0)
    p = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jp)
    x = (np.random.default_rng(seed).standard_normal(
        (4, 40, tcfg.d_model)) + 0.5).astype(np.float32)
    return jcfg, tcfg, p, x


def _jax_ep(jcfg, p, x, inference):
    e_loc = jcfg.n_experts // WORLD
    stacked = {k: (jnp.stack([v[r * e_loc:(r + 1) * e_loc]
                              for r in range(WORLD)])
                   if k in ("wg", "wu", "wd") else
                   jax.tree_util.tree_map(
                       lambda a: jnp.stack([a] * WORLD), v))
               for k, v in p.items()}
    ctx = JMoe.EPContext(axis="model", n_shards=WORLD)
    fn = jax.vmap(lambda pl: JMoe.moe_apply(pl, jcfg, jnp.asarray(x), ctx,
                                            inference=inference),
                  axis_name="model")
    return np.asarray(fn(stacked))


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    cases = [(arch, inference) for arch in ARCHS
             for inference in (False, True)]
    built = {arch: _case(arch, 3 + i) for i, arch in enumerate(ARCHS)}
    got = spawn("expert_parallel", WORLD, tmp_path_factory.mktemp("ep"),
                dict(cases=[(built[a][1], built[a][2], built[a][3], inf)
                            for a, inf in cases]), timeout=120)
    return {case: ([g[i] for g in got], built[case[0]])
            for i, case in enumerate(cases)}


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_moe_apply_equals_jax_ep(ep_runs, arch, inference):
    outs, (jcfg, _, p, x) = ep_runs[(arch, inference)]
    want = _jax_ep(jcfg, p, x, inference)
    for r in range(WORLD):
        np.testing.assert_allclose(outs[r], want[r], **TOL)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_moe_apply_equals_the_single_process_layer(ep_runs, arch,
                                                      inference):
    outs, (_, tcfg, p, x) = ep_runs[(arch, inference)]
    tp = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in p.items()}
    want = TMoe.moe_apply(tp, tcfg, torch.from_numpy(x),
                          inference=inference).numpy()
    for r in range(WORLD):
        np.testing.assert_array_equal(outs[r], want)
    if not inference:   # training capacity drops copies here
        _, idx = TMoe._route(tp["router"], torch.from_numpy(x).reshape(
            -1, tcfg.d_model), tcfg.top_k)
        counts = torch.bincount(idx.reshape(-1).long(),
                                minlength=tcfg.n_experts)
        cap = TMoe._capacity(x.shape[0] * x.shape[1], tcfg.n_experts,
                             tcfg.top_k, tcfg.capacity_factor)
        assert int((counts - cap).clamp_min(0).sum()) > 0


def test_grouped_ffn_invalid_copies_take_no_capacity():
    """JAX's ``valid`` semantics: an invalid copy sorts after every valid
    one, is never kept and takes no capacity from the valid copies."""
    rng = np.random.default_rng(0)
    t, k, e, d = 40, 2, 4, 8
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    valid = rng.random((t, k)) < 0.6
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.random((t, k)).astype(np.float32)
    wg, wu = (rng.standard_normal((e, d, 6)).astype(np.float32)
              for _ in range(2))
    wd = rng.standard_normal((e, 6, d)).astype(np.float32)
    for cap in (8, 16, 40):
        want = JMoe.grouped_ffn(*(jnp.asarray(a) for a in (
            x, idx, w, valid, wg, wu, wd)), cap)
        got = TMoe.grouped_ffn(*(torch.from_numpy(a) for a in (
            x, idx, w, wg, wu, wd)), cap, valid=torch.from_numpy(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
