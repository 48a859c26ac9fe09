"""The port's MoE layer (``models/moe.py``) against the JAX package's
``moe_apply`` on the CPU, at reduced qwen3-moe-30b-a3b (8 experts, top-2,
d_model 64), with weights from ``convert.from_jax`` and inputs from
numpy.  fp32 is held to 2e-5 against the compiled JAX layer; bf16 to the
kernel sweep's 2e-2 against the JAX layer run op by op
(``jax.disable_jit``), where its roundings fall where the port's do.

The inference dispatch (``inference=True``) is dropless up to 1024
tokens.  Above, copies past an expert's capacity are dropped: a router
skewed towards expert 0 makes that happen, and both layers drop the same
copies (read off ``grouped_ffn`` with every expert mapping 1 to silu(1)
and copy j weighted 2**j, so a token's output spells out which of its
copies were kept).  The training dispatch (``inference=False``, the
default in both) drops past ``_capacity(T, E, k, capacity_factor)`` at
every T, held the same way, and its gradients in the layer's params and
input against ``jax.grad`` (fp32, 1e-4 relative in norm; observed
<= 3e-7).  ``aux_load_balance_loss`` against JAX's within 1e-6 relative
(observed ~1e-7)."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as JMoe
from repro_torch import configs
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoe

ARCH = "qwen3-moe-30b-a3b"
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _jax_reference(dtype):
    return jax.disable_jit() if dtype == "bfloat16" \
        else contextlib.nullcontext()


def _layer(dtype, skew: float = 0.0):
    """Both configs and one converted MoE layer; ``skew`` is added to
    expert 0's router column."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), param_dtype=dtype)
    tcfg = dataclasses.replace(configs.get_reduced(ARCH), param_dtype=dtype)
    jp = JMoe.moe_init(jax.random.PRNGKey(7), jcfg)
    jp["router"] = jp["router"].at[:, 0].add(skew)
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _x(seed, shape, dtype, mean: float = 0.0):
    jdt = jnp.dtype(dtype)
    a = np.random.default_rng(seed).standard_normal(shape, np.float32)
    a = np.asarray(jnp.asarray(a + mean, jdt), np.float32)
    return jnp.asarray(a, jdt), torch.tensor(a, dtype=getattr(torch, dtype))


def _kept(grouped_ffn, idx, cap, n_experts, torch_side):
    """(T, k) bool: which copies ``grouped_ffn`` kept."""
    t, k = idx.shape
    x = np.ones((t, 1), np.float32)
    w = np.tile(2.0 ** np.arange(k, dtype=np.float32), (t, 1))
    ones = np.ones((n_experts, 1, 1), np.float32)
    if torch_side:
        x, w, ones = (torch.tensor(a) for a in (x, w, ones))
        out = grouped_ffn(x, torch.as_tensor(idx), w, ones, ones, ones, cap)
    else:
        out = grouped_ffn(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w),
                          jnp.ones((t, k), bool), ones, ones, ones, cap)
    bits = np.rint(_np(out)[:, 0] / float(jax.nn.silu(1.0))).astype(int)
    return (bits[:, None] >> np.arange(k)) & 1 == 1


@pytest.mark.parametrize("b,s", [(1, 1), (2, 1), (1, 12), (1, 300),
                                 (2, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(b, s, dtype):
    jcfg, tcfg, jp, tp = _layer(dtype)
    jx, tx = _x(b * s, (b, s, tcfg.d_model), dtype)
    with _jax_reference(dtype):
        want = JMoe.moe_apply(jp, jcfg, jx, inference=True)
    got = TMoe.moe_apply(tp, tcfg, tx, inference=True)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("t,cap", [(1100, 688), (1500, 944)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capacity_drops_the_same_copies(t, cap, dtype):
    """Over 1024 tokens, routed mostly to expert 0: the capacity is
    2.5 T k / E rounded up to 8."""
    jcfg, tcfg, jp, tp = _layer(dtype, skew=1.0)
    jx, tx = _x(5, (1, t, tcfg.d_model), dtype, mean=0.5)
    with _jax_reference(dtype):
        want = JMoe.moe_apply(jp, jcfg, jx, inference=True)
    got = TMoe.moe_apply(tp, tcfg, tx, inference=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])

    _, idx = TMoe._route(tp["router"], tx.reshape(t, -1), tcfg.top_k)
    _, jidx = JMoe._route(jp["router"], jx.reshape(t, -1), jcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert cap == TMoe._capacity(t, tcfg.n_experts, tcfg.top_k,
                                 2.0 * tcfg.capacity_factor)
    kept = _kept(TMoe.grouped_ffn, idx.numpy(), cap, tcfg.n_experts, True)
    jkept = _kept(JMoe.grouped_ffn, np.asarray(jidx), cap, jcfg.n_experts,
                  False)
    counts = np.bincount(idx.numpy().ravel(), minlength=tcfg.n_experts)
    assert (~kept).sum() == np.maximum(counts - cap, 0).sum() > 0
    np.testing.assert_array_equal(kept, jkept)


def test_unported_moe_options_name_their_roadmap_item():
    """Expert parallelism still names its ROADMAP.md item; the shared
    experts (item 4.5b) are ported: reduced deepseek-v3's layer (one
    shared SwiGLU of 32 beside 8 routed experts, top-2) against JAX's
    ``moe_apply`` in fp32 (2e-5), serving and training dispatch, and the
    shared SwiGLU's shape."""
    jcfg, tcfg, jp, tp = _layer("float32")
    x = torch.zeros(1, 2, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        TMoe.moe_apply(tp, tcfg, x, ep=object())
    jcfg = dataclasses.replace(jconfigs.get_reduced("deepseek-v3-671b"),
                               param_dtype="float32")
    tcfg = dataclasses.replace(configs.get_reduced("deepseek-v3-671b"),
                               param_dtype="float32")
    jsh = JMoe.moe_init(jax.random.PRNGKey(8), jcfg)
    tsh = convert.from_jax(jax.tree_util.tree_map(np.asarray, jsh), "cpu")
    assert tuple(tsh["shared"]["wg"].shape) == (tcfg.d_model,
                                                tcfg.expert_ff)
    assert set(TMoe.moe_init(torch.Generator().manual_seed(0), tcfg)) \
        == set(tsh) == {"router", "wg", "wu", "wd", "shared"}
    sx, tsx = _x(12, (2, 9, tcfg.d_model), "float32")
    for inference in (True, False):
        want = JMoe.moe_apply(jsh, jcfg, sx, inference=inference)
        got = TMoe.moe_apply(tsh, tcfg, tsx, inference=inference)
        np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    routed = TMoe.moe_apply({k: v for k, v in tsh.items() if k != "shared"},
                            tcfg, tsx, inference=False)
    np.testing.assert_allclose(
        _np(got - routed), _np(TL.mlp_apply(tsh["shared"], tsx)),
        rtol=1e-6, atol=1e-6)
    # the load-balance loss is ported: it matches JAX's
    jx, tx = _x(11, (2, 24, tcfg.d_model), "float32")
    want = float(JMoe.aux_load_balance_loss(jp, jcfg, jx))
    got = TMoe.aux_load_balance_loss(tp, tcfg, tx)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("t,cap", [(300, 96), (40, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_dispatch_drops_the_same_copies(t, cap, dtype):
    """``inference=False``: the capacity is 1.25 T k / E rounded up to 8
    at every T, and a router skewed towards expert 0 overflows it."""
    jcfg, tcfg, jp, tp = _layer(dtype, skew=1.0)
    jx, tx = _x(6, (1, t, tcfg.d_model), dtype, mean=0.5)
    with _jax_reference(dtype):
        want = JMoe.moe_apply(jp, jcfg, jx)
    got = TMoe.moe_apply(tp, tcfg, tx)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    assert cap == TMoe._capacity(t, tcfg.n_experts, tcfg.top_k,
                                 tcfg.capacity_factor)
    _, idx = TMoe._route(tp["router"], tx.reshape(t, -1), tcfg.top_k)
    _, jidx = JMoe._route(jp["router"], jx.reshape(t, -1), jcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    kept = _kept(TMoe.grouped_ffn, idx.numpy(), cap, tcfg.n_experts, True)
    jkept = _kept(JMoe.grouped_ffn, np.asarray(jidx), cap, jcfg.n_experts,
                  False)
    counts = np.bincount(idx.numpy().ravel(), minlength=tcfg.n_experts)
    assert (~kept).sum() == np.maximum(counts - cap, 0).sum() > 0
    np.testing.assert_array_equal(kept, jkept)


def test_training_dispatch_gradients_match_jax():
    """Gradients of sum(y * g) in the router, the experts and the input,
    through the router's autograd Function and the dropped copies."""
    jcfg, tcfg, jp, tp = _layer("float32", skew=1.0)
    jx, tx = _x(8, (2, 60, tcfg.d_model), "float32", mean=0.5)
    g = np.random.default_rng(9).standard_normal(tx.shape, np.float32)

    def jloss(p, x):
        return jnp.sum(JMoe.moe_apply(p, jcfg, x) * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    y = TMoe.moe_apply(tp, tcfg, x)
    names = sorted(tp)
    grads = torch.autograd.grad((y * torch.tensor(g)).sum(),
                                [tp[k] for k in names] + [x])
    for name, got, want in zip(names + ["x"], grads,
                               [jgp[k] for k in names] + [jgx]):
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(_np(got) - want) / np.linalg.norm(want)
        assert err <= 1e-4, (name, err)
