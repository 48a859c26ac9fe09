"""The port's Mamba-1 block and SSM training loss (``models/mamba.py``,
the ``ssm`` group of ``models/lm.py``) against the JAX package's, on the
CPU, at falcon-mamba-7b's reduced config, with weights from
``convert.from_jax`` and inputs from numpy.

fp32: ``mamba_apply`` within 1e-5 of the output's largest magnitude
(observed ~5e-7 relative in norm), the loss within 1e-5 relative
(observed ~2e-7) and every leaf's gradient within 1e-4 relative in norm
(observed ~2e-6), against ``jax.value_and_grad(model.loss_fn)``.

bf16, the config's own dtype, against the JAX model run op by op
(``jax.disable_jit``), where its bf16 roundings fall where the port's
do.  Not bit for bit: the scan sums its N products in another order (a
torch ``einsum`` against XLA's dot), so a rounding of y to bf16 can
land one bf16 ulp apart, and the backward's bf16 roundings follow each
framework's own transpose rules.  So ``mamba_apply`` is held to the
kernel sweep's bf16 2e-2 (observed: one ulp, 3.9e-3 at magnitude ~2),
the loss to 1e-5 relative (observed ~2e-7) and each leaf's gradient to
3e-2 relative in norm (observed <= 1.1e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba as JMb
from repro.models.lm import Model as JModel
from repro_torch import configs
from repro_torch import convert
from repro_torch.models import mamba as TMb
from repro_torch.models.lm import Model, layer
from repro_torch.train.trainer import value_and_grad

ARCH = "falcon-mamba-7b"
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run thousands of tiny ops, which
    threads do not speed up, and beside the suite's parallel workers
    extra threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(_np(got) - want) / np.linalg.norm(want))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    dtype = request.param
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), param_dtype=dtype)
    tcfg = dataclasses.replace(configs.get_reduced(ARCH), param_dtype=dtype)
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return dict(dtype=dtype, jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jp=jp,
                tp=tp)


def _batch(vocab, shape, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (shape[0],
                                                           shape[1] + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])})


def test_mamba_apply_matches(pair):
    dt, jcfg, tcfg = pair["dtype"], pair["jcfg"], pair["tcfg"]
    x = np.random.default_rng(2).standard_normal((2, 24, tcfg.d_model))
    jx = jnp.asarray(x, jcfg.dtype)
    tx = torch.tensor(x, dtype=torch.float32).to(tcfg.dtype)
    jl = jax.tree_util.tree_map(lambda a: a[0], pair["jp"]["g0"]["mamba"])
    tl = layer(pair["tp"]["g0"], 0)["mamba"]
    if dt == "float32":
        want = _np(JMb.mamba_apply(jl, jcfg, jx))
        atol = 1e-5 * np.abs(want).max()
        tol = dict(rtol=1e-5, atol=atol)
    else:
        with jax.disable_jit():
            want = _np(JMb.mamba_apply(jl, jcfg, jx))
        tol = dict(rtol=2e-2, atol=2e-2)
    got = TMb.mamba_apply(tl, tcfg, tx)
    assert got.dtype == tcfg.dtype
    np.testing.assert_allclose(_np(got), want, **tol)


def test_conv_and_ssm_inputs_match(pair):
    """The two steps before the scan, op for op: bit for bit in both
    dtypes (delta within one ulp of XLA's exp/log1p)."""
    jcfg, tcfg = pair["jcfg"], pair["tcfg"]
    x = np.random.default_rng(5).standard_normal((2, 11, tcfg.d_inner))
    jx = jnp.asarray(x, jcfg.dtype)
    tx = torch.tensor(x, dtype=torch.float32).to(tcfg.dtype)
    jl = jax.tree_util.tree_map(lambda a: a[1], pair["jp"]["g0"]["mamba"])
    tl = layer(pair["tp"]["g0"], 1)["mamba"]
    with jax.disable_jit():
        jc = JMb._conv1d_causal(jx, jl["conv_w"], jl["conv_b"])
        jd, jb, jcm = JMb._ssm_inputs(jl, jcfg, jx)
    tc = TMb._conv1d_causal(tx, tl["conv_w"], tl["conv_b"])
    td, tb, tcm = TMb._ssm_inputs(tl, tcfg, tx)
    np.testing.assert_array_equal(_np(tc), _np(jc))
    np.testing.assert_array_equal(_np(tb), _np(jb))
    np.testing.assert_array_equal(_np(tcm), _np(jcm))
    assert tb.is_contiguous() and tcm.is_contiguous()
    assert td.dtype == tcfg.dtype
    np.testing.assert_allclose(_np(td), _np(jd), rtol=1e-6 if
                               pair["dtype"] == "float32" else 8e-3, atol=0)


def test_loss_and_gradients_match(pair):
    dt, jm, tm = pair["dtype"], pair["jm"], pair["tm"]
    jb, tb = _batch(pair["tcfg"].vocab, (2, 8), seed=1)
    if dt == "float32":
        jloss, jg = jax.value_and_grad(jm.loss_fn)(pair["jp"], jb)
    else:
        with jax.disable_jit():
            jloss, jg = jax.value_and_grad(jm.loss_fn)(pair["jp"], jb)
    loss, grads = value_and_grad(tm, pair["tp"], tb)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    got = convert.to_numpy(grads)
    for path, w in want:
        g = got
        for k in path:
            g = g[k.key]
        assert _rel(g, w) <= GRAD_TOL[dt], (jax.tree_util.keystr(path),
                                            _rel(g, w))
    # gradients keep the params' dtypes
    for t, gt in zip(jax.tree_util.tree_leaves(pair["tp"]),
                     jax.tree_util.tree_leaves(grads)):
        assert gt.dtype == t.dtype and gt.shape == t.shape


def test_init_has_the_jax_tree():
    """Seeded init on the CPU: the JAX package's leaves, shapes and
    dtypes; the deterministic leaves (A's log, zeros, ones) agree."""
    cfg = configs.get_reduced(ARCH)
    tp = Model(cfg).init(0, "cpu")
    jp = JModel(jconfigs.get_reduced(ARCH)).init(jax.random.PRNGKey(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, j), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
        if path[-1].key in ("a_log", "conv_b", "dt_bias", "skip", "w"):
            # log(1..N) within an ulp of XLA's log
            np.testing.assert_allclose(_np(t), _np(j), rtol=2e-7, atol=0)
    assert torch.equal(tp["g0"]["mamba"]["a_log"][1, 5],
                       torch.log(torch.arange(1, cfg.ssm_state + 1.0)))


def test_falcon_mamba_is_the_published_shape():
    cfg = configs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state,
            cfg.ssm_conv, cfg.dt_rank, cfg.vocab, cfg.padded_vocab) == \
        (64, 4096, 8192, 16, 4, 256, 65024, 65536)
    assert round(cfg.param_count() / 1e9, 2) == 7.28
    assert [g.kind for g in Model(cfg).groups] == ["ssm"]
    assert cfg.param_count() == jconfigs.get_config(ARCH).param_count()


def test_ssm_serving_names_its_roadmap_item():
    cfg = configs.get_reduced(ARCH)
    model = Model(cfg)
    params = model.init(0, "cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md Queue 1 item 2.1"):
        model.prefill(params, {"tokens": toks})
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md Queue 1 item 2.1"):
        model.decode_step(params, [None], toks[:, :1], 4)


@pytest.mark.parametrize("arch,item", [("yi-6b", "2.2"),
                                       ("qwen3-moe-30b-a3b", "2.3")])
def test_training_the_attention_families_names_its_roadmap_item(arch, item):
    model = Model(configs.get_reduced(arch))
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md Queue 1 item {item}"):
        model.loss_fn({}, {"tokens": toks, "labels": toks})
