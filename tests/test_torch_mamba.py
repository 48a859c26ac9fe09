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

Serving (``mamba_prefill``, ``mamba_decode``, the ``ssm`` group's
``Model.prefill`` and ``decode_step``): fp32 against the compiled JAX
functions within the Tier-1 bound of ``tests/tolerance.py``, relative
1e-5 to each tensor's largest magnitude (the outputs' products sum in
another order; the states ``h`` and the conv window agree to an fp32
ulp); bf16 against JAX run op by op, the outputs within the sweep's
2e-2 and the fp32 state within 1e-5 of its largest magnitude.  The
prefill's caches carry between the packages both ways
(``convert.from_jax``, ``convert.to_numpy``).
"""
import contextlib
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
from repro_torch.serve.kv_cache import pad_to_length
from repro_torch.train.trainer import value_and_grad
from tolerance import TIER1_REL

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


def _to_scale(got, want, dtype, what):
    """fp32: Tier-1's relative bound against the tensor's largest
    magnitude; bf16 (the activations'): the sweep's 2e-2."""
    got, want = _np(got), _np(want)
    if dtype == "float32":
        err = np.abs(got.astype(np.float64) - want).max()
        assert err <= TIER1_REL * np.abs(want).max(), (what, err)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2,
                                   err_msg=what)


def _jax_ref(dtype):
    """Compiled for fp32, op by op for bf16 (see the module docstring)."""
    return jax.disable_jit() if dtype == "bfloat16" \
        else contextlib.nullcontext()


@pytest.mark.parametrize("ell", [11, 2])
def test_mamba_prefill_and_decode_match(pair, ell):
    """A prefill of ``ell`` tokens (2 < K - 1: the conv window is
    left-padded), then three decode steps, each against JAX's; the
    decode writes the state in place."""
    dt, jcfg, tcfg = pair["dtype"], pair["jcfg"], pair["tcfg"]
    x = np.random.default_rng(ell).standard_normal((2, ell + 3,
                                                    tcfg.d_model))
    jx = jnp.asarray(x, jcfg.dtype)
    tx = torch.tensor(np.asarray(jx, np.float32), dtype=tcfg.dtype)
    jl = jax.tree_util.tree_map(lambda a: a[0], pair["jp"]["g0"]["mamba"])
    tl = layer(pair["tp"]["g0"], 0)["mamba"]
    with _jax_ref(dt):
        jo, js = JMb.mamba_prefill(jl, jcfg, jx[:, :ell])
    to, ts = TMb.mamba_prefill(tl, tcfg, tx[:, :ell])
    assert to.dtype == tcfg.dtype and ts["h"].dtype == torch.float32
    assert ts["conv"].shape == (2, tcfg.ssm_conv - 1, tcfg.d_inner)
    _to_scale(to, jo, dt, "prefill out")
    _to_scale(ts["h"], js["h"], "float32", "prefill h")
    _to_scale(ts["conv"], js["conv"], dt, "prefill conv")
    for j in range(ell, ell + 3):
        with _jax_ref(dt):
            jo, js = JMb.mamba_decode(jl, jcfg, jx[:, j:j + 1], js)
        h = ts["h"]
        to, ts2 = TMb.mamba_decode(tl, tcfg, tx[:, j:j + 1], ts)
        assert ts2 is ts and ts["h"] is h        # written in place
        _to_scale(to, jo, dt, f"decode out {j}")
        _to_scale(ts["h"], js["h"], "float32", f"decode h {j}")
        _to_scale(ts["conv"], js["conv"], dt, f"decode conv {j}")


def test_ssm_serving_names_its_roadmap_item(pair):
    """SSM serving (ROADMAP.md Queue 1 item 2.1) is ported: the ``ssm``
    group's ``Model.prefill`` and teacher-forced ``decode_step``s against
    the JAX model's, logits and the layer-stacked caches, which convert
    between the packages both ways."""
    dt, jm, tm, jp, tp = (pair[k] for k in ("dtype", "jm", "tm", "jp",
                                             "tp"))
    cfg = pair["tcfg"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 12))
    with _jax_ref(dt):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert tl.shape == (2, 1, cfg.vocab) and tl.dtype == torch.float32
    assert tc[0]["h"].shape == (cfg.n_layers, 2, cfg.d_inner,
                                cfg.ssm_state)
    assert tc[0]["conv"].shape == (cfg.n_layers, 2, cfg.ssm_conv - 1,
                                   cfg.d_inner)
    _to_scale(tl, jl, dt, "prefill logits")
    _to_scale(tc[0]["h"], jc[0]["h"], "float32", "h")
    _to_scale(tc[0]["conv"], jc[0]["conv"], dt, "conv")
    # the caches convert both ways
    back = convert.from_jax(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    assert back[0]["conv"].dtype == cfg.dtype
    _to_scale(back[0]["h"], tc[0]["h"], "float32", "from_jax h")
    mine = convert.to_numpy(tc)
    _to_scale(mine[0]["conv"], jc[0]["conv"], dt, "to_numpy conv")
    # the engine pads the caches: the SSM state passes untouched
    padded = pad_to_length(tc, 64)
    assert padded[0]["h"] is tc[0]["h"] and padded[0]["conv"] is \
        tc[0]["conv"]
    for i in range(4):
        tok = np.argmax(_np(jl)[:, -1], -1)[:, None]
        with _jax_ref(dt):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(12 + i, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.as_tensor(tok), 12 + i)
        _to_scale(tl, jl, dt, f"decode logits {i}")
        _to_scale(tc[0]["h"], jc[0]["h"], "float32", f"decode h {i}")


@pytest.mark.parametrize("arch,item", [("yi-6b", "2.2"),
                                       ("qwen3-moe-30b-a3b", "2.3")])
def test_training_the_attention_families_names_its_roadmap_item(arch, item):
    """Training the dense (ROADMAP.md Queue 1 item 2.2) and MoE (item 2.3)
    families is ported: ``loss_fn`` and its gradients at the reduced
    config in fp32 against ``jax.value_and_grad`` of the JAX model's,
    the loss within 1e-5 relative and every leaf's gradient within 1e-4
    relative in norm (``tests/test_torch_lm_train.py`` holds more
    shapes, bf16 and demo-100m)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype="float32")
    tcfg = dataclasses.replace(configs.get_reduced(arch),
                               param_dtype="float32")
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jb, tb = _batch(tcfg.vocab, (2, 12), seed=4)
    jloss, jg = jax.value_and_grad(jm.loss_fn)(jp, jb)
    loss, grads = value_and_grad(tm, tp, tb)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    got = convert.to_numpy(grads)
    for path, w in jax.tree_util.tree_flatten_with_path(jg)[0]:
        g = got
        for k in path:
            g = g[k.key]
        assert _rel(g, w) <= 1e-4, (jax.tree_util.keystr(path), _rel(g, w))
