"""The port's LM (configs, layers, ``Model.prefill`` and ``decode_step``)
against the JAX package's, on the CPU, at the reduced configs of every
ported arch (yi-6b, demo-100m, qwen3-moe-30b-a3b), with weights from
``convert.from_jax`` and token ids from numpy.

fp32 (``param_dtype="float32"``) is held to 2e-5 with equal greedy
tokens.  bf16, the configs' own dtype, is held to the kernel sweep's
bf16 tolerance (rtol = atol = 2e-2) against the JAX model run op by op
(``jax.disable_jit``), where every bf16 rounding falls where the port's
does: the observed drift is 0.  Compiled, XLA fuses the scanned layer
body and drops some bf16 roundings; that moves the JAX model's own
logits by up to 0.021 from its op-by-op run at reduced yi-6b (one
element, near zero, then exceeds 2e-2 + 2e-2 * |logit|), which is why
the compiled JAX model is not the bf16 reference here.

The JAX model runs once more through its Pallas kernels (interpret
mode): prefill reaches its flash kernel; its decode does not reach its
decode kernel, because ``kv_len`` is traced there (the decode kernel
module is held against the Pallas kernel in
``test_torch_decode_attention.py``).  The MoE model reaches its router
kernel in prefill and in decode.  Inside the port, prefill of S tokens
equals prefill of S - 1 and a decode step, in fp32 within the 2e-4 of
the JAX package's own test (``tests/test_models.py``).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import backend as jbackend
from repro.models import layers as JL
from repro.models import moe as JMoe
from repro.models.lm import Model as JModel
from repro.serve.kv_cache import pad_to_length as jpad
from repro_torch import configs
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoe
from repro_torch.models.lm import Model, layer
from repro_torch.serve.kv_cache import pad_to_length as tpad

ARCHS = configs.PORTED
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
PROMPT, STEPS, MAX_LEN = 12, 8, 32


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, dtype = request.param
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype=dtype)
    tcfg = dataclasses.replace(configs.get_reduced(arch), param_dtype=dtype)
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (1, PROMPT))
    return dict(dtype=dtype, jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jp=jp,
                tp=tp, toks=toks)


# --------------------------------- configs ---------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_jax_registry(arch):
    for get in ("get_config", "get_reduced"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(configs, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.hd, t.padded_vocab, t.param_count()) == \
            (j.hd, j.padded_vocab, j.param_count())
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert [t.is_attention_layer(i) for i in range(t.n_layers)] == \
            [j.is_attention_layer(i) for i in range(j.n_layers)]
        assert [t.is_moe_layer(i) for i in range(t.n_layers)] == \
            [j.is_moe_layer(i) for i in range(j.n_layers)]
    assert configs.list_archs() == jconfigs.list_archs()
    assert configs.list_archs(False) == jconfigs.list_archs(False)


def test_qwen3_moe_is_the_published_shape():
    cfg = configs.get_config("qwen3-moe-30b-a3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.n_experts, cfg.top_k, cfg.expert_ff, cfg.padded_vocab) == \
        (48, 2048, 32, 4, 128, 128, 8, 768, 153600)
    assert round(cfg.param_count() / 1e9, 2) == 30.54
    assert [g.moe for g in Model(cfg).groups] == [True]


def test_yi_6b_is_the_published_shape():
    cfg = configs.get_config("yi-6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.padded_vocab) == (32, 4096, 32, 4, 128, 11008,
                                            65536)
    assert round(cfg.param_count() / 1e9, 2) == 6.07


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "falcon-mamba-7b",
                                  "deepseek-67b"])
def test_unported_archs_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        configs.get_config(arch)


def test_moe_dense_prefix_names_its_roadmap_item():
    cfg = dataclasses.replace(configs.get_reduced("qwen3-moe-30b-a3b"),
                              first_dense_layers=1)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md Queue 1 item 4.5"):
        Model(cfg)


# --------------------------------- layers ----------------------------------

def test_rope_tables_match():
    for seq, dim, theta in ((12, 16, 1e4), (300, 128, 5e6)):
        jc, js = JL.rope_table(seq, dim, theta)
        tc, ts = TL.rope_table(seq, dim, theta)
        np.testing.assert_allclose(_np(tc), _np(jc), rtol=0, atol=2e-6)
        np.testing.assert_allclose(_np(ts), _np(js), rtol=0, atol=2e-6)


def test_layer_functions_match(pair):
    dt, cfg = pair["dtype"], pair["tcfg"]
    jl0 = jax.tree_util.tree_map(lambda a: a[0], pair["jp"]["g0"])
    tl0 = layer(pair["tp"]["g0"], 0)
    rng = np.random.default_rng(2)
    x_np = rng.standard_normal((1, PROMPT, cfg.d_model), np.float32)
    jx = jnp.asarray(x_np, pair["jcfg"].dtype)
    tx = torch.tensor(np.asarray(jx, np.float32), dtype=cfg.dtype)
    _close(TL.rms_norm(tl0["ln1"], tx, cfg.norm_eps),
           JL.rms_norm(jl0["ln1"], jx, cfg.norm_eps), dt)
    if "mlp" in tl0:
        _close(TL.mlp_apply(tl0["mlp"], tx), JL.mlp_apply(jl0["mlp"], jx),
               dt)
    if "moe" in tl0:
        with _jax_reference(dt):
            want = JMoe.moe_apply(jl0["moe"], pair["jcfg"], jx,
                                  inference=True)
        _close(TMoe.moe_apply(tl0["moe"], cfg, tx), want, dt)
    jcos, jsin = JL.rope_table(PROMPT, cfg.hd, cfg.rope_theta)
    tcos, tsin = TL.rope_table(PROMPT, cfg.hd, cfg.rope_theta)
    xh = x_np[..., :cfg.hd * 4].reshape(1, PROMPT, 4, cfg.hd)
    _close(TL.apply_rope(torch.tensor(xh, dtype=cfg.dtype), tcos, tsin),
           JL.apply_rope(jnp.asarray(xh, pair["jcfg"].dtype), jcos, jsin),
           dt)
    _close(TL.attn_apply(tl0["attn"], cfg, tx, tcos, tsin),
           JL.attn_apply(jl0["attn"], pair["jcfg"], jx, jcos, jsin), dt)
    jo, jc = JL.attn_prefill(jl0["attn"], pair["jcfg"], jx, jcos, jsin)
    to, tc = TL.attn_prefill(tl0["attn"], cfg, tx, tcos, tsin)
    _close(to, jo, dt)
    for key in ("k", "v"):
        _close(tc[key], jc[key], dt)
    # one decode token at position PROMPT against the padded cache
    pos = PROMPT
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, 4), (0, 0))), jc)
    tcache = {k: torch.cat([v, v.new_zeros(1, v.shape[1], 4, cfg.hd)], 2)
              for k, v in tc.items()}
    jx1, tx1 = jx[:, -1:], tx[:, -1:].contiguous()
    jo, jcache = JL.attn_decode(
        jl0["attn"], pair["jcfg"], jx1, jcache, jnp.asarray(pos, jnp.int32),
        *pair["jm"]._rope_at(jnp.asarray(pos, jnp.int32)))
    to, tcache = TL.attn_decode(tl0["attn"], cfg, tx1, tcache, pos,
                                *pair["tm"]._rope_at(pos))
    _close(to, jo, dt)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], dt)


def _same_shapes_and_dtypes(arch):
    """The port's seeded init against the JAX init's shapes and dtypes,
    leaf for leaf; returns the port's params."""
    jm = JModel(jconfigs.get_reduced(arch))
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    got = Model(configs.get_reduced(arch)).init(0, "cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(jax.tree_util.tree_leaves(got))
    for path, spec in flat_w:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == spec.shape, path
        assert str(t.dtype).split(".")[-1] == str(spec.dtype), path
    return got


def test_init_matches_the_jax_shapes_dtypes_and_scales():
    cfg = configs.get_reduced("yi-6b")
    got = _same_shapes_and_dtypes("yi-6b")
    wq = got["g0"]["attn"]["wq"].float()        # n_in^-0.5 scale
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert torch.equal(got["g0"]["ln1"]["w"], torch.ones(2, cfg.d_model))
    again = Model(cfg).init(0, "cpu")
    assert torch.equal(again["head"], got["head"])   # seeded


def test_moe_init_matches_the_jax_shapes_dtypes_and_scales():
    cfg = configs.get_reduced("qwen3-moe-30b-a3b")
    moe = _same_shapes_and_dtypes("qwen3-moe-30b-a3b")["g0"]["moe"]
    assert moe["router"].dtype == torch.float32          # kept fp32
    for name, fan_in in (("router", cfg.d_model), ("wg", cfg.d_model),
                         ("wd", cfg.expert_ff)):
        std = moe[name].float().std().item() * fan_in ** 0.5
        assert abs(std - 1.0) < 0.05, name


# ------------------------------ prefill, decode ----------------------------

def _jax_reference(dtype):
    """Op by op for bf16 (see the module docstring), compiled for fp32."""
    return jax.disable_jit() if dtype == "bfloat16" \
        else contextlib.nullcontext()


def test_prefill_and_decode_match(pair):
    dt, jm, tm, jp, tp = (pair[k] for k in ("dtype", "jm", "tm", "jp",
                                             "tp"))
    toks = pair["toks"]
    with _jax_reference(dt):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
        tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
        assert tl.dtype == torch.float32
        assert tl.shape == (1, 1, pair["tcfg"].vocab)
        _close(tl, jl, dt)
        for key in ("k", "v"):
            assert tc[0][key].shape == jc[0][key].shape
            _close(tc[0][key], jc[0][key], dt)
        # teacher forcing: both decode the JAX model's greedy stream
        jc, tc = jpad(jc, MAX_LEN), tpad(tc, MAX_LEN)
        for i in range(STEPS):
            tok = int(np.argmax(_np(jl)[0, -1]))
            if dt == "float32":
                assert int(torch.argmax(tl[0, -1])) == tok, i
            jl, jc = jm.decode_step(jp, jc, jnp.asarray([[tok]], jnp.int32),
                                    jnp.asarray(PROMPT + i, jnp.int32))
            tl, tc = tm.decode_step(tp, tc, torch.tensor([[tok]]),
                                    PROMPT + i)
            _close(tl, jl, dt)
        for key in ("k", "v"):
            _close(tc[0][key], jc[0][key], dt)


def test_prefill_matches_the_jax_model_through_its_pallas_kernel(
        monkeypatch):
    """The JAX model with its Pallas kernels on (interpret mode), set for
    this test only."""
    cfg = dataclasses.replace(configs.get_reduced("yi-6b"),
                              param_dtype="float32")
    jm = JModel(dataclasses.replace(jconfigs.get_reduced("yi-6b"),
                                    param_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(3))
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 20))
    monkeypatch.setattr(jbackend, "_USE_PALLAS", True)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = Model(cfg).prefill(tp, {"tokens": torch.as_tensor(toks)})
    _close(tl, jl, "float32")
    _close(tc[0]["k"], jc[0]["k"], "float32")
    tok = int(np.argmax(_np(jl)[0, -1]))
    assert int(torch.argmax(tl[0, -1])) == tok
    jc, tc = jpad(jc, 24), tpad(tc, 24)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray([[tok]], jnp.int32),
                           jnp.asarray(20, jnp.int32))
    td, _ = Model(cfg).decode_step(tp, tc, torch.tensor([[tok]]), 20)
    _close(td, jd, "float32")


def test_unported_families_raise():
    cfg = dataclasses.replace(configs.get_reduced("yi-6b"), family="ssm")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Model(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_prefill_then_decode(arch):
    """prefill(S) last-token logits == prefill(S - 1), then a decode step
    of token S - 1, in fp32 within the JAX package's 2e-4, at B = 2."""
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              param_dtype="float32")
    model = Model(cfg)
    params = model.init(0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 16)))
    full, _ = model.prefill(params, {"tokens": toks})
    _, caches = model.prefill(params, {"tokens": toks[:, :-1]})
    logits, _ = model.decode_step(params, tpad(caches, 16), toks[:, -1:],
                                  15)
    np.testing.assert_allclose(_np(logits), _np(full), rtol=2e-4,
                               atol=2e-4)


def test_moe_model_matches_the_jax_model_through_its_pallas_router(
        monkeypatch):
    """The JAX MoE model with its Pallas kernels on (interpret mode): its
    router kernel runs in prefill and in decode."""
    arch = "qwen3-moe-30b-a3b"
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              param_dtype="float32")
    jm = JModel(dataclasses.replace(jconfigs.get_reduced(arch),
                                    param_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(4))
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 20))
    calls = []
    pallas_router = jbackend._router_pallas
    monkeypatch.setattr(jbackend, "_USE_PALLAS", True)
    monkeypatch.setattr(jbackend, "_router_pallas",
                        lambda *a, **kw: calls.append(1)
                        or pallas_router(*a, **kw))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert calls, "the JAX prefill did not reach its router kernel"
    tm = Model(cfg)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    _close(tl, jl, "float32")
    tok = int(np.argmax(_np(jl)[0, -1]))
    assert int(torch.argmax(tl[0, -1])) == tok
    jc, tc = jpad(jc, 24), tpad(tc, 24)
    n = len(calls)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray([[tok]], jnp.int32),
                           jnp.asarray(20, jnp.int32))
    assert len(calls) > n, "the JAX decode did not reach its router kernel"
    td, _ = tm.decode_step(tp, tc, torch.tensor([[tok]]), 20)
    _close(td, jd, "float32")
