"""The encoder-decoder and hybrid families in the port against the JAX
package, on the CPU, at the reduced seamless-m4t-large-v2 (an encoder over
seeded frame embeddings, the decoder's cross-attention, the ``{"enc"}``
cache) and jamba-1.5-large-398b (one period of 7 Mamba sublayers and one
attention sublayer, MoE on every second), with weights from
``convert.from_jax`` and inputs from numpy.

``test_torch_lm.py`` holds both archs' ``prefill``, every cache leaf and
8 decode steps, and prefill(S) against prefill(S - 1) and a decode step;
``test_torch_lm_train.py`` their ``loss_fn`` and gradients;
``test_torch_serve.py`` Jamba's engine token streams and both engines'
``KeyError`` on a seamless request without frames;
``test_torch_convert.py`` their params leaf for leaf.  This file holds the
new layer and model functions (``cross_attn_apply``, ``_encode``), the
period's param and cache layout, the caches' round trip, the cache
utilities on the nested caches, the entry points, and the JAX models
through their Pallas kernels (interpret mode; Jamba's scan through its
plain reference, since the Pallas scan no longer runs on this JAX).

fp32 within 2e-5, bf16 (the configs' dtype, against the JAX model run op
by op, with the port's oneDNN off: ``test_torch_lm.py``'s docstring)
within 2e-2.
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
from repro.models.lm import Model as JModel
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.kv_cache import pad_to_length as jpad
from repro_torch import configs, convert
from repro_torch.launch import serve as serve_entry
from repro_torch.launch import train as train_entry
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoe
from repro_torch.models.lm import Model, layer
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.serve.kv_cache import alloc_like, pad_to_length

ENCDEC, HYBRID = "seamless-m4t-large-v2", "jamba-1.5-large-398b"
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: many tiny ops, beside the suite's parallel
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@contextlib.contextmanager
def _reference(dtype):
    """Op by op for bf16, with the port's oneDNN off; compiled for fp32."""
    if dtype != "bfloat16":
        yield
        return
    with jax.disable_jit(), torch.backends.mkldnn.flags(enabled=False):
        yield


def _models(arch, dtype, seed=0):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), param_dtype=dtype)
    tcfg = dataclasses.replace(configs.get_reduced(arch), param_dtype=dtype)
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jm, tm, jp, tp


def _values(cfg, shape, seed):
    """Seeded standard normal values, exact in ``cfg``'s dtype: (the JAX
    array, the port's tensor)."""
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    j = jnp.asarray(x, jnp.dtype(cfg.param_dtype))
    return j, torch.tensor(np.asarray(j, np.float32), dtype=cfg.dtype)


def _batches(cfg, toks, frames_seed=7):
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.as_tensor(toks)}
    if cfg.family == "encdec":
        jb["frame_embeds"], tb["frame_embeds"] = _values(
            cfg, (toks.shape[0], cfg.frontend_tokens, cfg.d_model),
            frames_seed)
    return jb, tb


# ----------------------------- layer functions -----------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_jax(dtype):
    """``cross_attn_apply`` (no RoPE, non-causal, K and V from the
    encoder's states) at Sq = 12 and Sq = 1 over 16 frames, and ``_qkv``
    with and without a ``kv_src``."""
    jcfg, tcfg, _, _, jp, tp = _models(ENCDEC, dtype)
    jx0 = jax.tree_util.tree_map(lambda a: a[0], jp["g1"])
    tx0 = layer(tp["g1"], 0)
    je, te = _values(tcfg, (2, tcfg.frontend_tokens, tcfg.d_model), 3)
    for s in (12, 1):
        jx, tx = _values(tcfg, (2, s, tcfg.d_model), 4 + s)
        with _reference(dtype):
            want = JL.cross_attn_apply(jx0["xattn"], jcfg, jx, je)
            got = TL.cross_attn_apply(tx0["xattn"], tcfg, tx, te)
            assert got.shape == (2, s, tcfg.d_model) and got.dtype == \
                tcfg.dtype
            _close(got, want, dtype)
            for src in ((None, None), (je, te)):
                jq = JL._qkv(jx0["attn"], jcfg, jx, kv_src=src[0])
                tq = TL._qkv(tx0["attn"], tcfg, tx, kv_src=src[1])
                for a, b in zip(tq, jq):
                    assert tuple(a.shape) == b.shape
                    _close(a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_matches_jax(dtype):
    """``_encode``: the non-causal encoder group over the frames, then
    the final norm ``ln_f`` (the decoder's own); under autograd (the
    training path, each layer under ``checkpoint``) and without it (a
    prefill's), the same values."""
    _, tcfg, jm, tm, jp, tp = _models(ENCDEC, dtype)
    jb, tb = _batches(tcfg, np.zeros((2, 4), np.int64))
    with _reference(dtype):
        want = jm._encode(jp, jb)
        with torch.no_grad():
            got = tm._encode(tp, tb)
        assert got.shape == (2, tcfg.frontend_tokens, tcfg.d_model)
        assert got.dtype == tcfg.dtype
        _close(got, want, dtype)
        xs = convert.tree_map(lambda t: t.detach().requires_grad_(), tp)
        again = tm._encode(xs, tb)
        assert again.requires_grad
        assert torch.equal(again.detach(), got)


@pytest.mark.parametrize("arch", [ENCDEC, HYBRID])
def test_groups_match_jax(arch):
    for get in ("get_config", "get_reduced"):
        jm = JModel(getattr(jconfigs, get)(arch))
        tm = Model(getattr(configs, get)(arch))
        assert [dataclasses.astuple(g) for g in tm.groups] == \
            [dataclasses.astuple(g) for g in jm.groups]


def test_full_configs_are_the_published_shape():
    """seamless: 24 encoder + 24 decoder layers, 2.04 B params, vocab
    padded to 258,048.  jamba: 9 periods of 8 sublayers, 398.55 B params
    of which 94.15 B active; one period with the embedding and head
    45.24 B params at 16 experts (90.5 GB in bf16: no card holds it),
    35.57 B at 12, 16.25 B at 4 and 11.41 B at 2, the cuts the card's
    runs take."""
    s = configs.get_config(ENCDEC)
    assert (s.encoder_layers, s.n_layers, s.d_model, s.n_heads, s.hd,
            s.d_ff, s.padded_vocab, s.frontend_tokens) == \
        (24, 24, 1024, 16, 64, 8192, 258048, 1024)
    assert round(s.param_count() / 1e9, 2) == 2.04
    j = configs.get_config(HYBRID)
    assert [(g.kind, g.n, g.moe) for g in Model(j).groups] == \
        [("hybrid", 9, True)]
    assert (j.d_model, j.n_heads, j.n_kv_heads, j.hd, j.d_inner,
            j.ssm_state, j.n_experts, j.top_k, j.expert_ff) == \
        (8192, 64, 8, 128, 16384, 16, 16, 2, 24576)
    assert round(j.param_count() / 1e9, 2) == 398.55
    assert round(j.active_param_count() / 1e9, 2) == 94.15
    period = {e: round(dataclasses.replace(
        j, n_layers=j.attn_period, n_experts=e).param_count() / 1e9, 2)
        for e in (16, 12, 4, 2)}
    assert period == {16: 45.24, 12: 35.57, 4: 16.25, 2: 11.41}


# ------------------------------ param layout -------------------------------

@pytest.mark.parametrize("arch", [ENCDEC, HYBRID])
def test_init_has_the_jax_tree(arch):
    """The port's seeded init against ``jax.eval_shape`` of the JAX
    init, leaf for leaf: path, shape and dtype; a period's stacks are
    (P, 7, ...) Mamba, (P, 4, ...) MoE and dense SwiGLU, (P, 16, d) norms,
    and the unread ``ln1`` JAX's period holds."""
    want = jax.eval_shape(JModel(jconfigs.get_reduced(arch)).init,
                          jax.random.PRNGKey(0))
    got = Model(configs.get_reduced(arch)).init(0, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(convert.leaves(got))
    for path, spec in flat:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == spec.shape, path
        assert str(t.dtype)[6:] == str(spec.dtype), path
    if arch == HYBRID:
        g = got["g0"]
        assert g["mamba"]["in_proj"].shape[:2] == (1, 7)
        assert g["moe"]["wg"].shape[:3] == (1, 4, 4)
        assert g["mlp"]["wg"].shape[:2] == (1, 4)
        assert g["ln"]["w"].shape == (1, 16, 64)
        assert torch.equal(g["ln1"]["w"], torch.ones(1, 64))
    else:
        assert set(got["g1"]) == {"ln1", "attn", "ln2", "xattn", "ln_x",
                                  "mlp"}
        assert set(got["g0"]) == {"ln1", "attn", "ln2", "mlp"}


def test_stacked_moe_init_scales_and_slabs(monkeypatch):
    """``moe_init(n=...)`` draws each stacked sublayer into its slice,
    with the JAX package's scales; with a slab smaller than one expert's
    matrix the draw goes row by row and keeps them."""
    cfg = dataclasses.replace(configs.get_reduced(HYBRID), n_experts=8,
                              d_model=128, moe_d_ff=256)
    monkeypatch.setattr(TMoe, "_SLAB", 4000)
    gen = torch.Generator().manual_seed(0)
    p = TMoe.moe_init(gen, cfg, n=3)
    assert p["router"].shape == (3, 128, 8)
    assert p["router"].dtype == torch.float32
    assert p["wg"].shape == (3, 8, 128, 256) and p["wg"].dtype == \
        torch.bfloat16
    assert p["wd"].shape == (3, 8, 256, 128)
    for name, fan_in in (("router", 128), ("wg", 128), ("wu", 128),
                         ("wd", 256)):
        for i in range(3):
            std = p[name][i].float().std().item() * fan_in ** 0.5
            assert abs(std - 1.0) < 0.05, (name, i, std)
    assert not torch.equal(p["wg"][0], p["wg"][1])


# ------------------------------- the caches --------------------------------

@pytest.mark.parametrize("arch", [ENCDEC, HYBRID])
def test_caches_have_the_jax_layout_and_round_trip(arch):
    """fp32 prefill caches: the JAX tree (``{"enc"}`` then the decoder's
    ``{k, v}``; a period's ``{attn: {k, v}, mamba: {h, conv}}``), shapes
    and dtypes; ``from_jax`` of JAX's caches and ``to_numpy`` of the
    port's agree, and ``from_jax`` -> ``to_numpy`` is bit-equal."""
    _, tcfg, jm, tm, jp, tp = _models(arch, "float32", seed=2)
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 10))
    jb, tb = _batches(tcfg, toks)
    _, jc = jm.prefill(jp, jb)
    _, tc = tm.prefill(tp, tb)
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert len(flat) == len(convert.leaves(tc))
    for path, want in flat:
        t = tc
        for k in path:
            t = t[k.idx] if hasattr(k, "idx") else t[k.key]
        assert tuple(t.shape) == want.shape, path
        assert str(t.dtype)[6:] == str(want.dtype), path
    if arch == HYBRID:
        assert tc[0]["mamba"]["h"].shape == (1, 7, 2, tcfg.d_inner,
                                             tcfg.ssm_state)
        assert tc[0]["attn"]["k"].shape == (1, 2, tcfg.n_kv_heads, 10,
                                            tcfg.hd)
    else:
        assert tc[0]["enc"].shape == (2, tcfg.frontend_tokens,
                                      tcfg.d_model)
    back = convert.from_jax(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    for a, b in zip(convert.leaves(convert.to_numpy(back)),
                    jax.tree_util.tree_leaves(jc)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    for a, b in zip(convert.leaves(back), convert.leaves(tc)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-5,
                                   atol=2e-5 * max(1.0, _np(a).max()))


@pytest.mark.parametrize("arch", [ENCDEC, HYBRID])
def test_cache_utilities_walk_the_nested_caches(arch):
    """``pad_to_length`` pads a period's nested ``attn`` keys and values
    along ``ndim - 2`` as JAX's does, and passes the Mamba states and the
    encoder's states as they are; ``alloc_like`` re-batches each leaf
    along its own batch axis."""
    _, tcfg, jm, tm, jp, tp = _models(arch, "float32", seed=3)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (1, 6))
    jb, tb = _batches(tcfg, toks)
    _, jc = jm.prefill(jp, jb)
    _, tc = tm.prefill(tp, tb)
    jpd, tpd = jpad(jc, 20), pad_to_length(tc, 20)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jpd)[0],
                                 convert.leaves(tpd)):
        assert tuple(got.shape) == want.shape, path
    if arch == HYBRID:
        assert tpd[0]["attn"]["k"].shape[-2] == 20
        assert not tpd[0]["attn"]["v"][..., 6:, :].any()
        assert tpd[0]["mamba"]["h"] is tc[0]["mamba"]["h"]
        assert tpd[0]["mamba"]["conv"] is tc[0]["mamba"]["conv"]
    else:
        assert tpd[0]["enc"] is tc[0]["enc"]
        assert tpd[1]["k"].shape[-2] == 20
    more = alloc_like(tpd, batch=3)
    for got, have in zip(convert.leaves(more), convert.leaves(tpd)):
        assert not got.any() and got.dtype == have.dtype
    if arch == HYBRID:
        assert more[0]["attn"]["k"].shape == (1, 3, tcfg.n_kv_heads, 20,
                                              tcfg.hd)
        assert more[0]["mamba"]["h"].shape == (1, 7, 3, tcfg.d_inner,
                                               tcfg.ssm_state)
        assert more[0]["mamba"]["conv"].shape == (1, 7, 3,
                                                  tcfg.ssm_conv - 1,
                                                  tcfg.d_inner)
    else:
        assert more[0]["enc"].shape == (3, tcfg.frontend_tokens,
                                        tcfg.d_model)
        assert more[1]["k"].shape[:2] == (tcfg.n_layers, 3)


def test_decode_writes_the_period_caches_in_place():
    """A decode step writes the period's keys at its position and steps
    the Mamba states in the tensors it was given."""
    _, tcfg, _, tm, _, tp = _models(HYBRID, "float32", seed=4)
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, tcfg.vocab, (1, 6)))
    _, caches = tm.prefill(tp, {"tokens": toks})
    caches = pad_to_length(caches, 10)
    h, k = caches[0]["mamba"]["h"], caches[0]["attn"]["k"]
    h0 = h.clone()
    assert not k[..., 6, :].any()
    _, out = tm.decode_step(tp, caches, toks[:, -1:], 6)
    assert out[0]["mamba"]["h"] is h and out[0]["attn"]["k"] is k
    assert k[..., 6, :].any() and not torch.equal(h, h0)


# ---------------------------- model behaviour ------------------------------

def test_encdec_uses_frames():
    """The JAX package's ``tests/test_models.py`` case, in the port, and
    both losses equal JAX's from the same params."""
    _, tcfg, jm, tm, jp, tp = _models(ENCDEC, "bfloat16")
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 9))
    jb, tb = _batches(tcfg, toks[:, :-1])
    jb["labels"] = jnp.asarray(toks[:, 1:], jnp.int32)
    tb["labels"] = torch.as_tensor(toks[:, 1:])
    with _reference("bfloat16"):
        losses = []
        for scale in (1.0, 2.0):
            jb2 = dict(jb, frame_embeds=jb["frame_embeds"] * scale)
            tb2 = dict(tb, frame_embeds=tb["frame_embeds"] * scale)
            with torch.no_grad():
                losses.append((float(tm.loss_fn(tp, tb2)),
                               float(jm.loss_fn(jp, jb2))))
    assert losses[0][0] != losses[1][0]
    for got, want in losses:
        assert abs(got - want) <= 2e-4 * abs(want), (got, want)


def test_a_frameless_batch_raises_as_jax():
    """No ``frame_embeds``: ``KeyError`` from the encoder in ``prefill``
    and ``loss_fn``, in both packages."""
    _, tcfg, jm, tm, jp, tp = _models(ENCDEC, "float32")
    toks = np.zeros((1, 5), np.int64)
    for fn, batch in ((jm.prefill, {"tokens": jnp.asarray(toks)}),
                      (tm.prefill, {"tokens": torch.as_tensor(toks)}),
                      (jm.loss_fn, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(toks)}),
                      (tm.loss_fn, {"tokens": torch.as_tensor(toks),
                                    "labels": torch.as_tensor(toks)})):
        with pytest.raises(KeyError, match="frame_embeds"):
            fn(jp if fn.__self__ is jm else tp, batch)


@pytest.mark.parametrize("arch", [ENCDEC, HYBRID])
def test_models_match_jax_through_its_pallas_kernels(arch, monkeypatch):
    """fp32, the JAX model with its Pallas kernels on (interpret mode):
    seamless's encoder, self- and cross-attention (Sq = 10 and 1 over 16
    frames) through its flash kernel; Jamba's attention through the flash
    kernel and its four MoE sublayers through the router kernel, its scan
    through the plain reference (the Pallas scan does not run on this
    JAX).  Prefill and two decode steps."""
    _, tcfg, jm, tm, jp, tp = _models(arch, "float32", seed=5)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (1, 10))
    jb, tb = _batches(tcfg, toks)
    calls = {"flash": 0, "router": 0}
    flash, router = jbackend._flash_pallas, jbackend._router_pallas

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(jbackend, "_USE_PALLAS", True)
    monkeypatch.setattr(jbackend, "_flash_pallas", counted("flash", flash))
    monkeypatch.setattr(jbackend, "_router_pallas",
                        counted("router", router))
    monkeypatch.setattr(jbackend, "_scan_pallas",
                        lambda *a, interpret=True: jbackend.mamba_scan_ref(
                            *a))
    jl, jc = jm.prefill(jp, jb)
    tl, tc = tm.prefill(tp, tb)
    # each group's scanned body is traced once: the encoder's attention,
    # the decoder's self- and cross-attention; a period's attention and
    # its four MoE sublayers
    want = dict(flash=3, router=0) if arch == ENCDEC \
        else dict(flash=1, router=4)
    assert calls == want
    scale = 1.0 if arch == ENCDEC else float(np.abs(_np(jl)).max())
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=2e-5,
                               atol=2e-5 * scale)
    jc, tc = jpad(jc, 16), pad_to_length(tc, 16)
    for i in range(2):
        tok = int(np.argmax(_np(jl)[0, -1]))
        assert int(torch.argmax(tl[0, -1])) == tok
        jl, jc = jm.decode_step(jp, jc, jnp.asarray([[tok]], jnp.int32),
                                jnp.asarray(10 + i, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.tensor([[tok]]), 10 + i)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=2e-5,
                                   atol=2e-5 * scale)
    if arch == ENCDEC:      # the decoder's cross-attention at Sq = 1
        assert calls["flash"] > want["flash"]


# ------------------------------ entry points -------------------------------

def test_entry_points_serve_and_train_jamba_reduced():
    out = serve_entry.main(["--arch", HYBRID, "--reduced", "--device",
                            "cpu", "--requests", "2", "--max-new", "3"])
    assert out["requests_done"] == 2 and out["tokens"] >= 6
    out = train_entry.main(["--arch", HYBRID, "--reduced", "--device",
                            "cpu", "--steps", "3", "--batch", "2", "--seq",
                            "8"])
    assert out["steps"] == 3 and np.isfinite(out["losses"]).all()


@pytest.mark.parametrize("which", ["serve", "train"])
def test_entry_points_raise_on_seamless_as_jax(which):
    """The drivers feed tokens only, so seamless raises ``KeyError:
    'frame_embeds'`` in the encoder, as the JAX drivers do."""
    if which == "serve":
        with pytest.raises(KeyError, match="frame_embeds"):
            serve_entry.main(["--arch", ENCDEC, "--reduced", "--device",
                              "cpu", "--requests", "1", "--max-new", "2"])
        return
    with pytest.raises(KeyError, match="frame_embeds"):
        train_entry.main(["--arch", ENCDEC, "--reduced", "--device", "cpu",
                          "--steps", "1", "--batch", "2", "--seq", "8"])


def test_engines_raise_alike_on_a_frameless_request():
    """One seamless request without frames: ``KeyError`` in both
    engines' admission (prefill)."""
    _, tcfg, jm, tm, jp, tp = _models(ENCDEC, "float32")
    prompt = np.arange(5)
    for eng, req in ((JEngine(jm, jp, JEngineConfig(1, 16)), JRequest),
                     (Engine(tm, tp, EngineConfig(1, 16)), Request)):
        eng.submit(req(req_id=0, tokens=prompt, max_new=2))
        with pytest.raises(KeyError, match="frame_embeds"):
            eng.step()
