"""The decoder-only archs ported last, against the JAX package on the
CPU: MLA (``mla_apply`` / ``mla_prefill`` / ``mla_decode``, deepseek-v3's
attention) layer by layer, internvl2's patch embeddings in all three
modes, the new param leaves through ``convert``, ``configs/shapes.py``
and ``active_param_count``, with weights from ``convert.from_jax`` and
inputs from numpy.

fp32 is held to 2e-5 against the compiled JAX functions; bf16 to 2e-2
against JAX run op by op (``jax.disable_jit``), the port's side with
oneDNN off so its bf16 matmuls round the fp32 sum as XLA's CPU dot does
(``test_torch_lm.py``).  MLA attends through the plain attention
functions in both packages, so on the CPU the two compute the same ops:
the observed drift is within a few fp32 ulps, and bf16 within a bf16
ulp of the cast at its end.  The losses and gradients with
``patch_embeds`` are held to ``test_torch_lm_train.py``'s bounds.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.models import layers as JL
from repro.models.config import ModelConfig as JConfig
from repro.models.lm import Model as JModel
from repro.serve.kv_cache import pad_to_length as jpad
from repro_torch import configs, convert
from repro_torch.configs import shapes
from repro_torch.launch import serve as serve_entry
from repro_torch.launch import train as train_entry
from repro_torch.models import backend
from repro_torch.models import layers as TL
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import Model, layer
from repro_torch.serve.kv_cache import alloc_like
from repro_torch.serve.kv_cache import pad_to_length as tpad
from repro_torch.train.trainer import value_and_grad

MLA = "deepseek-v3-671b"
VLM = "internvl2-26b"
NEW = ["minitron-4b", "phi4-mini-3.8b", "deepseek-67b", VLM, MLA]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}     # test_torch_lm_train.py
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-4}


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


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(_np(got) - want) / np.linalg.norm(want))


@contextlib.contextmanager
def _reference(dtype):
    """JAX op by op and the port's bf16 matmuls rounding the fp32 sum for
    bf16; compiled JAX for fp32."""
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


def _x(seed, shape, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    a = np.asarray(jnp.asarray(a, jnp.dtype(dtype)), np.float32)
    return jnp.asarray(a, jnp.dtype(dtype)), \
        torch.tensor(a, dtype=getattr(torch, dtype))


@pytest.fixture
def no_attention_kernels(monkeypatch):
    """MLA must call neither attention kernel's wrapper (JAX calls the
    plain functions directly)."""
    def refuse(*a, **kw):
        raise AssertionError("MLA reached an attention kernel's wrapper")
    monkeypatch.setattr(backend, "attention", refuse)
    monkeypatch.setattr(backend, "decode_attention", refuse)


# ---------------------------------- MLA ------------------------------------

@pytest.mark.parametrize("gi", [0, 1], ids=["dense-prefix", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_functions_match_jax(dtype, gi, no_attention_kernels):
    """``mla_apply``, ``mla_prefill`` (out and the latent cache) and
    ``mla_decode`` at a position past the prompt against a padded cache
    (out and the cache written in place), layer 0 of each group."""
    jcfg, tcfg, jm, tm, jp, tp = _models(MLA, dtype, seed=3)
    jl0 = jax.tree_util.tree_map(lambda a: a[0], jp[f"g{gi}"]["attn"])
    tl0 = layer(tp[f"g{gi}"], 0)["attn"]
    s = 11
    jx, tx = _x(4, (2, s, tcfg.d_model), dtype)
    jcos, jsin = JL.rope_table(s, tcfg.qk_rope_dim, tcfg.rope_theta)
    tcos, tsin = TL.rope_table(s, tcfg.qk_rope_dim, tcfg.rope_theta)
    with _reference(dtype):
        _close(TL.mla_apply(tl0, tcfg, tx, tcos, tsin),
               JL.mla_apply(jl0, jcfg, jx, jcos, jsin), dtype)
        jo, jc = JL.mla_prefill(jl0, jcfg, jx, jcos, jsin)
        to, tc = TL.mla_prefill(tl0, tcfg, tx, tcos, tsin)
        _close(to, jo, dtype)
        assert set(tc) == set(jc) == {"c_kv", "k_rope"}
        assert tuple(tc["c_kv"].shape) == (2, s, tcfg.kv_lora_rank)
        assert tuple(tc["k_rope"].shape) == (2, s, tcfg.qk_rope_dim)
        for key in tc:
            assert tc[key].dtype == tx.dtype
            _close(tc[key], jc[key], dtype)
        # one token at position s against caches padded to 16
        jcache = {k: jnp.pad(v, ((0, 0), (0, 5), (0, 0)))
                  for k, v in jc.items()}
        tcache = {k: torch.cat([v, v.new_zeros(2, 5, v.shape[2])], 1)
                  for k, v in tc.items()}
        jx1, tx1 = _x(5, (2, 1, tcfg.d_model), dtype)
        pos = jnp.asarray(s, jnp.int32)
        jo, jcache = JL.mla_decode(jl0, jcfg, jx1, jcache, pos,
                                   *jm._rope_at(pos))
        before = {k: v.clone() for k, v in tcache.items()}
        to, out = TL.mla_decode(tl0, tcfg, tx1, tcache, s, *tm._rope_at(s))
        assert out is tcache and to.dtype == tx1.dtype
        _close(to, jo, dtype)
        for key in tcache:
            _close(tcache[key], jcache[key], dtype)
            # written in place at s only
            assert torch.equal(tcache[key][:, :s], before[key][:, :s])
            assert not tcache[key][:, s + 1:].any()


def test_mla_gradients_match_jax(no_attention_kernels):
    """``mla_apply``'s gradients in every param and the input against
    ``jax.grad`` in fp32 (autograd through the plain attention), 1e-4
    relative in norm."""
    jcfg, tcfg, _, _, jp, tp = _models(MLA, "float32", seed=6)
    jl0 = jax.tree_util.tree_map(lambda a: a[0], jp["g1"]["attn"])
    tl0 = convert.tree_map(lambda t: t.clone().requires_grad_(),
                           layer(tp["g1"], 0)["attn"])
    jx, tx = _x(7, (2, 9, tcfg.d_model), "float32")
    g = np.random.default_rng(8).standard_normal(
        (2, 9, tcfg.d_model)).astype(np.float32)
    jcos, jsin = JL.rope_table(9, tcfg.qk_rope_dim, tcfg.rope_theta)
    tcos, tsin = TL.rope_table(9, tcfg.qk_rope_dim, tcfg.rope_theta)

    def jloss(p, x):
        return jnp.sum(JL.mla_apply(p, jcfg, x, jcos, jsin) * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jl0, jx)
    x = tx.clone().requires_grad_()
    out = TL.mla_apply(tl0, tcfg, x, tcos, tsin)
    leaves = convert.leaves(tl0)
    grads = torch.autograd.grad((out * torch.tensor(g)).sum(), leaves + [x])
    want = jax.tree_util.tree_leaves(jgp) + [jgx]
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        assert _rel(got, w) <= 1e-4


@pytest.mark.parametrize("s", [5, 12])
def test_mla_decode_equals_a_longer_prefill(s, no_attention_kernels):
    """deepseek-v3 in fp32: the absorbed decode of token s after a
    prefill of s tokens gives the last-token logits of a prefill of s + 1
    tokens (the expanded attention) within 2e-5, at B = 2, and JAX's."""
    jcfg, tcfg, jm, tm, jp, tp = _models(MLA, "float32", seed=9)
    toks = np.random.default_rng(s).integers(0, tcfg.vocab, (2, s + 1))
    full, _ = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    _, caches = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :-1])})
    step, _ = tm.decode_step(tp, tpad(caches, s + 4),
                             torch.as_tensor(toks[:, -1:]), s)
    np.testing.assert_allclose(_np(step), _np(full), rtol=2e-5, atol=2e-5)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :-1], jnp.int32)})
    jstep, _ = jm.decode_step(jp, jpad(jc, s + 4),
                              jnp.asarray(toks[:, -1:], jnp.int32),
                              jnp.asarray(s, jnp.int32))
    _close(step, jstep, "float32")


def test_mla_caches_through_the_kv_cache_utilities():
    """The [dense-MLA, moe-MLA] group list: ``pad_to_length`` pads each
    group's c_kv and k_rope along their sequence axis as JAX's does,
    zeros past the prompt; ``alloc_like`` re-batches them."""
    jcfg, tcfg, jm, tm, jp, tp = _models(MLA, "float32", seed=1)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (1, 7))
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    _, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    jc, tc = jpad(jc, 20), tpad(tc, 20)
    n = [g.n for g in tm.groups]
    assert n == [tcfg.first_dense_layers,
                 tcfg.n_layers - tcfg.first_dense_layers]
    for ni, tg, jg in zip(n, tc, jc):
        assert tuple(tg["c_kv"].shape) == (ni, 1, 20, tcfg.kv_lora_rank)
        assert tuple(tg["k_rope"].shape) == (ni, 1, 20, tcfg.qk_rope_dim)
        for key in tg:
            _close(tg[key], jg[key], "float32")
            assert not tg[key][:, :, 7:].any()
    again = alloc_like(tc, batch=3)
    for tg, ag in zip(tc, again):
        for key in tg:
            assert ag[key].shape == (tg[key].shape[0], 3,
                                     *tg[key].shape[2:])
            assert ag[key].dtype == tg[key].dtype and not ag[key].any()


# ------------------------------ vlm patches --------------------------------

def _vlm_batch(tcfg, jcfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, tcfg.vocab, (b, s + 1))
    pe = np.random.default_rng(seed + 1).standard_normal(
        (b, tcfg.frontend_tokens, tcfg.d_model)).astype(np.float32)
    pe = np.asarray(jnp.asarray(pe, jcfg.dtype), np.float32)
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32),
          "patch_embeds": jnp.asarray(pe, jcfg.dtype)}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "labels": torch.as_tensor(toks[:, 1:]),
          "patch_embeds": torch.tensor(pe, dtype=tcfg.dtype)}
    return jb, tb


@pytest.mark.parametrize("mode", ["loss", "prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_patch_embeddings_match_jax(mode, dtype):
    """internvl2 with ``patch_embeds`` prepended: the loss and its
    gradients (the patch positions dropped before the head, so the labels
    stay the tokens'), prefill's logits and caches (P + S positions), and
    a decode step after it at position P + S."""
    jcfg, tcfg, jm, tm, jp, tp = _models(VLM, dtype, seed=2)
    b, s = 2, 10
    p = tcfg.frontend_tokens
    jb, tb = _vlm_batch(tcfg, jcfg, b, s, seed=11)
    with _reference(dtype):
        if mode == "loss":
            jloss, jg = jax.value_and_grad(jm.loss_fn)(jp, jb)
            loss, grads = value_and_grad(tm, tp, tb)
            assert abs(float(loss) - float(jloss)) <= \
                LOSS_TOL[dtype] * abs(float(jloss))
            got = convert.to_numpy(grads)
            for path, w in jax.tree_util.tree_flatten_with_path(jg)[0]:
                gl = got
                for k in path:
                    gl = gl[k.key]
                assert _rel(gl, w) <= GRAD_TOL[dtype], \
                    (jax.tree_util.keystr(path), _rel(gl, w))
            return
        pre = {k: v for k, v in jb.items() if k != "labels"}
        jl, jc = jm.prefill(jp, pre)
        tl, tc = tm.prefill(tp, {k: v for k, v in tb.items()
                                 if k != "labels"})
        assert tc[0]["k"].shape[3] == p + s
        _close(tl, jl, dtype)
        for key in ("k", "v"):
            _close(tc[0][key], jc[0][key], dtype)
        if mode == "prefill":
            return
        tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]
        jd, _ = jm.decode_step(jp, jpad(jc, p + s + 4),
                               jnp.asarray(tok, jnp.int32),
                               jnp.asarray(p + s, jnp.int32))
        td, _ = tm.decode_step(tp, tpad(tc, p + s + 4), torch.as_tensor(tok),
                               p + s)
        _close(td, jd, dtype)


# ---------------------------- params, configs ------------------------------

def test_new_leaves_convert_and_round_trip():
    """deepseek-v3's params: MLA's leaves in both groups, the dense
    prefix's MLP and the MoE group's shared expert; JAX's params convert
    leaf for leaf (dtypes kept) and back exactly, and the port's seeded
    init has JAX's tree, shapes and dtypes."""
    jcfg, tcfg, _, tm, jp, tp = _models(MLA, "bfloat16")
    mla = {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert set(tp["g0"]["attn"]) == set(tp["g1"]["attn"]) == mla
    assert set(tp["g0"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(tp["g1"]) == {"ln1", "attn", "ln2", "moe"}
    assert set(tp["g1"]["moe"]["shared"]) == {"wg", "wu", "wd"}
    assert tp["g0"]["attn"]["q_norm"]["w"].dtype == torch.float32
    assert tp["g1"]["attn"]["wkv_b"].dtype == torch.bfloat16
    assert tp["g1"]["moe"]["router"].dtype == torch.float32
    back = convert.to_numpy(tp)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(convert.leaves(tp))
    for (path, want), got, t in zip(flat, jax.tree_util.tree_leaves(back),
                                    convert.leaves(tp)):
        assert str(t.dtype).split(".")[-1] == str(want.dtype), path
        np.testing.assert_array_equal(got, np.asarray(want, np.float32),
                                      err_msg=str(path))
    own = tm.init(0, "cpu")
    spec = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(own) == \
        jax.tree_util.tree_structure(spec)
    for t, s in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(spec)):
        assert tuple(t.shape) == s.shape
        assert str(t.dtype).split(".")[-1] == str(s.dtype)
    again = convert.from_jax(convert.to_numpy(own), "cpu")
    for a, b in zip(convert.leaves(own), convert.leaves(again)):
        assert torch.equal(a.float(), b.float())


def test_shapes_match_jax():
    """``configs/shapes.py``: the four input shapes, the families that
    run the 500k cell, and ``applicable`` for every arch and shape."""
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC_FAMILIES == jshapes.SUBQUADRATIC_FAMILIES
    for arch in jconfigs.list_archs(False):
        jcfg = jconfigs.get_config(arch)
        tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        for name in shapes.SHAPES:
            assert shapes.applicable(tcfg, shapes.SHAPES[name]) == \
                jshapes.applicable(jcfg, jshapes.SHAPES[name]), (arch, name)


@pytest.mark.parametrize("arch", jconfigs.list_archs(False))
def test_active_param_count_matches_jax(arch):
    """``active_param_count`` (and ``param_count``) of the full and the
    reduced config, every arch of the registry: the port's own config
    where it is ported, a field-for-field copy of JAX's elsewhere."""
    for get in ("get_config", "get_reduced"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(configs, get)(arch) if arch in configs.PORTED \
            else ModelConfig(**dataclasses.asdict(j))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.active_param_count() == JConfig.active_param_count(j)
        assert t.param_count() == j.param_count()


def test_new_archs_are_the_published_shape():
    """The five configs at full size: GQA group sizes 3 / 3 / 8 / 6,
    parameter counts, and deepseek-v3's groups (3 dense MLA layers of
    d_ff 18432, then 58 MoE layers of 256 experts, top-8, one shared)."""
    got = {}
    for arch in NEW:
        cfg = configs.get_config(arch)
        got[arch] = (cfg.n_heads // cfg.n_kv_heads,
                     round(cfg.param_count() / 1e9, 2),
                     round(cfg.active_param_count() / 1e9, 2))
    assert got == {"minitron-4b": (3, 5.1, 5.1),
                   "phi4-mini-3.8b": (3, 4.45, 4.45),
                   "deepseek-67b": (8, 67.42, 67.42),
                   "internvl2-26b": (6, 19.88, 19.88),
                   "deepseek-v3-671b": (1, 671.05, 37.58)}
    ds = configs.get_config(MLA)
    assert [(g.kind, g.n, g.use_mla, g.ff, g.moe)
            for g in Model(ds).groups] == [("dense", 3, True, 18432, False),
                                           ("moe", 58, True, 0, True)]
    assert (ds.n_experts, ds.top_k, ds.n_shared_experts, ds.expert_ff) == \
        (256, 8, 1, 2048)


# ------------------------------ entry points -------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_entry_points_serve_and_train_the_new_archs(arch):
    """``launch.serve`` and ``launch.train`` take each new arch through
    ``PORTED``, at its reduced config on the CPU."""
    out = serve_entry.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--requests", "2", "--max-new", "3"])
    assert out["requests_done"] == 2 and out["tokens"] >= 6
    out = train_entry.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--steps", "3", "--batch", "2", "--seq", "8"])
    assert out["steps"] == 3 and np.isfinite(out["losses"]).all()
