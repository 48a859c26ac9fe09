"""The LM decode step as a compiled program (``repro_torch.serve.programs``,
the port's ``jax.jit(model.decode_step)``) and what it rests on, on the
CPU, where every entry runs the step eagerly on its buffers:

* ``Model.decode_step`` with the position a 0-d tensor (JAX's traced
  scalar) equals the host-int step bit for bit at every ported arch's
  reduced config in fp32, logits and caches, and equals the JAX
  package's ``decode_step`` within ``test_torch_lm.py``'s 2e-5 (the SSM
  and hybrid families to 2e-5 of the largest logit, as their tests hold
  them);
* ``grouped_ffn``'s static dispatch against JAX's ``grouped_ffn`` with
  copies dropped at the capacity, invalid copies and the dp ``offsets``
  (modelled in JAX by copies of earlier tokens routed first), and the
  gathered-expert path (T k <= E) against the (E, C, d) one;
* ``decode_step`` and ``grouped_ffn`` on ``meta`` tensors, through the
  plain attention and router functions: a value read to the host
  (``.tolist()``, ``.item()``, ``float()``) raises there, so none is;
* the engine keeps one entry a slot however many requests and positions
  go through it, beside the JAX engine's ``_decode._cache_size()`` of 1;
  another cache tree is another entry, and an entry holds no caller's
  tensor alive;
* the plain split-and-merge at the split of the cache's length S, with
  finite stale keys and values past ``kv_len`` (host int or tensor),
  equals ``decode_attention_ref``.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as JMoe
from repro.models.lm import Model as JModel
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.kv_cache import pad_to_length as jpad
from repro_torch import configs, convert
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.decode_attention.ops import decode_split
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_split_ref
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.mamba_scan import mamba_scan_with_state_ref
from repro_torch.kernels.moe_router import moe_router_ref
from repro_torch.models import backend
from repro_torch.models import moe as TMoe
from repro_torch.models.lm import Model
from repro_torch.serve import programs as serve_programs
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.serve.kv_cache import load_into, pad_to_length, \
    zeros_padded

SCALED = ("ssm", "hybrid")      # held to 2e-5 of the largest logit
TOL = 2e-5
PROMPT, STEPS, MAX_LEN = 9, 3, 16


@pytest.fixture(autouse=True)
def one_thread():
    """Many tiny ops (the plain scan's loop): one intra-op thread keeps
    them fast under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _batch(cfg, toks):
    batch = {"tokens": torch.as_tensor(toks)}
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.tensor(np.random.default_rng(
            7).standard_normal((1, cfg.frontend_tokens, cfg.d_model),
                               np.float32))
    return batch


@pytest.mark.parametrize("arch", configs.PORTED)
def test_tensor_position_decode_equals_host_int_and_jax(arch):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              param_dtype="float32")
    jm, tm = JModel(jcfg), Model(cfg)
    tp = tm.init(3, "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, PROMPT))
    tl, tc = tm.prefill(tp, _batch(cfg, toks))
    tok = int(torch.argmax(tl[0, -1]))
    # the JAX step from the same params and caches, at a traced position
    jp, jc = (jax.tree_util.tree_map(jnp.asarray, convert.to_numpy(t))
              for t in (tp, tc))
    jl, _ = jax.jit(jm.decode_step)(jp, jpad(jc, MAX_LEN),
                                    jnp.asarray([[tok]], jnp.int32),
                                    jnp.asarray(PROMPT, jnp.int32))
    host = convert.tree_map(torch.clone, pad_to_length(tc, MAX_LEN))
    dev = convert.tree_map(torch.clone, host)
    for i in range(STEPS):
        pos = PROMPT + i
        hl, _ = tm.decode_step(tp, host, torch.tensor([[tok]]), pos)
        tl, _ = tm.decode_step(tp, dev, torch.tensor([[tok]]),
                               torch.tensor(pos))
        assert torch.equal(tl, hl), i
        if i == 0:   # the JAX step at the traced position
            want = np.asarray(jl)
            err = np.abs(_np(tl).astype(np.float64) - want).max()
            scale = np.abs(want).max()
            assert err <= TOL * (scale if cfg.family in SCALED
                                 else 1.0 + scale), err
        tok = int(torch.argmax(tl[0, -1]))
    for a, b in zip(convert.leaves(dev), convert.leaves(host)):
        assert torch.equal(a, b)


# ------------------------------ the dispatch -------------------------------


_jax_grouped_ffn = jax.jit(JMoe.grouped_ffn, static_argnums=7)


def _experts(rng, e, d, f):
    wg, wu = (rng.standard_normal((e, d, f)).astype(np.float32)
              for _ in range(2))
    return wg, wu, rng.standard_normal((e, f, d)).astype(np.float32)


@pytest.mark.parametrize("t,k,e,cap", [(40, 2, 4, 8), (30, 3, 8, 8),
                                       (3, 2, 8, 1), (1, 8, 16, 8)])
def test_static_dispatch_matches_jax(t, k, e, cap):
    """Dropped copies (capacity under the busiest expert's copies where
    T is large; 1 where T k <= E, which takes the gathered path) and
    invalid copies, against JAX's ``grouped_ffn``."""
    rng = np.random.default_rng(t * k + e)
    d, f = 8, 6
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    idx[: t // 2, 0] = 0                        # expert 0 overflows
    valid = rng.random((t, k)) < 0.75
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.random((t, k)).astype(np.float32)
    wg, wu, wd = _experts(rng, e, d, f)
    for v in (np.ones((t, k), bool), valid):
        want = _jax_grouped_ffn(*(jnp.asarray(a) for a in (
            x, idx, w, v, wg, wu, wd)), cap)
        got = TMoe.grouped_ffn(*(torch.from_numpy(a) for a in (
            x, idx, w, wg, wu, wd)), cap, valid=torch.from_numpy(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap", [4, 8, 16])
def test_offsets_count_against_the_capacity_as_earlier_copies(cap):
    """``offsets[e]`` copies of expert e ahead of these tokens (another dp
    process's): JAX's ``grouped_ffn`` over those copies put first (one
    valid copy each), then the tokens, gives the same output rows."""
    rng = np.random.default_rng(cap)
    t, k, e, d, f = 24, 2, 4, 8, 6
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.random((t, k)).astype(np.float32)
    wg, wu, wd = _experts(rng, e, d, f)
    off = np.array([3, 0, 7, 1])
    pre = np.repeat(np.arange(e), off)
    n = len(pre)
    jidx = np.concatenate([np.stack([pre, (pre + 1) % e], 1), idx])
    jvalid = np.concatenate([np.tile([True, False], (n, 1)),
                             np.ones((t, k), bool)])
    jx = np.concatenate([np.zeros((n, d), np.float32), x])
    jw = np.concatenate([np.zeros((n, k), np.float32), w])
    want = _jax_grouped_ffn(*(jnp.asarray(a) for a in (
        jx, jidx, jw, jvalid, wg, wu, wd)), cap)[n:]
    got = TMoe.grouped_ffn(*(torch.from_numpy(a) for a in (
        x, idx, w, wg, wu, wd)), cap, offsets=torch.from_numpy(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gathered_experts_equal_the_capacity_buffer():
    """T k <= E takes the gathered path: the same copies through experts
    padded with unused ones (more E, the gathered path) and through the
    experts alone (T k > E, the (E, C, d) buffer) agree, drops included."""
    rng = np.random.default_rng(0)
    t, k, e, d, f = 3, 2, 4, 8, 6
    idx = torch.tensor([[0, 1], [0, 2], [0, 3]])
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((t, d), (t, k)))
    wg, wu, wd = (torch.from_numpy(a) for a in _experts(rng, e, d, f))
    pad = [torch.cat([a, torch.zeros(8, *a.shape[1:])]) for a in (wg, wu,
                                                                 wd)]
    for cap in (1, 2, 8):
        buffer = TMoe.grouped_ffn(x, idx, w, wg, wu, wd, cap)   # 6 > 4
        gathered = TMoe.grouped_ffn(x, idx, w, *pad, cap)       # 6 <= 12
        torch.testing.assert_close(gathered, buffer, rtol=1e-6,
                                   atol=1e-6)


# ------------------------- no host read (meta) -----------------------------


@pytest.fixture
def plain_backend(monkeypatch):
    """The plain attention, decode, scan and router functions, which run
    on any device (the kernels' wrappers take CUDA or CPU tensors)."""
    monkeypatch.setattr(backend, "attention",
                        lambda q, k, v, *, causal=True:
                        attention_ref(q, k, v, causal=causal))
    monkeypatch.setattr(backend, "decode_attention",
                        lambda q, k, v, *, kv_len:
                        decode_attention_ref(q, k, v, kv_len=kv_len))
    monkeypatch.setattr(backend, "mamba_scan_with_state",
                        mamba_scan_with_state_ref)
    monkeypatch.setattr(backend, "moe_router", moe_router_ref)


def test_meta_tensors_refuse_a_host_read():
    t = torch.zeros(3, device="meta")
    for read in (t.tolist, t.sum().item, lambda: float(t.sum())):
        with pytest.raises(Exception):
            read()


@pytest.mark.parametrize("arch", configs.PORTED)
def test_decode_step_reads_nothing_to_the_host(arch, plain_backend):
    cfg = configs.get_reduced(arch)
    model = Model(cfg)
    params = model.init(0, "meta")
    batch = {"tokens": torch.zeros(1, 5, dtype=torch.long, device="meta")}
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.zeros(
            1, cfg.frontend_tokens, cfg.d_model, device="meta")
    _, pre = model.prefill(params, batch)
    logits, _ = model.decode_step(
        params, zeros_padded(pre, 16),
        torch.zeros(1, 1, dtype=torch.long, device="meta"),
        torch.zeros((), dtype=torch.long, device="meta"))
    assert logits.device.type == "meta"
    assert logits.shape == (1, 1, cfg.padded_vocab)


@pytest.mark.parametrize("t", [1, 40])
def test_grouped_ffn_reads_nothing_to_the_host(t):
    """Both paths (T k = 2 <= E = 8 gathers; 80 > 8 fills the buffer),
    with invalid copies and offsets."""
    e, d, f, k = 8, 16, 12, 2
    meta = dict(device="meta")
    out = TMoe.grouped_ffn(
        torch.zeros(t, d, **meta), torch.zeros(t, k, dtype=torch.long,
                                               **meta),
        torch.zeros(t, k, **meta), torch.zeros(e, d, f, **meta),
        torch.zeros(e, d, f, **meta), torch.zeros(e, f, d, **meta), 8,
        valid=torch.zeros(t, k, dtype=torch.bool, **meta),
        offsets=torch.zeros(e, dtype=torch.long, **meta))
    assert out.shape == (t, d) and out.device.type == "meta"


# ------------------------------ the engine ---------------------------------


def _entries(model):
    return [e for e in serve_programs.DECODE_STEP._entries.values()
            if e.key[0] is model]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b"])
def test_engine_keeps_one_entry_a_slot(arch):
    """Two rounds of requests of several lengths through two slots: two
    entries in the port (one a slot's caches), the JAX engine's jitted
    step compiled once; equal token streams."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              param_dtype="float32")
    jm, model = JModel(jcfg), Model(cfg)
    params = model.init(0, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, convert.to_numpy(params))
    jeng = JEngine(jm, jp, JEngineConfig(2, 40))
    eng = Engine(model, params, EngineConfig(2, 40))
    rng = np.random.default_rng(2)
    for rnd in range(2):
        prompts = [rng.integers(0, cfg.vocab, n) for n in (3, 11, 6)]
        streams = []
        for e, req in ((jeng, JRequest), (eng, Request)):
            for i, p in enumerate(prompts):
                e.submit(req(req_id=10 * rnd + i, tokens=p, max_new=5))
            streams.append({r.req_id: r.out for r in e.run()})
        assert streams[0] == streams[1]
        assert len(_entries(model)) == 2
        assert jeng._decode._cache_size() == 1


def test_another_cache_tree_is_another_entry_and_none_is_kept_alive():
    cfg = dataclasses.replace(configs.get_reduced("yi-6b"),
                              param_dtype="float32")
    model = Model(cfg)
    params = model.init(0, "cpu")
    toks = torch.arange(5)[None]
    _, pre = model.prefill(params, {"tokens": toks})
    trees = [zeros_padded(pre, 16) for _ in range(2)]
    for c in trees:
        load_into(c, pre)
    got = [serve_programs.decode_step(model, params, c, toks[:, -1:], 5)
           for c in trees]
    assert torch.equal(got[0], got[1])
    assert len(_entries(model)) == 2
    watch = weakref.ref(trees[0][0]["k"])
    del trees[0], c
    gc.collect()
    assert watch() is None            # no entry kept the caches alive
    assert sum(e.alive() for e in _entries(model)) == 1
    third = zeros_padded(pre, 16)
    serve_programs.decode_step(model, params, third, toks[:, -1:], 5)
    assert len(_entries(model)) == 2  # the dead entry was dropped
    with pytest.raises(ValueError):   # an entry runs on its own tensors
        _entries(model)[-1].run(params, trees[0])


# ---------------------- the split over the cache's S -----------------------


@pytest.mark.parametrize("s,kvlen", [(512, 1), (512, 28), (512, 256),
                                     (512, 512), (300, 137)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_split_over_s_with_stale_rows_equals_the_plain_version(s, kvlen,
                                                               as_tensor):
    """The device-``kv_len`` launch's split: over all S rows, the rows
    past kv_len holding another request's (finite) keys and values."""
    g = torch.Generator().manual_seed(s + kvlen)
    q, k, v = (torch.randn(sh, generator=g) for sh in (
        (1, 8, 64), (1, 2, s, 64), (1, 2, s, 64)))
    n_splits, split_keys = decode_split(2, s, 132)
    assert n_splits * split_keys >= s
    kv = torch.tensor(kvlen) if as_tensor else kvlen
    got = decode_attention_split_ref(q, k, v, kv_len=kv, n_splits=n_splits,
                                     split_keys=split_keys)
    want = decode_attention_ref(q, k, v, kv_len=kvlen)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
