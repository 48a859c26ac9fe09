"""The trainer's step as a compiled program (``repro_torch.train.programs``,
the port's ``jax.jit(make_train_step(...))``, what ``Trainer.compile_step``
returns without a mesh) on the CPU, where its entry runs the step
eagerly on the entry's buffers:

* three compiled steps equal three eager ``make_train_step`` steps bit
  for bit (every loss, every param, every moment and the step counter)
  for one reduced arch of each family (dense, MoE, MLA, SSM, vlm with
  patch embeddings, encdec with frame embeddings, hybrid), with AdamW
  and AdaFactor, at ``n_micro`` 1 and 2; and the same steps match JAX's
  jitted step from the same params within the repo's training bounds:
  each loss within 1e-5 relative, the params within 1e-4 relative in
  norm over the whole tree (observed <= 2.9e-6).  The schedule is
  ``launch.train``'s (lr 3e-3, 5 warmup steps).  At lr 1e-2 with 2 warmup
  steps the MLA and hybrid archs' embeddings part from JAX's by 1.5e-3
  and 2.2e-3 of their norm by step 3 while step 1's gradients agree to
  1.5e-6: Adam's normalisation and near-tied routing amplify the fp32
  noise.  A leaf near zero (the SSM's ``dt_bias``, norm 0.01) moves by
  one bf16 rounding of AdaFactor's first moment in one element, up to
  2.9e-4 of its own norm, which is why the bound is the tree's;
* ``make_train_step`` on ``meta`` tensors for every ported arch, both
  optimizers, two microbatches, through the plain attention, router and
  scan: a value read to the host raises there, so the step reads none
  (what a CUDA graph of it needs);
* the loss and its gradient draw no random numbers (the checkpoints keep
  no generator state: ``models/lm.py``);
* the entry count: one entry for a run of steps on one state (JAX's
  ``_cache_size()`` 1); a new batch shape adds one in both; another state
  tree (a restore) adds one in the port only, the dead tree's entry is
  dropped by the next lookup of a new key (or ``prune``), and no entry
  keeps a caller's tensor alive;
* the step hands back the caller's own trees, advances the step counter
  in place, and returns fresh metrics each step;
* ``launch.train`` through the compiled step: ``--n-micro 2`` equals the
  eager step's losses, and a resumed run makes one entry, alive only
  while the run holds its state.
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
from repro.models.lm import Model as JModel
from repro.train import optimizer as JOpt
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticLM as JSyntheticLM
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch import configs, convert
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.mamba_scan import mamba_scan_ref
from repro_torch.kernels.moe_router import moe_router_ref
from repro_torch.launch import train as train_entry
from repro_torch.models import backend
from repro_torch.models.lm import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as Opt
from repro_torch.train import programs as train_programs
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.trainer import (TrainConfig, Trainer, make_train_step,
                                       value_and_grad)

# one reduced arch of each family
FAMILIES = {"dense": "yi-6b", "moe": "qwen3-moe-30b-a3b",
            "mla": "deepseek-v3-671b", "ssm": "falcon-mamba-7b",
            "vlm": "internvl2-26b", "encdec": "seamless-m4t-large-v2",
            "hybrid": "jamba-1.5-large-398b"}
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=100)
STEPS, BATCH, SEQ, PATCHES = 3, 4, 16, 3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the embedding's backward accumulates in
    another order with several, and these tests run many tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy()


def _extras(cfg, i: int) -> dict:
    """Step i's seeded patch (vlm) or frame (encdec) embeddings."""
    rng = np.random.default_rng(100 + i)
    if cfg.family == "vlm":
        return {"patch_embeds": rng.standard_normal(
            (BATCH, PATCHES, cfg.d_model), np.float32)}
    if cfg.family == "encdec":
        return {"frame_embeds": rng.standard_normal(
            (BATCH, cfg.frontend_tokens, cfg.d_model), np.float32)}
    return {}


def _batches(cfg) -> list[dict]:
    """The same batches for both packages, as numpy."""
    data = JSyntheticLM(JDataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                    global_batch=BATCH))
    return [dict({k: np.asarray(v) for k, v in data.batch(i).items()},
                 **_extras(cfg, i)) for i in range(STEPS)]


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in
            b.items()}


def _tensors(tree) -> list:
    return [t for t in convert.leaves(tree) if t is not None]


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_compiled_steps_equal_eager_and_jax(family, kind, n_micro):
    arch = FAMILIES[family]
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              param_dtype="float32")
    jm, model = JModel(jcfg), Model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    start = jax.tree_util.tree_map(np.asarray, jp)
    ocfg, tcfg = Opt.OptConfig(kind=kind, **OPT), TrainConfig(n_micro)
    tr = Trainer(model, mesh=None, opt_cfg=ocfg, tcfg=tcfg, device="cpu")
    compiled, eager = tr.compile_step(), make_train_step(model, ocfg, tcfg)
    p, q = (convert.from_jax(start, "cpu") for _ in range(2))
    s, t = Opt.init(ocfg, p), Opt.init(ocfg, q)
    jocfg = JOpt.OptConfig(kind=kind, **OPT)
    jstep = jax.jit(j_make_train_step(jm, jocfg, JTrainConfig(n_micro)))
    js = JOpt.init(jocfg, jp)
    for i, b in enumerate(_batches(cfg)):
        _, _, mc = compiled(p, s, _torch_batch(b))
        q, t, me = eager(q, t, _torch_batch(b))
        jp, js, jmet = jstep(jp, js, b)
        assert torch.equal(mc["loss"], me["loss"]), (i, mc, me)
        jl = float(jmet["loss"])
        assert abs(float(mc["loss"]) - jl) <= 1e-5 * abs(jl), (i, mc, jl)
    assert all(torch.equal(a, b) for a, b in zip(convert.leaves(p),
                                                 convert.leaves(q)))
    assert all(torch.equal(a, b) for a, b in zip(_tensors(s), _tensors(t)))
    assert int(s.step) == STEPS
    num = den = 0.0
    worst = []      # each leaf's own error, shown when the bound fails
    for path, w in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = p
        for k in path:
            node = node[k.key]
        w = np.asarray(w, np.float64)
        d2, w2 = np.sum((_np(node) - w) ** 2), np.sum(w ** 2)
        num, den = num + d2, den + w2
        worst.append(((d2 / w2) ** 0.5, jax.tree_util.keystr(path)))
    assert (num / den) ** 0.5 <= 1e-4, sorted(worst)[-3:]


@pytest.fixture
def plain_backend(monkeypatch):
    """The plain attention, router and scan, which run on any device."""
    monkeypatch.setattr(backend, "attention",
                        lambda q, k, v, *, causal=True:
                        attention_ref(q, k, v, causal=causal))
    monkeypatch.setattr(backend, "moe_router", moe_router_ref)
    monkeypatch.setattr(backend, "mamba_scan", mamba_scan_ref)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", configs.PORTED)
def test_train_step_reads_nothing_to_the_host(arch, kind, plain_backend):
    cfg = configs.get_reduced(arch)
    model = Model(cfg)
    ocfg = Opt.OptConfig(kind=kind, **OPT)
    params = model.init(0, "meta")
    state = Opt.init(ocfg, params)
    meta = dict(device="meta")
    batch = {k: torch.zeros(BATCH, SEQ, dtype=torch.long, **meta)
             for k in ("tokens", "labels")}
    batch.update({k: torch.zeros(v.shape, **meta)
                  for k, v in _extras(cfg, 0).items()})
    _, new, m = make_train_step(model, ocfg, TrainConfig(n_micro=2))(
        params, state, batch)
    assert all(v.device.type == "meta" and v.dim() == 0 for v in m.values())
    assert new.step.device.type == "meta"


@pytest.mark.parametrize("arch", configs.PORTED)
def test_the_loss_draws_no_random_numbers(arch):
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              param_dtype="float32")
    model = Model(cfg)
    params = model.init(0, "cpu")
    torch.manual_seed(1)
    before = torch.get_rng_state()
    batch = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in
             _batches(cfg)[0].items()}
    loss, grads = value_and_grad(model, params, batch)
    assert torch.isfinite(loss)
    assert torch.equal(torch.get_rng_state(), before)


# ------------------------------ the entries --------------------------------


def _entries(model) -> list:
    return [e for e in train_programs.TRAIN_STEP._entries.values()
            if e.key[0] is model]


def _setup(arch="yi-6b", kind="adamw"):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              param_dtype="float32")
    ocfg = Opt.OptConfig(kind=kind, **OPT)
    tr = Trainer(Model(cfg), mesh=None, opt_cfg=ocfg, device="cpu")
    jstep = jax.jit(j_make_train_step(JModel(jcfg), JOpt.OptConfig(
        kind=kind, **OPT), JTrainConfig()))
    return cfg, tr, jstep


def _batch(cfg, seq, i):
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=BATCH), device="cpu").batch(i)


def test_entries_follow_state_trees_and_batch_shapes(tmp_path):
    cfg, tr, jstep = _setup()
    step, model = tr.compile_step(), tr.model
    params, state = tr.init_state(0)
    jp = jax.tree_util.tree_map(jnp.asarray, convert.to_numpy(params))
    js = JOpt.init(JOpt.OptConfig(**OPT), jp)
    jdata = {s: JSyntheticLM(JDataConfig(vocab=cfg.vocab, seq_len=s,
                                         global_batch=BATCH))
             for s in (SEQ, 2 * SEQ)}
    for i in range(3):                # a run of steps on one state
        step(params, state, _batch(cfg, SEQ, i))
        jp, js, _ = jstep(jp, js, jdata[SEQ].batch(i))
    assert len(_entries(model)) == jstep._cache_size() == 1
    step(params, state, _batch(cfg, 2 * SEQ, 3))   # a new batch shape
    jp, js, _ = jstep(jp, js, jdata[2 * SEQ].batch(3))
    assert len(_entries(model)) == jstep._cache_size() == 2
    # another state tree: the checkpoint restored
    ckpt.save(str(tmp_path), 4, (params, state))
    restored = ckpt.restore(str(tmp_path), 4, (params, state))
    watch = [weakref.ref(t) for t in (convert.leaves(params)[0],
                                      state.step)]
    params, state = restored[0], Opt.OptState(*restored[1])
    del restored
    gc.collect()
    assert all(w() is None for w in watch)   # no entry kept them alive
    assert sum(e.alive() for e in _entries(model)) == 0
    step(params, state, _batch(cfg, SEQ, 4))
    jp, js, _ = jstep(jp, js, jdata[SEQ].batch(4))
    # the new tree's entry; the dead tree's two were dropped by its lookup
    assert len(_entries(model)) == 1 and _entries(model)[0].alive()
    assert jstep._cache_size() == 2          # JAX traces, it does not bind
    step(params, state, _batch(cfg, 2 * SEQ, 5))
    assert len(_entries(model)) == 2
    watch = weakref.ref(state.step)
    del params, state
    gc.collect()
    assert watch() is None
    with train_programs.programs.LOCK:
        assert train_programs.TRAIN_STEP.prune() >= 2
    assert not _entries(model)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_the_step_returns_the_callers_trees_and_fresh_metrics(kind):
    cfg, tr, _ = _setup("falcon-mamba-7b", kind)
    step = tr.compile_step()
    params, state = tr.init_state(0)
    counter, kept, losses = state.step, [], []
    for i in range(STEPS):
        p, s, m = step(params, state, _batch(cfg, SEQ, i))
        assert p is params and s is state and s.step is counter
        assert int(counter) == i + 1
        kept.append(m)
        losses.append(float(m["loss"]))
    assert [float(m["loss"]) for m in kept] == losses
    assert len(set(losses)) == STEPS
    ptrs = {m[k].data_ptr() for m in kept for k in m}
    assert len(ptrs) == 3 * STEPS            # nothing shared between steps
    assert float(kept[0]["lr"]) < float(kept[1]["lr"])   # the warmup


def test_launch_train_with_microbatches_equals_the_eager_step():
    argv = ["--arch", "falcon-mamba-7b", "--reduced", "--steps", "4",
            "--batch", "4", "--seq", "16", "--n-micro", "2", "--device",
            "cpu"]
    out = train_entry.main(argv)
    cfg = configs.get_reduced("falcon-mamba-7b")
    model = Model(cfg)
    ocfg = Opt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=4)
    params = model.init(0, "cpu")
    state = Opt.init(ocfg, params)
    step = make_train_step(model, ocfg, TrainConfig(n_micro=2))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=4), device="cpu")
    losses = []
    for i in range(4):
        params, state, m = step(params, state, data.batch(i))
        losses.append(float(m["loss"]))
    assert out["losses"] == losses


def test_a_resumed_run_binds_one_entry_and_keeps_nothing(tmp_path,
                                                         monkeypatch):
    argv = ["--arch", "falcon-mamba-7b", "--reduced", "--steps", "6",
            "--batch", "2", "--seq", "16", "--device", "cpu", "--ckpt",
            str(tmp_path), "--ckpt-every", "2"]
    with pytest.raises(SystemExit):
        train_entry.main([*argv, "--kill-at", "3"])
    made = []
    real = train_programs.TRAIN_STEP.entry

    def entry(*a, **k):
        e = real(*a, **k)
        if not any(e is m for m in made):
            made.append(e)
        return e

    monkeypatch.setattr(train_programs.TRAIN_STEP, "entry", entry)
    out = train_entry.main([*argv, "--resume"])
    assert out["start"] == 2 and len(out["losses"]) == 4
    assert len(made) == 1                    # the restored tree's entry
    gc.collect()
    assert not made[0].alive()               # the run's state is gone
