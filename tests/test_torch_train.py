"""The port's training substrate (``train/data.py``, ``optimizer.py``,
``trainer.py``, ``launch/train.py``) against the JAX package's, on the
CPU, at falcon-mamba-7b's reduced config, and the trainer and driver
also at the dense (yi-6b, demo-100m) and MoE (qwen3-moe-30b-a3b) ones.

- ``SyntheticLM``: the same numpy draws, so the batches are equal.
- ``schedule`` and ``update`` (adamw with clipping, adafactor): on the
  same params and gradients, within the Tier-1 bound of
  ``tests/tolerance.py`` (rel 1e-5).  Only sums run in another order (the
  global norm, the factored means) and ``pow`` may differ by an ulp.  The
  params and first moments are held to 1e-5 of each leaf's largest
  magnitude rather than of each value: ``p - lr * step`` and
  ``b1 * m + (1 - b1) * g`` subtract numbers of the leaf's size, so a
  result near 0 carries their rounding (observed max 3e-8 absolute,
  ~4e-4 of a value near 0).
- Three ``make_train_step`` steps from converted params, fp32, adamw,
  for each family (ssm, dense, moe): losses within 1e-5 relative
  (observed ~1e-7) and every leaf of the params within 1e-5 relative in
  norm of JAX's jitted step (observed <= 2.7e-6: Adam's normalisation
  carries the gradients' fp32 noise into the update, and three steps
  compound it).
- ``launch/train.py`` against the JAX driver (``repro.launch.train``)
  from the JAX driver's own initial params, converted: the configs'
  bf16 and the same ``SyntheticLM`` batches, so every step's loss within
  1e-2 relative of the JAX driver's jitted step (observed <= 1.1e-3:
  XLA fuses the bf16 roundings, and Adam's first steps carry a bf16 ulp
  of a gradient into the update), the first within 1e-3 (observed <=
  2.4e-4).
- The port alone: microbatching, learning, ``launch/train.py`` and its
  checkpoint drill (``--kill-at`` exits 42, ``--resume`` repeats no
  step, so the resumed losses equal an uninterrupted run's bit for bit;
  3 checkpoints kept) and ``--simulate-stragglers`` against the JAX
  package's ``launch.train``.  The mesh trainer is held in
  ``test_torch_mesh_train.py``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro import configs as jconfigs
from repro.models.lm import Model as JModel
from repro.train import optimizer as JOpt
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticLM as JSyntheticLM
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import auto_n_micro as j_auto_n_micro
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch import configs, convert
from repro_torch.launch import train as train_entry
from repro_torch.models.lm import Model
from repro_torch.train import optimizer as Opt
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.trainer import (TrainConfig, Trainer, auto_n_micro,
                                       make_train_step)
from tolerance import TIER1_REL, assert_tier1

ARCH = "falcon-mamba-7b"


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


def _converted(dtype="float32", seed=0, arch=ARCH):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), param_dtype=dtype)
    tcfg = dataclasses.replace(configs.get_reduced(arch), param_dtype=dtype)
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, tm, jp, tp


def _close_to_scale(got, want, name):
    """Tier-1's relative bound against the leaf's largest magnitude."""
    got, want = _np(got), _np(want)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= TIER1_REL * np.abs(want).max(), (name, err)


def _pairs(jtree, ttree):
    """(path, JAX leaf, port leaf) in JAX's leaf order."""
    out = []
    for path, j in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        t = ttree
        for k in path:
            t = t[k.key]
        out.append((jax.tree_util.keystr(path), j, t))
    return out


# ---------------------------------- data -----------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,shards", [
    (256, 16, 4, 0, 1), (97, 9, 8, 3, 2), (65024, 32, 2, 5, 1)])
def test_synthetic_batches_equal_jax(vocab, seq, batch, seed, shards):
    for shard in range(shards):
        j = JSyntheticLM(JDataConfig(vocab=vocab, seq_len=seq,
                                     global_batch=batch, seed=seed),
                         shard_index=shard, shard_count=shards)
        t = SyntheticLM(DataConfig(vocab=vocab, seq_len=seq,
                                   global_batch=batch, seed=seed),
                        shard_index=shard, shard_count=shards, device="cpu")
        for step in (0, 1, 17):
            jb, tb = j.batch(step), t.batch(step)
            for k in ("tokens", "labels"):
                assert tb[k].dtype == torch.long
                assert tb[k].shape == (batch // shards, seq)
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_data_refuses_an_uneven_split_and_a_missing_card():
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(vocab=9, seq_len=4, global_batch=3),
                    shard_count=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SyntheticLM(DataConfig(vocab=9, seq_len=4, global_batch=2))


# -------------------------------- optimizer --------------------------------

def test_schedule_matches_jax():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=110,
                    min_lr_frac=0.1), dict(lr=3e-3, warmup_steps=5,
                                           total_steps=60)):
        steps = np.arange(0, kw["total_steps"] + 5)
        want = np.array([float(JOpt.schedule(JOpt.OptConfig(**kw),
                                             jnp.asarray(s)))
                         for s in steps], np.float32)
        got = np.array([float(Opt.schedule(Opt.OptConfig(**kw),
                                           torch.tensor(s, dtype=torch.int32)))
                        for s in steps], np.float32)
        assert_tier1(got, want, context=f"schedule {kw}")


def _grads(jp, norm, seed):
    """Random gradients in the params' dtypes, scaled to a global norm."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(jp)
    raw = [rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
    k = norm / np.sqrt(sum((r.astype(np.float64) ** 2).sum() for r in raw))
    g = [jnp.asarray(r * k, x.dtype) for r, x in zip(raw, leaves)]
    return jax.tree_util.tree_unflatten(tree, g)


@pytest.mark.parametrize("kind,norm", [("adamw", 5.0), ("adafactor", 0.5)])
@pytest.mark.parametrize("piece", [None, 100])
def test_update_matches_jax(kind, norm, piece, monkeypatch):
    """Two updates on the same params and gradients (adamw clipped,
    adafactor not, so its bf16 first moment rounds from equal values);
    ``piece`` cuts every leaf into pieces of at most that many values,
    which must change nothing."""
    if piece:
        monkeypatch.setattr(Opt, "_PIECE", piece)
    _, _, jp, tp = _converted()
    kw = dict(kind=kind, lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg, tcfg = JOpt.OptConfig(**kw), Opt.OptConfig(**kw)
    js, ts = JOpt.init(jcfg, jp), Opt.init(tcfg, tp)
    for step in range(2):
        jg = _grads(jp, norm, seed=step)
        tg = convert.from_jax(jax.tree_util.tree_map(np.asarray, jg), "cpu")
        jp, js, jm = JOpt.update(jcfg, jg, js, jp)
        tp, ts, tm = Opt.update(tcfg, tg, ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        assert_tier1(_np(tm["lr"]), _np(jm["lr"]), context="lr")
        assert_tier1(_np(tm["grad_norm"]), _np(jm["grad_norm"]),
                     context="grad_norm")
    for name, j, t in _pairs(jp, tp):
        assert t.dtype == torch.float32
        _close_to_scale(t, j, name)
    for name, j, t in _pairs(js.m, ts.m):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        _close_to_scale(t, j, f"m{name}")
    # the second moments add squares: no cancellation, value by value
    for field in (("v",) if kind == "adamw" else ("v_row", "v_col")):
        for name, j, t in _pairs(getattr(js, field), getattr(ts, field)):
            assert t.dtype == torch.float32, name
            assert_tier1(_np(t), _np(j), context=f"{field}{name}")


def test_update_keeps_bf16_params_bf16():
    _, _, jp, tp = _converted("bfloat16")
    cfg = Opt.OptConfig(lr=1e-2, warmup_steps=1)
    tg = convert.from_jax(jax.tree_util.tree_map(np.asarray,
                                                 _grads(jp, 1.0, 0)), "cpu")
    state = Opt.init(cfg, tp)
    dtypes = [t.dtype for t in jax.tree_util.tree_leaves(tp)]
    before = convert.tree_map(lambda t: t.clone(), tp)
    tp, state, _ = Opt.update(cfg, tg, state, tp)
    assert [t.dtype for t in jax.tree_util.tree_leaves(tp)] == dtypes
    assert all(m.dtype == torch.float32
               for m in jax.tree_util.tree_leaves(state.m))
    moved = [not torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(before))]
    assert all(moved)


def test_adafactor_state_smaller_than_adam():
    _, _, _, tp = _converted()
    size = lambda s: sum(x.numel() * x.element_size()  # noqa: E731
                         for x in jax.tree_util.tree_leaves(s))
    a = Opt.init(Opt.OptConfig(kind="adamw"), tp)
    f = Opt.init(Opt.OptConfig(kind="adafactor"), tp)
    assert size(f) < size(a) * 0.6


# --------------------------------- trainer ---------------------------------

@pytest.mark.parametrize("arch", [ARCH, "yi-6b", "qwen3-moe-30b-a3b"])
def test_three_train_steps_match_jax(arch):
    jm, tm, jp, tp = _converted(arch=arch)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=100)
    jstep = jax.jit(j_make_train_step(jm, JOpt.OptConfig(**kw),
                                      JTrainConfig()))
    tstep = make_train_step(tm, Opt.OptConfig(**kw), TrainConfig())
    jdata = JSyntheticLM(JDataConfig(vocab=256, seq_len=16, global_batch=4))
    tdata = SyntheticLM(DataConfig(vocab=256, seq_len=16, global_batch=4),
                        device="cpu")
    js, ts = JOpt.init(JOpt.OptConfig(**kw), jp), Opt.init(Opt.OptConfig(
        **kw), tp)
    for i in range(3):
        jp, js, jmet = jstep(jp, js, jdata.batch(i))
        tp, ts, tmet = tstep(tp, ts, tdata.batch(i))
        jl, tl = float(jmet["loss"]), float(tmet["loss"])
        assert abs(tl - jl) <= 1e-5 * abs(jl), (i, tl, jl)
    for name, j, t in _pairs(jp, tp):
        j = np.asarray(j, np.float64)
        err = np.linalg.norm(_np(t) - j) / np.linalg.norm(j)
        assert err <= 1e-5, (name, err)


def _setup(n_micro=1, kind="adamw", lr=1e-2, seq=16, batch=8):
    cfg = configs.get_reduced(ARCH)
    ocfg = Opt.OptConfig(kind=kind, lr=lr, warmup_steps=2, total_steps=100)
    trainer = Trainer(Model(cfg), mesh=None, opt_cfg=ocfg,
                      tcfg=TrainConfig(n_micro=n_micro), device="cpu")
    params, state = trainer.init_state(seed=0)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch), device="cpu")
    return trainer, params, state, data


def test_microbatch_equivalence():
    """n_micro = 4 accumulates the n_micro = 1 gradient (as the JAX
    package's test): with lr = 0 the first moments hold it."""
    trainer, params, _, data = _setup()
    ocfg = Opt.OptConfig(lr=0.0, warmup_steps=1, total_steps=10)
    batch = data.batch(0)
    outs = []
    for n in (1, 4):
        p = convert.tree_map(lambda t: t.clone(), params)
        step = make_train_step(trainer.model, ocfg, TrainConfig(n_micro=n))
        p, s, m = step(p, Opt.init(ocfg, p), batch)
        outs.append((m["loss"], s.m))
        for a, b in zip(jax.tree_util.tree_leaves(p),
                        jax.tree_util.tree_leaves(params)):
            assert torch.equal(a, b)
    np.testing.assert_allclose(float(outs[1][0]), float(outs[0][0]),
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(outs[0][1]),
                    jax.tree_util.tree_leaves(outs[1][1])):
        np.testing.assert_allclose(_np(b), _np(a), rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("kind,steps,frac", [("adamw", 60, 0.8),
                                             ("adafactor", 40, 1.0)])
def test_loss_decreases(kind, steps, frac):
    """End-to-end learning on the structured synthetic data (the JAX
    package's ``test_loss_decreases`` and adafactor test, on the SSM)."""
    trainer, params, state, data = _setup(kind=kind)
    step = trainer.compile_step()
    losses = []
    for i in range(steps):
        params, state, m = step(params, state, data.batch(i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * frac, (losses[0], losses[-1])


def test_auto_n_micro_matches_jax():
    for args in ((256, 4096, 256000, 16), (256, 4096, 256000, 32),
                 (8, 128, 1000, 1), (64, 512, 65536, 1)):
        for kw in ({}, dict(n_model=16, n_layers=32, d_model=4096)):
            assert auto_n_micro(*args, **kw) == j_auto_n_micro(*args, **kw)


# --------------------------------- driver ----------------------------------

def test_launch_train_runs_reduced_on_the_cpu():
    out = train_entry.main(["--arch", ARCH, "--reduced", "--steps", "6",
                            "--batch", "2", "--seq", "8", "--device", "cpu"])
    assert out["steps"] == 6
    assert np.isfinite([out["first_loss"], out["last_loss"]]).all()


# the checkpoint drill: checkpoints at steps 3 and 6, killed after step 7,
# resumed from step 6 to the end (checkpoints 9 and 12; 3 are kept)
DRILL = ["--arch", ARCH, "--reduced", "--steps", "12", "--batch", "2",
         "--seq", "8", "--device", "cpu", "--ckpt-every", "3"]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ck = str(tmp_path_factory.mktemp("ck"))
        full = train_entry.main(DRILL)
        with pytest.raises(SystemExit) as killed:
            train_entry.main([*DRILL, "--ckpt", ck, "--kill-at", "7"])
        after_kill = sorted(os.listdir(ck))
        resumed = train_entry.main([*DRILL, "--ckpt", ck, "--resume"])
        return dict(full=full, code=killed.value.code, after_kill=after_kill,
                    resumed=resumed, ck=ck)
    finally:
        torch.set_num_threads(n)


def test_kill_at_exits_42_and_leaves_checkpoints(drill):
    assert drill["code"] == 42
    assert drill["after_kill"] == ["step_00000003", "step_00000006"]
    manifest = json.load(open(os.path.join(drill["ck"], "step_00000012",
                                           "manifest.json")))
    assert "bfloat16" in manifest["dtypes"] and "int32" in manifest["dtypes"]


def test_resume_starts_from_the_latest_step(drill):
    assert drill["resumed"]["start"] == 6
    assert drill["resumed"]["steps"] == 12 - 6


def test_resumed_losses_equal_an_uninterrupted_run(drill):
    """The checkpoint of step 6 holds the state entering step 6: the
    resumed run repeats no step, so its losses are the uninterrupted
    run's, bit for bit."""
    assert drill["resumed"]["losses"] == drill["full"]["losses"][6:]
    assert len(drill["full"]["losses"]) == 12


def test_ckpt_every_retention_keeps_3(drill):
    assert sorted(os.listdir(drill["ck"])) == [
        "step_00000006", "step_00000009", "step_00000012"]


STRAGGLERS = ["--reduced", "--steps", "12", "--batch", "2", "--seq", "16",
              "--simulate-stragglers", "--n-hosts", "16"]


def _recorded(module, monkeypatch) -> list:
    """Put ``chip_smoke.recording_runtime``'s subclass in place of
    ``module``'s (a ``launch.train``) runtime; returns the list the
    runtimes it builds are appended to."""
    recorded, made = chip_smoke.recording_runtime(module.StragglerRuntime)
    monkeypatch.setattr(module, "StragglerRuntime", recorded)
    return made


def _acting(module, monkeypatch) -> list:
    """As :func:`_recorded`, with a runtime that acts on the driver's
    trace: k = 1 puts K at the fitted mean, so E_S is several hosts and
    hosts past K three steps running are evicted."""
    recorded, made = chip_smoke.recording_runtime(module.StragglerRuntime)

    class Acting(recorded):
        def __init__(self, cfg, *a, **kw):
            super().__init__(dataclasses.replace(cfg, k=1.0), *a, **kw)

    monkeypatch.setattr(module, "StragglerRuntime", Acting)
    return made


def _simulated_stragglers(monkeypatch, capsys, patch) -> list:
    """``--simulate-stragglers`` on the JAX ``launch.train`` and the
    port's, each runtime replaced by ``patch(module, monkeypatch)``'s:
    ``(lines, summary, E_S per step)`` of each.  The JAX run trains
    ``demo-100m``: the runtime's lines do not depend on the model, and
    the JAX Mamba kernel fails on jax 0.9.0."""
    from repro.launch import train as jax_train_entry
    runs = []
    for module, argv in (
            (jax_train_entry, ["--arch", "demo-100m", *STRAGGLERS]),
            (train_entry, ["--arch", ARCH, "--device", "cpu", *STRAGGLERS])):
        made = patch(module, monkeypatch)
        capsys.readouterr()
        module.main(argv)
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[start-runtime]")]
        rt, = made
        runs.append((lines, rt.summary(), np.array(rt.es)))
    return runs


def _simulated_stragglers_match_jax(monkeypatch, capsys) -> None:
    """The same ``default_rng(0)`` trace and runtime calls in both
    drivers, so equal ``[start-runtime]`` lines (none on this trace: E_S
    stays near 0.07 and the slowed host is never slow 3 steps running),
    equal summaries (the sync barrier is the trace's own) and E_S within
    the Tier-1 bound every step."""
    (jl, js, je), (tl, ts, te) = _simulated_stragglers(monkeypatch, capsys,
                                                       _recorded)
    assert tl == jl and ts == js
    assert ts["steps"] == 12 and len(te) == 12
    assert_tier1(te, je)


def test_simulated_stragglers_print_actions_as_jax(monkeypatch, capsys):
    """With a runtime that acts (:func:`_acting`), the two drivers print
    the same ``[start-runtime]`` evict and backup_shard lines, hosts and
    backups included, and end with equal summaries."""
    (jl, js, je), (tl, ts, te) = _simulated_stragglers(monkeypatch, capsys,
                                                       _acting)
    kinds = {ln.split(": ")[1].split()[0] for ln in tl}
    assert kinds == {"evict", "backup_shard"}
    assert tl == jl and ts == js
    assert ts["evictions"] > 0 and ts["backup_shards"] > 0
    assert_tier1(te, je)


DRIVER = ["--reduced", "--steps", "6", "--batch", "2", "--seq", "16",
          "--log-every", "100"]


def _drivers_from_jax_params(argv, monkeypatch) -> tuple[list, list]:
    """The JAX ``launch.train`` and the port's on ``argv``, the port's
    from the JAX driver's initial params (converted): each one's loss per
    step."""
    from repro.launch import train as jax_train_entry
    jax_losses, init = [], []

    class Recording(jax_train_entry.Trainer):
        def init_state(self, seed=0):
            p, s = super().init_state(seed)
            init.append(jax.tree_util.tree_map(np.asarray, p))
            return p, s

        def compile_step(self):
            step = super().compile_step()

            def recorded(*args):
                out = step(*args)
                jax_losses.append(float(out[2]["loss"]))
                return out
            return recorded

    class FromJax(train_entry.Trainer):
        def init_state(self, seed=0):
            p = convert.from_jax(init[0], self.device)
            return p, Opt.init(self.opt_cfg, p)

    monkeypatch.setattr(jax_train_entry, "Trainer", Recording)
    monkeypatch.setattr(train_entry, "Trainer", FromJax)
    jax_train_entry.main(argv)
    out = train_entry.main([*argv, "--device", "cpu"])
    return jax_losses, out["losses"]


def _hold_driver_losses(jax_losses, losses) -> None:
    assert len(losses) == len(jax_losses) == 6
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, jax_losses)]
    assert rel[0] <= 1e-3 and max(rel) <= 1e-2, rel


def test_launch_train_default_arch_matches_the_jax_driver(monkeypatch):
    """No ``--arch``: both drivers train their default, demo-100m."""
    _hold_driver_losses(*_drivers_from_jax_params(DRIVER, monkeypatch))


@pytest.mark.parametrize("flags,item", [
    (["--simulate-stragglers"], "4.3"),
    (["--arch", "yi-6b"], "2.2"), (["--arch", "qwen3-moe-30b-a3b"], "2.3")])
def test_unported_flags_and_families_name_their_roadmap_item(
        flags, item, monkeypatch, capsys):
    """Each case is a ROADMAP.md item that is ported now, held against
    the JAX package's ``launch.train``: item 4.3, the pod runtime behind
    ``--simulate-stragglers``, by its runtime; items 2.2 (dense
    training) and 2.3 (MoE training) by the losses of yi-6b and
    qwen3-moe-30b-a3b from the JAX driver's params."""
    if item == "4.3":
        _simulated_stragglers_match_jax(monkeypatch, capsys)
        return
    _hold_driver_losses(*_drivers_from_jax_params([*flags, *DRIVER],
                                                  monkeypatch))

