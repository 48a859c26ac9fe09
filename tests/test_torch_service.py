"""The port's prediction service (``repro_torch.service``) on the CPU: a
counterpart of each test of ``tests/test_service.py``, and the port held
against the JAX service on the same seeded streams from the same weights.

- The counterparts run the port alone, at the JAX tests' size (3 hosts,
  4 tasks, horizon 5): bitwise single-tenant answers (in process and
  over TCP), multi-tenant batching with no new dispatch shape once warm,
  the boundary sanitizer, backpressure, admission, and the versioned
  retrain / shadow-eval / rollback lifecycle with its wall-clock
  trigger, driven by a ``SkewClock`` instead of sleeps.
- The differential tests feed the JAX service and the port's the same
  snapshots (``chip_smoke.TenantStream``: 1 to 4 live jobs a tenant and
  interval, finished jobs with Pareto durations) from one weight set (the
  port's VersionStore is a copy of the one the JAX service wrote):
  E_S and per-task scores within the Tier-1 bound (``tests/tolerance.py``,
  rel 1e-5), equal actions, ``sanitized`` lists and ``stats()`` counters
  (apart from ``compile_count``, which counts the process's XLA compiles
  in JAX and its captures of the prediction programs in the port, which
  other tests in one process change); a retrain / shadow / promote /
  rollback cycle with losses within 1e-5 relative and the same
  decisions; degraded-mode E_S within the bound; the sanitizer bit-equal
  on a seeded corpus of malformed snapshots.
"""
import json
import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from repro.service import PredictionService as JService
from repro.service import Profile as JProfile
from repro.service import ServiceConfig as JConfig
from repro.service import TelemetryError as JTelemetryError
from repro.service import sanitize_snapshot as j_sanitize
from repro.policy import wire as jwire
from repro.policy.actions import Action as JAction
from repro.policy.actions import ActionKind as JActionKind
from repro_torch import convert
from repro_torch.chaos import SkewClock
from repro_torch.core import features
from repro_torch.core.predictor import StragglerPredictor
from repro_torch.policy import wire
from repro_torch.policy.actions import Action, ActionKind
from repro_torch.service import (LocalClient, PredictionService, Profile,
                                 ServiceConfig, ServiceDaemon,
                                 TelemetryError, sanitize_snapshot)
from repro_torch.service import retrain as svc_retrain
from repro_torch.service.daemon import RetrainScheduler
from repro_torch.train.checkpoint import VersionStore
from tolerance import TIER1_REL

N_HOSTS, MAX_TASKS, HORIZON = 3, 4, 5


def profile(**kw) -> Profile:
    return Profile(n_hosts=N_HOSTS, max_tasks=MAX_TASKS, horizon=HORIZON,
                   **kw)


def config(**kw) -> ServiceConfig:
    return ServiceConfig(profile=kw.pop("profile", profile()),
                         device="cpu", **kw)


def rand_mh(rng):
    return rng.random((N_HOSTS, features.HOST_FEATURES)).astype(np.float32)


def rand_mt(rng, q=3):
    m_t = np.zeros((MAX_TASKS, features.TASK_FEATURES), np.float32)
    m_t[:q] = rng.random((q, features.TASK_FEATURES))
    return m_t


def mk_snap(tenant, seq, m_h, m_t, q=3, job_id=1, done=None):
    tasks = [(100 + i, i % N_HOSTS, i) for i in range(q)]
    return wire.snapshot_to_wire(
        tenant, seq, m_h,
        jobs=[wire.job_to_wire(job_id, q, m_t, tasks=tasks)],
        done=done or [])


def _leaves(tree) -> list:
    return [t.clone() for t in convert.leaves(tree)]


# ------------------------------ wire format ------------------------------

def test_action_wire_roundtrip():
    a = Action(kind=ActionKind.SPECULATE, task=7, target=2, host=5)
    b = wire.action_from_wire(wire.action_to_wire(a))
    assert b == a
    small = wire.action_to_wire(Action(kind=ActionKind.RERUN, task=1))
    assert set(small) == {"kind", "task"}
    assert wire.action_from_wire(small).n_clones == 1
    with pytest.raises(ValueError, match="unknown Action wire"):
        wire.action_from_wire({"kind": "rerun", "task": 1, "zap": 2})
    # the same bytes as the JAX package's wire
    ja = JAction(kind=JActionKind.SPECULATE, task=7, target=2, host=5)
    assert wire.action_to_wire(a) == jwire.action_to_wire(ja)


def test_profile_wire_roundtrip_and_compat():
    p = profile(trigger="per_task", score_on=0.1)
    assert Profile.from_wire(p.to_wire()) == p
    assert p.compatible(profile(trigger="per_task", score_on=0.1))
    assert not p.compatible(profile())              # trigger differs
    assert not profile().compatible(
        Profile(n_hosts=N_HOSTS + 1, max_tasks=MAX_TASKS))
    with pytest.raises(ValueError, match="unknown Profile"):
        Profile.from_wire({"n_hosts": 2, "max_tasks": 2, "zap": 1})
    assert p.to_wire() == JProfile(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                                   horizon=HORIZON, trigger="per_task",
                                   score_on=0.1).to_wire()


# ------------------------------ sanitizer --------------------------------

def test_sanitizer_clamps_nonfinite_features():
    rng = np.random.default_rng(0)
    m_h = rand_mh(rng)
    m_h[0, 0] = np.nan
    m_h[1, 2] = np.inf
    snap = mk_snap("t", 0, m_h, rand_mt(rng))
    clean = sanitize_snapshot(snap, profile(), -1.0, mode="clamp")
    assert np.isfinite(clean["m_h"]).all()
    assert clean["m_h"][0, 0] == 0.0
    assert any("non-finite" in s for s in clean["issues"])


def test_sanitizer_reject_mode_raises_on_nonfinite():
    rng = np.random.default_rng(0)
    m_h = rand_mh(rng)
    m_h[0, 0] = np.nan
    snap = mk_snap("t", 0, m_h, rand_mt(rng))
    with pytest.raises(TelemetryError) as e:
        sanitize_snapshot(snap, profile(), -1.0, mode="reject")
    assert e.value.code == "bad-telemetry"


def test_sanitizer_drops_bad_durations():
    rng = np.random.default_rng(0)
    snap = mk_snap("t", 0, rand_mh(rng), rand_mt(rng),
                   done=[{"id": 4, "times": [1.0, -3.0, np.nan, 2.0]}])
    clean = sanitize_snapshot(snap, profile(), -1.0, mode="clamp")
    np.testing.assert_array_equal(clean["done"][0]["times"],
                                  np.float32([1.0, 2.0]))
    with pytest.raises(TelemetryError):
        sanitize_snapshot(snap, profile(), -1.0, mode="reject")


def test_sanitizer_rejects_out_of_order_and_structural():
    rng = np.random.default_rng(0)
    snap = mk_snap("t", 3, rand_mh(rng), rand_mt(rng))
    with pytest.raises(TelemetryError) as e:
        sanitize_snapshot(snap, profile(), 3.0)  # seq replay
    assert e.value.code == "out-of-order"
    bad = mk_snap("t", 9, rand_mh(rng)[:, :-1], rand_mt(rng))
    with pytest.raises(TelemetryError) as e:
        sanitize_snapshot(bad, profile(), -1.0)  # wrong M_H shape
    assert e.value.code == "bad-shape"
    bad_q = mk_snap("t", 9, rand_mh(rng), rand_mt(rng))
    bad_q["jobs"][0]["q"] = MAX_TASKS + 3
    with pytest.raises(TelemetryError) as e:
        sanitize_snapshot(bad_q, profile(), -1.0)
    assert e.value.code == "bad-job"


def _pick(rng, xs):
    return xs[int(rng.integers(len(xs)))]


def _malformed(rng, i: int) -> dict:
    """One seeded snapshot with one kind of damage (kind 0: none); the
    service's last processed seq is 1."""
    q = int(rng.integers(1, MAX_TASKS + 1))
    m_h, m_t = rand_mh(rng), rand_mt(rng, q)
    done = [{"id": 5, "times": (1.0 + rng.random(3)).tolist()}]
    snap = mk_snap("t", int(rng.integers(2, 6)), m_h, m_t, q=q, done=done)
    kind = i % 13
    if kind == 1:
        snap["m_h"][int(rng.integers(len(snap["m_h"])))] = float("nan")
    elif kind == 2:
        snap["m_h"][0] = _pick(rng, [np.inf, -np.inf])
        snap["jobs"][0]["m_t"][1] = 3e7 * _pick(rng, [-1, 1])
    elif kind == 3:
        snap["m_h"] = snap["m_h"][:-int(rng.integers(1, 4))]
    elif kind == 4:
        snap["jobs"][0]["q"] = _pick(rng, [0, MAX_TASKS + 1, np.nan])
    elif kind == 5:
        snap["jobs"][0]["tasks"][0][2] = MAX_TASKS
    elif kind == 6:
        snap["done"][0]["times"] = [1.5, -1.0, float("nan"), 0.0]
    elif kind == 7:
        snap["done"][0]["times"] = [-2.0, float("inf")]
    elif kind == 8:
        snap["seq"] = _pick(rng, ["3", None, float("nan"), True])
    elif kind == 9:
        snap["jobs"][0]["id"] = _pick(rng, ["x", 1.5, None])
    elif kind == 10:
        snap["jobs"][0]["open"] = _pick(rng, [-3, 2.5, "2"])
    elif kind == 11:
        snap["done"][0]["id"] = True
    elif kind == 12:
        snap["seq"] = _pick(rng, [0, 1])
    return snap


def _sanitized(fn, snap, mode):
    try:
        out = fn(snap, profile(), 1.0, mode=mode)
    except (TelemetryError, JTelemetryError) as e:
        return ("error", e.code, str(e))
    return ("ok", out["seq"], out["m_h"], out["issues"],
            [(j["id"], j["q"], j["m_t"], j["open"], j["deadline"],
              j["tasks"]) for j in out["jobs"]],
            [(d["id"], d["times"]) for d in out["done"]])


def _bit_equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _bit_equal(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("mode", ["clamp", "reject"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sanitizer_bit_equal_to_jax_on_a_malformed_corpus(seed, mode):
    rng = np.random.default_rng(seed)
    outcomes = set()
    for i in range(120):
        snap = _malformed(rng, i)
        got = _sanitized(sanitize_snapshot, json.loads(json.dumps(snap)),
                         mode)
        want = _sanitized(j_sanitize, json.loads(json.dumps(snap)), mode)
        assert _bit_equal(got, want), (i, got, want)
        outcomes.add(got[0] if got[0] == "ok" else got[1])
    assert {"ok", "bad-shape", "bad-job", "bad-seq", "bad-done",
            "out-of-order"} <= outcomes


# --------------------------- admission / queues --------------------------

def test_admission_control():
    svc = PredictionService(config(max_tenants=2))
    assert svc.hello("a", profile().to_wire())["ok"]
    assert svc.hello("a", profile().to_wire())["rejoined"]
    bad = svc.hello("b", profile(k=9.9).to_wire())
    assert not bad["ok"] and bad["error"] == "incompatible-profile"
    assert svc.hello("b", profile().to_wire())["ok"]
    full = svc.hello("c", profile().to_wire())
    assert not full["ok"] and full["error"] == "at-capacity"
    p = svc.submit("ghost", {"seq": 0})
    assert p.result["error"] == "not-admitted"


def test_service_config_builds_on_the_card_by_default():
    """No CPU fallback: a config that does not name the CPU asks for the
    card, and raises where there is none."""
    assert ServiceConfig(profile()).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the service would build on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictionService(ServiceConfig(profile()))


def test_backpressure_sheds_oldest():
    svc = PredictionService(config(queue_depth=2))
    svc.hello("a", profile().to_wire())
    rng = np.random.default_rng(0)
    ps = [svc.submit("a", mk_snap("a", i, rand_mh(rng), rand_mt(rng)))
          for i in range(3)]
    assert ps[0].result["error"] == "overload"    # shed, not dropped
    assert ps[1].result is None and ps[2].result is None
    svc.tick()                                     # one per tenant/tick
    svc.tick()
    assert ps[1].result["ok"] and ps[2].result["ok"]
    assert svc.stats()["sheds"] == 1


# --------------------------- bitwise equivalence -------------------------

def _reference_run(m_hs, m_t, q, per_task=False):
    """Drive a bare predictor exactly as the service tenant would."""
    pred = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                              horizon=HORIZON, device="cpu")
    out = None
    for m_h in m_hs:
        pred.push_host_row(m_h)
        out = pred.predict_interval(
            m_t[None], np.array([float(q)], np.float32), per_task=per_task)
    return out


def test_single_tenant_bitwise_equals_predict_interval():
    rng = np.random.default_rng(7)
    m_hs = [rand_mh(rng) for _ in range(3)]
    m_t = rand_mt(rng)
    svc = PredictionService(config())
    c = LocalClient(svc, "t0")
    assert c.hello(profile())["ok"]
    for i, m_h in enumerate(m_hs):
        r = c.snapshot(mk_snap("t0", i, m_h, m_t))
    ref = _reference_run(m_hs, m_t, 3)
    assert r["jobs"][0]["e_s"] == float(ref[0])


def test_single_tenant_bitwise_per_task_scores():
    rng = np.random.default_rng(8)
    m_hs = [rand_mh(rng) for _ in range(3)]
    m_t = rand_mt(rng)
    prof = profile(trigger="per_task")
    svc = PredictionService(config(profile=prof))
    c = LocalClient(svc, "t0")
    assert c.hello(prof)["ok"]
    for i, m_h in enumerate(m_hs):
        r = c.snapshot(mk_snap("t0", i, m_h, m_t))
    e_ref, s_ref = _reference_run(m_hs, m_t, 3, per_task=True)
    assert r["jobs"][0]["e_s"] == float(e_ref[0])
    np.testing.assert_array_equal(np.float64(r["jobs"][0]["scores"]),
                                  np.float64(s_ref[0, :3]))


def test_tcp_roundtrip_bitwise_and_json_lossless():
    rng = np.random.default_rng(9)
    m_hs = [rand_mh(rng) for _ in range(3)]
    m_t = rand_mt(rng)
    with ServiceDaemon(config()) as d:
        c = d.tcp_client("tcp0")
        assert c.hello(profile())["ok"]
        for i, m_h in enumerate(m_hs):
            r = c.snapshot(mk_snap("tcp0", i, m_h, m_t))
        c.bye()
    ref = _reference_run(m_hs, m_t, 3)
    assert r["jobs"][0]["e_s"] == float(ref[0])


def test_malformed_tenant_never_poisons_healthy_tenant():
    rng = np.random.default_rng(10)
    m_hs = [rand_mh(rng) for _ in range(3)]
    m_t = rand_mt(rng)
    svc = PredictionService(config(sanitize="reject"))
    good = LocalClient(svc, "good")
    evil = LocalClient(svc, "evil")
    assert good.hello(profile())["ok"] and evil.hello(profile())["ok"]
    for i, m_h in enumerate(m_hs):
        bad = mk_snap("evil", i, np.full_like(m_h, np.nan), m_t)
        rb = evil.snapshot(bad)
        assert not rb["ok"] and rb["error"] == "bad-telemetry"
        shape = evil.snapshot(mk_snap("evil", i + 100, m_h[:, :-1], m_t))
        assert not shape["ok"] and shape["error"] == "bad-shape"
        r = good.snapshot(mk_snap("good", i, m_h, m_t))
        assert r["ok"]
    ref = _reference_run(m_hs, m_t, 3)
    assert r["jobs"][0]["e_s"] == float(ref[0])
    st = svc.stats()
    assert st["ok"] and st["rejected"] == 6


# ----------------------- multi-tenant batch serving ----------------------

def _round(svc, tenants, rng, seq, m_t):
    """Submit one snapshot per tenant, then one batch tick for all."""
    ps = [svc.submit(t, mk_snap(t, seq, rand_mh(rng), m_t))
          for t in tenants]
    svc.tick()
    for p in ps:
        assert p.result is not None and p.result["ok"], p.result
    return ps


def test_interleaved_tenants_zero_warm_retraces(monkeypatch):
    """Once every tenant-count pattern has run, further ticks dispatch
    no new (path, batch shape) pair (the shapes JAX would compile for)
    and upload only through the counted ``_stage``: the uncounted
    upload of the unfused path is forbidden in the warm window."""
    svc = PredictionService(config())
    rng = np.random.default_rng(11)
    tenants = [f"t{i}" for i in range(4)]
    for t in tenants:
        assert svc.hello(t, profile().to_wire())["ok"]
    m_t = rand_mt(rng)
    seq = 0
    for group in ([tenants[0]], tenants[:2], tenants[:3], tenants):
        _round(svc, group, rng, seq, m_t)
        seq += 1

    def forbidden(self, arr):
        raise AssertionError("an upload outside _stage")

    monkeypatch.setattr(StragglerPredictor, "_to_device", forbidden)
    before = svc.stats()["compile_count"]
    stages = svc.model.h2d_stages
    for group in (tenants[:3], [tenants[1]], tenants, tenants[:2],
                  [tenants[3]], tenants[:3]):
        _round(svc, group, rng, seq, m_t)
        seq += 1
    assert svc.stats()["compile_count"] - before == 0
    assert svc.model.h2d_stages > stages    # the batches went through it


def test_multi_tenant_matches_single_tenant_answers():
    rng = np.random.default_rng(12)
    svc = PredictionService(config())
    tenants = ["a", "b", "c"]
    for t in tenants:
        assert svc.hello(t, profile().to_wire())["ok"]
    snaps = {t: (rand_mh(rng), rand_mt(rng)) for t in tenants}
    ps = [svc.submit(t, mk_snap(t, 0, mh, mt))
          for t, (mh, mt) in snaps.items()]
    svc.tick()
    for t, p in zip(tenants, ps):
        m_h, m_t = snaps[t]
        pred = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                                  horizon=HORIZON, device="cpu")
        ref = pred.predict_features(np.stack([m_h] * HORIZON), m_t[None],
                                    np.array([3.0], np.float32))
        np.testing.assert_allclose(p.result["jobs"][0]["e_s"],
                                   float(ref.e_s[0]), rtol=1e-5)


# ------------------------ versioning / shadow eval -----------------------

def test_version_store_promote_rollback_retention(tmp_path):
    pred = StragglerPredictor(n_hosts=2, max_tasks=2, device="cpu")
    store = VersionStore(str(tmp_path), keep=2)
    store.save_version(0, pred.params)
    store.promote(0)
    for v in (1, 2):
        store.save_version(v, pred.params)
    store.promote(2)
    for v in (3, 4):
        store.save_version(v, pred.params)
    assert 1 not in store.versions()
    assert {0, 2}.issubset(store.versions())
    assert store.current() == 2 and store.history() == [0]
    assert store.rollback() == 0
    assert store.current() == 0 and store.history() == []
    assert store.rollback() is None
    loaded = store.load_version(0, pred.params)
    for a, b in zip(convert.leaves(loaded), convert.leaves(pred.params)):
        assert torch.equal(a, b)


def _drive_pairs(client, rng, steps, start_seq=0):
    """Stream snapshots whose done records fill the replay buffer."""
    m_t = rand_mt(rng)
    for i in range(steps):
        done = ([{"id": start_seq + i - 1,
                  "times": (1.0 + rng.random(3)).tolist()}]
                if i or start_seq else [])
        r = client.snapshot(mk_snap(client.tenant, start_seq + i,
                                    rand_mh(rng), m_t,
                                    job_id=start_seq + i, done=done))
        assert r["ok"]


def _retrain_config(tmp_path, **kw):
    return config(ckpt_dir=str(tmp_path), min_train_pairs=6,
                  eval_holdback=3, train_epochs=2, train_lr=1e-4, **kw)


def test_shadow_eval_blocks_bad_candidate_then_promotes_and_rolls_back(
        tmp_path, monkeypatch):
    cfg = _retrain_config(tmp_path)
    svc = PredictionService(cfg)
    c = LocalClient(svc, "t0")
    assert c.hello(profile())["ok"]
    rng = np.random.default_rng(13)
    _drive_pairs(c, rng, steps=10)
    assert len(svc.buffer) >= cfg.min_train_pairs
    v0 = _leaves(svc.params)

    real_fit = svc_retrain.fit_candidate
    corrupt = {"on": True}

    def maybe_corrupt(champion, tx, ty, epochs=1, lr=1e-4):
        params, losses = real_fit(champion, tx, ty, epochs=1, lr=lr)
        if corrupt["on"]:
            params = convert.tree_map(lambda a: a * float("nan"), params)
        return params, losses

    monkeypatch.setattr(svc_retrain, "fit_candidate", maybe_corrupt)
    rej = c.retrain()
    assert rej["ok"] and rej["promoted"] is False
    assert not np.isfinite(rej["candidate_loss"])
    assert svc.model_version == 0 and svc.store.current() == 0
    assert svc.stats()["candidates_rejected"] == 1
    for a, b in zip(convert.leaves(svc.params), v0):
        assert torch.equal(a, b)

    corrupt["on"] = False
    ok = c.retrain()
    assert ok["promoted"] is True and ok["version"] == 1
    assert svc.store.current() == 1 and svc.model_version == 1
    assert np.isfinite(ok["candidate_loss"])
    assert any(not torch.equal(a, b)
               for a, b in zip(convert.leaves(svc.params), v0))
    assert svc.tenants["t0"].predictor.params is svc.params

    rb = c.rollback()
    assert rb["ok"] and rb["version"] == 0
    assert svc.store.current() == 0 and svc.model_version == 0
    for a, b in zip(convert.leaves(svc.params), v0):
        assert torch.equal(a, b)


def test_rejected_retrain_leaves_every_champion_tensor_unchanged(tmp_path):
    """The candidate trains from the very tensors the champion serves
    (shared by reference, not copied): a real fit whose candidate shadow
    eval rejects (``promote_tol=0``) leaves every one of them as it was,
    and the champion keeps serving them."""
    svc = PredictionService(_retrain_config(tmp_path, promote_tol=0.0))
    c = LocalClient(svc, "t0")
    assert c.hello(profile())["ok"]
    _drive_pairs(c, np.random.default_rng(14), steps=10)
    served = convert.leaves(svc.params)
    before = _leaves(svc.params)
    r = c.retrain()
    assert r["ok"] and r["promoted"] is False
    assert np.isfinite(r["candidate_loss"])
    assert r["candidate_loss"] != r["champion_loss"]    # the fit moved
    assert all(a is b for a, b in zip(convert.leaves(svc.params), served))
    for a, b in zip(served, before):
        assert torch.equal(a, b)


def test_degraded_mode_when_model_fails_to_load(tmp_path):
    with open(os.path.join(str(tmp_path), "CURRENT"), "w") as f:
        json.dump({"current": 7, "history": []}, f)
    svc = PredictionService(config(ckpt_dir=str(tmp_path)))
    assert svc.degraded
    c = LocalClient(svc, "t0")
    assert c.hello(profile())["ok"]
    rng = np.random.default_rng(14)
    r = c.snapshot(mk_snap(
        "t0", 0, rand_mh(rng), rand_mt(rng),
        done=[{"id": 99, "times": [1.1, 1.4, 2.0, 5.0, 1.2, 1.3]}]))
    assert r["ok"] and r["degraded"] is True
    e_s = r["jobs"][0]["e_s"]
    assert np.isfinite(e_s) and 0.0 <= e_s <= 3.0
    assert svc.stats()["degraded_answers"] == 1


# --------------------- wall-clock retrain scheduling ---------------------

def test_retrain_scheduler_fires_per_period_and_coalesces():
    t = {"now": 100.0}
    s = RetrainScheduler(10.0, clock=lambda: t["now"])
    assert s.enabled
    assert not s.due()
    t["now"] = 109.9
    assert not s.due()
    t["now"] = 110.0
    assert s.due()
    assert not s.due()
    t["now"] = 145.0                   # 3.5 periods swallowed
    assert s.due()
    assert not s.due()
    t["now"] = 154.9
    assert not s.due()                 # re-armed from 145, not from 110
    t["now"] = 155.0
    assert s.due()
    off = RetrainScheduler(0.0, clock=lambda: t["now"])
    assert not off.enabled
    assert not off.due()


def _watch(monkeypatch, obj, name, event_after: int = 1):
    """Wrap ``obj.name`` so an event is set once it has been called
    ``event_after`` more times."""
    inner = getattr(obj, name)
    state = {"n": 0, "ev": threading.Event(), "want": event_after}

    def wrapped(*a, **kw):
        try:
            return inner(*a, **kw)
        finally:
            state["n"] += 1
            if state["n"] >= state["want"]:
                state["ev"].set()

    monkeypatch.setattr(obj, name, wrapped)
    return state


def _wait(state, more: int) -> None:
    state["ev"].clear()
    state["want"] = state["n"] + more
    assert state["ev"].wait(10.0), "the retrainer thread never got there"


def test_wall_clock_retrain_trigger_end_to_end(tmp_path, monkeypatch):
    """With the snapshot trigger off, the daemon retrains and promotes
    when its injected clock crosses ``retrain_interval_s``, and not
    before: while the clock is frozen short of the period the retrainer
    polls its scheduler many times and never fires."""
    clk = SkewClock()
    clk.freeze()
    cfg = _retrain_config(tmp_path, retrain_every=0, retrain_interval_s=30.0)
    with ServiceDaemon(cfg, port=None, retrain_clock=clk) as d:
        svc = d.service
        polls = _watch(monkeypatch, d.retrain_scheduler, "due")
        retrains = _watch(monkeypatch, svc, "retrain_now")
        assert d.retrain_scheduler.enabled
        c = LocalClient(svc, "t0")
        assert c.hello(profile())["ok"]
        _drive_pairs(c, np.random.default_rng(21), steps=10)
        assert len(svc.buffer) >= cfg.min_train_pairs
        clk.advance(29.0)
        _wait(polls, 5)
        assert svc.stats()["retrains"] == 0 and svc.model_version == 0
        clk.advance(2.0)               # cross the period
        _wait(retrains, 1)
        assert svc.stats()["retrains"] == 1
        assert svc.model_version == 1, "wall-clock trigger never promoted"


def test_retrain_failure_counted_and_retrainer_survives(tmp_path,
                                                        monkeypatch):
    clk = SkewClock()
    clk.freeze()
    cfg = _retrain_config(tmp_path, retrain_every=0, retrain_interval_s=30.0)
    with ServiceDaemon(cfg, port=None, retrain_clock=clk) as d:
        svc = d.service
        assert svc.stats()["retrain_failures"] == 0
        assert svc.stats()["last_retrain_error"] is None

        def boom():
            raise RuntimeError("forced retrain failure")
        monkeypatch.setattr(svc, "retrain_now", boom)
        failures = _watch(monkeypatch, svc, "note_retrain_failure")
        clk.advance(31.0)              # cross the first period
        _wait(failures, 1)
        st = svc.stats()
        assert st["retrain_failures"] == 1
        assert "forced retrain failure" in st["last_retrain_error"]
        assert not svc._retrain_due    # cleared: no hot retry spin
        assert d._retrainer.is_alive(), "retrainer thread died"
        clk.advance(31.0)              # next period: thread still serving
        _wait(failures, 1)
        assert svc.stats()["retrain_failures"] == 2


# --------------------------- against the JAX service ---------------------

# k = 0.5 puts the threshold below the Pareto mean, so the seeded weights
# predict E_S >= 1 for jobs of 3 or 4 tasks and both triggers act (at the
# default 1.5 they predict E_S < 1 for every job of 4 tasks or fewer)
K = 0.5


def _pair(tmp_path, trigger="milestone", **kw):
    """The JAX service and the port's from one weight set: the port's
    VersionStore is a copy of the one the JAX service wrote version 0
    (its seeded weights) into."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jsvc = JService(JConfig(
        profile=JProfile(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                         horizon=HORIZON, trigger=trigger, k=K),
        ckpt_dir=str(jdir), **kw))
    shutil.copytree(jdir, tdir)
    tsvc = PredictionService(config(profile=profile(trigger=trigger, k=K),
                                    ckpt_dir=str(tdir), **kw))
    want = jax.tree_util.tree_leaves(jsvc.params)
    for a, b in zip(convert.leaves(tsvc.params), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return jsvc, tsvc


def _streams(n, seed=0, max_jobs=4):
    return [chip_smoke.TenantStream(f"t{i}", N_HOSTS, MAX_TASKS, seed + i,
                                    max_jobs=max_jobs) for i in range(n)]


def _lockstep(jsvc, tsvc, streams, n, t0=0):
    """``chip_smoke.service_lockstep`` with the JAX service as a: every
    answer within the Tier-1 bound, and the actions and trigger state
    equal (no boundary flip is allowed here)."""
    for s in streams:
        for svc in (jsvc, tsvc):
            assert svc.hello(s.tenant, tsvc.profile.to_wire())["ok"]
    r = chip_smoke.service_lockstep(jsvc, tsvc, streams, n, t0=t0,
                                    launches_per_tick=0)
    assert r["max_rel"] <= TIER1_REL and r["flips"] == 0, r
    return r


def _counters(svc) -> dict:
    st = svc.stats()
    del st["compile_count"]
    return st


@pytest.mark.parametrize("trigger", ["milestone", "per_task"])
@pytest.mark.parametrize("tenants", [1, 3])
def test_answers_match_the_jax_service(tmp_path, trigger, tenants):
    jsvc, tsvc = _pair(tmp_path, trigger)
    r = _lockstep(jsvc, tsvc, _streams(tenants), 12)
    assert r["actions"] > 0
    assert _counters(tsvc) == _counters(jsvc)
    assert tsvc.stats()["snapshots"] == 12 * tenants


def test_sanitized_answers_match_the_jax_service(tmp_path):
    """Repaired telemetry gets the same answer and the same ``sanitized``
    list from both services."""
    jsvc, tsvc = _pair(tmp_path)
    for svc in (jsvc, tsvc):
        assert svc.hello("t0", tsvc.profile.to_wire())["ok"]
    rng = np.random.default_rng(5)
    m_t = rand_mt(rng)
    for i in range(4):
        m_h = rand_mh(rng)
        m_h[i % N_HOSTS, 2] = [np.nan, np.inf, 5e6, -np.inf][i]
        snap = mk_snap("t0", i, m_h, m_t,
                       done=[{"id": 9, "times": [1.5, -1.0]}])
        rj = jsvc.handle(dict(snap))
        rt = tsvc.handle(dict(snap))
        assert rt["sanitized"] == rj["sanitized"] and rt["sanitized"]
        assert abs(rt["jobs"][0]["e_s"] - rj["jobs"][0]["e_s"]) <= \
            TIER1_REL * max(abs(rj["jobs"][0]["e_s"]), 1e-6)
    assert _counters(tsvc) == _counters(jsvc)


def test_retrain_cycle_matches_the_jax_service(tmp_path):
    """A retrain -> shadow eval -> promote cycle, the promoted model
    serving, then a rollback, on both services fed the same stream: the
    losses within 1e-5 relative, the same decisions and versions, and
    the answers in lockstep before and after each."""
    kw = dict(min_train_pairs=32, eval_holdback=8, train_epochs=3,
              train_lr=1e-3)
    jsvc, tsvc = _pair(tmp_path, **kw)
    streams = _streams(3, max_jobs=8)
    _lockstep(jsvc, tsvc, streams, 10)
    assert len(tsvc.buffer) == len(jsvc.buffer) >= 32
    rj, rt = jsvc.retrain_now(), tsvc.retrain_now()
    for key in ("champion_loss", "candidate_loss", "final_train_loss"):
        assert abs(rt[key] - rj[key]) <= 1e-5 * abs(rj[key]), key
    for key in ("promoted", "version", "train_pairs", "eval_pairs"):
        assert rt[key] == rj[key], key
    assert rt["promoted"] and rt["version"] == 1
    chip_smoke.service_lockstep(jsvc, tsvc, streams, 4, t0=10,
                                launches_per_tick=0)
    kj, kt = jsvc.rollback_now(), tsvc.rollback_now()
    assert kt == kj == {"ok": True, "version": 0}
    r = chip_smoke.service_lockstep(jsvc, tsvc, streams, 3, t0=14,
                                    launches_per_tick=0)
    assert r["max_rel"] <= TIER1_REL and r["flips"] == 0
    assert _counters(tsvc) == _counters(jsvc)


@pytest.mark.parametrize("trigger", ["milestone", "per_task"])
def test_degraded_answers_match_the_jax_service(tmp_path, trigger):
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        (d / "CURRENT").write_text(json.dumps({"current": 7,
                                               "history": []}))
    jsvc = JService(JConfig(profile=JProfile(
        n_hosts=N_HOSTS, max_tasks=MAX_TASKS, horizon=HORIZON,
        trigger=trigger, k=K), ckpt_dir=str(tmp_path / "jax")))
    tsvc = PredictionService(config(profile=profile(trigger=trigger, k=K),
                                    ckpt_dir=str(tmp_path / "port")))
    assert jsvc.degraded and tsvc.degraded
    r = _lockstep(jsvc, tsvc, _streams(2), 6)
    assert tsvc.stats()["degraded_answers"] == 12
    assert r["max_rel"] <= TIER1_REL
