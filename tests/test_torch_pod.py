"""The port's training-pod straggler runtime
(``repro_torch.distributed.straggler_runtime``) against the JAX package's,
on the CPU (``device="cpu"``), at 8-16 hosts and 10-40 steps.

Each case drives the JAX runtime and the port's over the same step-time
trace, the JAX run as run a of ``chip_smoke.pod_lockstep`` (which holds
the card's run against its CPU twin the same way): the actions equal at
every step, ``summary()`` equal, and E_S (each ``_expected_stragglers``
call, or the service's answer and per-task scores) within the Tier-1
bound of ``tests/tolerance.py`` (rel 1e-5).  ``pod_lockstep`` lets the
actions part only at a step whose prediction lies within that bound of a
decision boundary; every case here requires that they never part.

- the runtime itself (the five tests of ``tests/test_distributed.py``):
  the published ``snapshot()`` arrays bit-equal, ``expected_stragglers``
  and ``fitted_tail`` within Tier-1, the actions and summaries equal;
- ``start-pod``, ``start-eager-pod``, the replication family and
  ``backup_mask`` (``start-eager`` on a pod view is in
  ``tests/test_torch_sim.py``);
- ``start-pod-online`` from the JAX policy's initial weights
  (``convert.from_jax``): its training pairs (``_xs``/``_ys``) bit-equal,
  the epoch losses within 1e-5 relative (observed 2.5e-7 over 48 Adam
  steps: XLA's and PyTorch's CPU products round differently) and E_S
  within Tier-1 (observed 1.0e-6, the worst of the network's 21
  predictions); and its tail-fit fallback before ``min_windows``;
- ``start-pod-service`` against the JAX service from one weight set (the
  port's ``VersionStore`` is a copy of the JAX service's), in-process
  and over TCP through a port ``ServiceDaemon``;
- ``igru-sd`` after ``pretrain_igru_pod`` (the training set bit-equal,
  then the JAX-trained weights carried over);
- ``registry.names`` equal across the packages with both runtimes
  imported.
"""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import repro.sim.techniques  # noqa: F401  (registers the JAX field)
from repro import policy as jpolicy
from repro.distributed import straggler_runtime as J
from repro.service import LocalClient as JLocalClient
from repro.service import PredictionService as JService
from repro.service import Profile as JProfile
from repro.service import ServiceConfig as JConfig
from repro.sim.techniques import baselines as jax_baselines
import repro_torch.sim.techniques  # noqa: F401  (registers the port's)
from repro_torch import convert, policy
from repro_torch.distributed import straggler_runtime as T
from repro_torch.service import (LocalClient, PredictionService, Profile,
                                 ServiceConfig, ServiceDaemon)
from repro_torch.sim.techniques import baselines
from tolerance import TIER1_REL, assert_tier1

REPLICATION = ("single-fork", "fork-relaunch", "redundancy-fixed",
               "redundancy-adaptive")


def _pair(n: int, jpol=None, tpol=None, **kw):
    """The JAX runtime and the port's (on the CPU) on one configuration."""
    return (J.StragglerRuntime(J.RuntimeConfig(n_hosts=n, **kw), policy=jpol),
            T.StragglerRuntime(T.RuntimeConfig(n_hosts=n, device="cpu", **kw),
                               policy=tpol))


def _lockstep(jrt, trt, trace, **kw) -> dict:
    r = chip_smoke.pod_lockstep(jrt, trt, trace, **kw)
    assert r["parted_at"] is None and r["steps"] == len(trace), r
    assert r["max_rel"] <= TIER1_REL
    return r


def _keys(actions) -> list[tuple]:
    return [(str(a.kind), int(a.host), a.backup) for a in actions]


def _views_equal(vj, vt) -> None:
    """Every array and scalar the two runtimes publish, bit for bit."""
    for name in ("event", "t", "now_s", "interval_seconds"):
        assert getattr(vj, name) == getattr(vt, name), name
    for part in ("tasks", "hosts", "jobs"):
        a, b = getattr(vj, part), getattr(vt, part)
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(b, f.name),
                                          getattr(a, f.name),
                                          err_msg=f"{part}.{f.name}")
    np.testing.assert_array_equal(vt.straggler_ma, vj.straggler_ma)
    np.testing.assert_array_equal(vt.extra["chronic"], vj.extra["chronic"])
    assert len(vt.util_history) == len(vj.util_history)
    for a, b in zip(vj.util_history, vt.util_history):
        np.testing.assert_array_equal(b, a)
    assert len(vt.completed_jobs) == len(vj.completed_jobs)
    for a, b in zip(vj.completed_jobs, vt.completed_jobs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# ------------------- the runtime (tests/test_distributed.py) ---------------

def _uniform(rng):
    return [np.full(8, 1.0) for _ in range(6)]


def _heavy_tail(rng):
    out = []
    for _ in range(12):
        times = 1.0 + 1.0 * rng.pareto(1.5, 64)
        times[3] *= 3.0
        out.append(times)
    return out


def _chronic(rng):
    out = []
    for _ in range(15):
        times = 1.0 + 0.05 * rng.pareto(1.5, 8)
        times[5] = 4.0
        out.append(times)
    return out


def _light(rng):
    return [1.0 + 0.01 * rng.pareto(6.0, 8) for _ in range(8)]


def _heavy(rng):
    return [1.0 + 1.0 * rng.pareto(1.2, 8) for _ in range(8)]


# case -> (trace, seed, RuntimeConfig knobs): the traces and seeds of
# tests/test_distributed.py (its E_S test draws light and heavy from one
# generator in turn; each is one case here)
RUNTIME_CASES = {
    "no_actions_when_uniform": (_uniform, 0, {}),
    "backup_on_heavy_tail": (_heavy_tail, 0, {}),
    "evicts_chronic_straggler": (_chronic, 1, {"evict_after": 3}),
    "es_light_tail": (_light, 2, {}),
    "es_heavy_tail": (_heavy, 2, {}),
}


@pytest.mark.parametrize("case", sorted(RUNTIME_CASES))
def test_runtime_matches_jax(case):
    make, seed, kw = RUNTIME_CASES[case]
    trace = make(np.random.default_rng(seed))
    jrt, trt = _pair(len(trace[0]), **kw)
    es, acts = [], []
    for times in trace:
        jrt.observe_step(times)
        trt.observe_step(times)
        _views_equal(jrt.snapshot(), trt.snapshot())
        es.append(trt.expected_stragglers())
        assert_tier1(es[-1], jrt.expected_stragglers())
        assert_tier1(np.array(trt.fitted_tail()), np.array(jrt.fitted_tail()))
        aj, at = jrt.decide(), trt.decide()
        assert _keys(at) == _keys(aj)
        acts += at
    assert trt.summary() == jrt.summary()
    # what each test of tests/test_distributed.py asserts, on the port
    kinds = {str(a.kind) for a in acts}
    if case == "no_actions_when_uniform":
        assert not acts
    elif case == "backup_on_heavy_tail":
        assert "backup_shard" in kinds
        assert all(a.backup != a.host for a in acts
                   if str(a.kind) == "backup_shard")
    elif case == "evicts_chronic_straggler":
        assert 5 in trt.evicted and "evict" in kinds
    elif case == "es_heavy_tail":
        light = T.StragglerRuntime(T.RuntimeConfig(n_hosts=8, device="cpu"))
        for times in _light(np.random.default_rng(seed)):
            light.observe_step(times)
        assert es[-1] > light.expected_stragglers()


def test_runtime_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.StragglerRuntime(T.RuntimeConfig(n_hosts=4))


def test_backup_mask_matches_jax():
    acts = [T.HostAction(T.ActionKind.BACKUP_SHARD, 2, backup=0),
            T.HostAction(T.ActionKind.EVICT, 1),
            T.HostAction(T.ActionKind.BACKUP_SHARD, 3, backup=1)]
    jacts = [J.HostAction(J.ActionKind(str(a.kind)), a.host, backup=a.backup)
             for a in acts]
    rng = np.random.default_rng(0)
    for _ in range(8):
        on_time = rng.random(4) < 0.5
        np.testing.assert_array_equal(T.backup_mask(4, acts, on_time),
                                      J.backup_mask(4, jacts, on_time))
    # tests/test_distributed.py's cases: host 2 late -> its backup owns it
    np.testing.assert_array_equal(
        T.backup_mask(4, acts[:1], np.array([1, 1, 0, 1], bool)),
        [1, 1, 0, 1])
    np.testing.assert_array_equal(
        T.backup_mask(4, acts[:1], np.ones(4, bool)), [1, 1, 1, 1])


# ------------------------------- the policies -------------------------------

def _shipped(names) -> list[str]:
    """The packages' own names: the JAX package's tests register plugin
    policies named ``test-*`` in its process-wide registry."""
    return [n for n in names if not n.startswith("test-")]


def test_registry_names_match_jax():
    for s in (None, "sim", "pod"):
        assert _shipped(policy.names(s)) == _shipped(jpolicy.names(s)), s
    assert len(policy.names("pod")) == 10
    assert len(policy.names("sim")) == 14
    assert "start-eager" in policy.names("pod")


def _trace(n=16, steps=40, seed=0):
    return chip_smoke.pod_trace(steps, n, seed)


@pytest.mark.parametrize("name", ["start-pod", *REPLICATION])
def test_numpy_pod_policies_match_jax(name):
    jrt, trt = _pair(16, jpolicy.make(name), policy.make(name))
    r = _lockstep(jrt, trt, _trace())
    if name == "start-pod":
        # E_S ~ 0.07 at 16 hosts: start-pod acts by evicting host 5 only
        assert r["summary"]["evicted_hosts"] == [chip_smoke.POD_SLOW]
    else:
        assert r["actions"] > 0


@pytest.mark.parametrize("case", ["hysteresis_cooldown", "pareto_trace"])
def test_start_eager_pod_matches_jax(case):
    """``tests/test_eager_trigger.py``'s case (8 hosts, host 5 at 4.0, no
    eviction; a backup after 3 straggler steps, then 4 at rest) and the
    pod trace at the default knobs."""
    if case == "hysteresis_cooldown":
        jrt, trt = _pair(8, J.StartEagerPodPolicy(hysteresis=3, cooldown=4),
                         T.StartEagerPodPolicy(hysteresis=3, cooldown=4),
                         evict_after=100)
        trace = np.ones((10, 8))
        trace[:, 5] = 4.0
    else:
        jrt, trt = _pair(16, J.StartEagerPodPolicy(), T.StartEagerPodPolicy())
        trace = _trace()
    backups = []
    inner = trt.decide

    def decide():
        acts = inner()
        backups.append([a.host for a in acts
                        if str(a.kind) == "backup_shard"])
        return acts

    trt.decide = decide
    r = _lockstep(jrt, trt, trace)
    assert r["actions"] > 0
    if case == "hysteresis_cooldown":
        fired = [t for t, b in enumerate(backups) if b == [5]]
        assert fired[0] == 2 and fired[1] - fired[0] == 4


# ----------------------------- start-pod-online -----------------------------

def _online_pair(n, **kw):
    jrt, trt = _pair(n, J.OnlineStartPodPolicy(**kw),
                     T.OnlineStartPodPolicy(**kw))
    chip_smoke.prebuild(jrt)
    chip_smoke.prebuild(trt)
    trt.policy.predictor.load_params(convert.from_jax(
        jax.tree_util.tree_map(np.asarray, jrt.policy.predictor.params),
        "cpu"))
    return jrt, trt


def test_online_pod_policy_matches_jax():
    """30 steps of 12 hosts: 6 windows, each fit 8 epochs (48 Adam steps),
    the network predicting from window 2 on."""
    jrt, trt = _online_pair(12)
    r = _lockstep(jrt, trt, _trace(12, 30))
    jp, tp = jrt.policy, trt.policy
    assert tp.trained_pairs == jp.trained_pairs == 6
    assert r["net_predictions"] == 30 - 2 * 5 + 1
    assert len(tp._xs) == len(jp._xs)
    for a, b in zip(jp._xs, tp._xs):
        np.testing.assert_array_equal(b, a)
    assert tp._ys == jp._ys
    assert len(tp.predictor.losses) == 6 * 8
    assert r["max_loss_rel"] <= 1e-5


def test_online_pod_policy_falls_back_to_the_tail_fit():
    """Before ``min_windows`` pairs the policy's E_S is the MLE tail
    fit's, as the JAX policy's is, and the network never predicts."""
    jrt, trt = _online_pair(12, min_windows=3)
    log = []
    inner = trt.policy._expected_stragglers

    def es(view):
        log.append((inner(view), T.expected_stragglers(
            view.extra["step_times"], 12, 1.5, 5, "cpu")))
        return log[-1][0]

    trt.policy._expected_stragglers = es
    r = _lockstep(jrt, trt, _trace(12, 14))
    assert trt.policy.trained_pairs == 2 and r["net_predictions"] == 0
    assert log and all(a == b for a, b in log)


def test_online_predictor_lives_on_the_runtime_device():
    rt = T.StragglerRuntime(T.RuntimeConfig(n_hosts=6, device="cpu"),
                            policy=T.OnlineStartPodPolicy())
    for times in _trace(6, 5):
        rt.observe_step(times)
        rt.decide()
    pred = rt.policy.predictor
    assert pred.device.type == "cpu" and pred.input_dim == 6 * 11 + 6 * 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.OnlineStartPodPolicy()._ensure_predictor(
                dataclasses.replace(rt.cfg, device="cuda"))


# ----------------------------- start-pod-service ----------------------------

def _services(tmp_path, n):
    """The JAX service and the port's from one weight set, on the
    profile ``ServiceBackedPodPolicy`` asks for."""
    kw = dict(n_hosts=n, max_tasks=n, horizon=5, k=1.5, trigger="per_task",
              hysteresis=2, cooldown=5)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jsvc = JService(JConfig(profile=JProfile(**kw), ckpt_dir=str(jdir)))
    shutil.copytree(jdir, tdir)
    tcfg = ServiceConfig(profile=Profile(**kw), ckpt_dir=str(tdir),
                         device="cpu")
    return jsvc, tcfg


@pytest.mark.parametrize("transport", ["in-process", "tcp"])
def test_service_pod_policy_matches_jax(tmp_path, transport):
    n = 12
    jsvc, tcfg = _services(tmp_path, n)
    jpol = J.ServiceBackedPodPolicy(client=JLocalClient(jsvc, "pod0"))
    daemon = client = None
    if transport == "tcp":
        daemon = ServiceDaemon(tcfg, port=0).start()
        client = daemon.tcp_client("pod0")
    else:
        client = LocalClient(PredictionService(tcfg), "pod0")
    try:
        tpol = T.ServiceBackedPodPolicy(client=client)
        jrt, trt = _pair(n, jpol, tpol)
        r = _lockstep(jrt, trt, _trace(n, 30))
    finally:
        client.close()
        if daemon is not None:
            daemon.stop()
    assert r["actions"] > 0
    assert tpol.last_response["ok"] and tpol._seq == 30
    assert tpol._sent_done == 6


def test_service_pod_policy_fails_open():
    """A shed or degraded answer (``ok: false``) gives no actions."""
    class Refusing:
        def hello(self, profile):
            return {"ok": True}

        def snapshot(self, snap):
            return {"ok": False, "error": "shed"}

    rt = T.StragglerRuntime(T.RuntimeConfig(n_hosts=6, device="cpu"),
                            policy=T.ServiceBackedPodPolicy(client=Refusing()))
    for times in _trace(6, 12):
        rt.observe_step(times)
        assert rt.decide() == []
    assert rt.policy._sent_done == 0 and rt.policy._seq == 12


# --------------------------------- igru-sd ----------------------------------

def test_igru_pod_policy_matches_jax(monkeypatch):
    """``tests/test_policy_api.py``'s case: 8 hosts, host 3 at 2.5x, a
    15-step warm run fitted for 150 epochs, then 18 steps."""
    rng = np.random.default_rng(0)
    trace = 1.0 + 0.05 * rng.pareto(2.0, (33, 8))
    trace[:, 3] *= 2.5
    jtech, ttech = jax_baselines.IGRUSD(seed=0), baselines.IGRUSD(
        device="cpu")
    data = {}
    for key, mod, tech in (("jax", J, jtech), ("port", T, ttech)):
        warm = mod.StragglerRuntime(
            mod.RuntimeConfig(n_hosts=8, **({} if mod is J
                                            else {"device": "cpu"})))
        for times in trace[:15]:
            warm.observe_step(times)
        inner = tech.train

        def train(xs, ys, epochs, inner=inner, key=key):
            data[key] = (xs, ys, epochs)
            if key == "jax":
                inner(xs, ys, epochs=epochs)

        monkeypatch.setattr(tech, "train", train)
        mod.pretrain_igru_pod(tech, warm, epochs=150)
    np.testing.assert_array_equal(data["port"][0], data["jax"][0])
    np.testing.assert_array_equal(data["port"][1], data["jax"][1])
    assert data["port"][2] == data["jax"][2] == 150
    assert data["port"][0].shape == (5, 3 * 8, 3)
    ttech.params = convert.from_jax(
        jax.tree_util.tree_map(np.asarray, jtech.params), "cpu")
    jrt, trt = _pair(8, jtech, ttech)
    hosts = []
    inner = trt.decide

    def decide():
        acts = inner()
        hosts.extend((str(a.kind), a.host) for a in acts)
        return acts

    trt.decide = decide
    r = _lockstep(jrt, trt, trace[15:], preds=lambda p: None)
    # the original's assertions: host 3 backed up, more than once (the
    # runtime retires IGRU-SD's per-task state at every window boundary)
    assert set(hosts) == {("backup_shard", 3)} and len(hosts) >= 2
    assert r["summary"]["backup_shards"] == len(hosts)
