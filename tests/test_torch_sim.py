"""The port's simulator and its ``start`` / ``start-eager`` policies
against the JAX package's, on the CPU, from the same seeds and the same
trained weights: the warmup dataset bit for bit, a ``none`` run's summary
key by key, and START and START-eager run in lockstep with the JAX
policies (``chip_smoke.lockstep``, which holds the card's run against the
CPU's the same way): E_S and the predicted straggler count within the
Tier-1 bound every interval, the action streams equal up to a first
difference that involves a boundary job.  Plus the registry: the pod
runtime's names and the JAX package's ``FIELD``, all of which the port
makes; and START-eager on a pod view, which it hands to the pod
runtime's ``StartEagerPodPolicy`` as the JAX policy does."""
import dataclasses

import jax
import numpy as np
import pytest

import chip_smoke
from repro.core.start import STARTController as JaxController
from repro.sim import scenarios as jax_scenarios
from repro.sim import techniques as jax_techniques
from repro.sim.engine import Simulation as JaxSimulation
from repro.sim.techniques import start_tech as jax_start_tech
from repro_torch import convert, policy
from repro_torch.core.start import STARTController
from repro_torch.sim import SimConfig, scenarios
from repro_torch.sim.engine import Simulation
from repro_torch.sim.techniques import start_tech

SIZE = dict(n_hosts=32, n_intervals=72)


def _warmup_cfgs():
    return (jax_scenarios.make_config("planetlab", seed=7, **SIZE),
            scenarios.make_config("planetlab", seed=7, **SIZE))


@pytest.fixture(scope="module")
def trained():
    """The JAX package's pretraining (2 epochs) on a seed-7 warmup, as
    numpy params."""
    ctrl = jax_start_tech.pretrain(_warmup_cfgs()[0], epochs=2, lr=1e-3)
    return jax.tree_util.tree_map(np.asarray, ctrl.predictor.params)


def test_collect_training_data_equals_jax_bit_for_bit():
    jcfg, tcfg = _warmup_cfgs()
    jxs, jys = jax_start_tech.collect_training_data(jcfg)
    txs, tys = start_tech.collect_training_data(tcfg)
    assert txs.shape == jxs.shape and txs.shape[1] > 0
    assert txs.dtype == jxs.dtype and tys.dtype == jys.dtype
    np.testing.assert_array_equal(txs, jxs)
    np.testing.assert_array_equal(tys, jys)


@pytest.mark.parametrize("scenario", ["planetlab", "overload",
                                      "fault-storm", "hetero-fleet"])
def test_none_summary_equals_jax(scenario):
    want = JaxSimulation(jax_scenarios.make_config(
        scenario, seed=3, **SIZE)).run()
    got = Simulation(scenarios.make_config(scenario, seed=3, **SIZE)).run()
    assert set(got) == set(want)
    for k in want:
        if k != "avg_overhead_s":         # wall clock
            assert got[k] == want[k], k
    assert got["tasks_done"] > 0


def _controllers(params, cfg):
    kw = dict(n_hosts=cfg.n_hosts, max_tasks=cfg.max_tasks, k=cfg.k,
              seed=0, beta_scale=cfg.interval_seconds)
    jc = JaxController(**kw)
    jc.predictor.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    tc = STARTController(device="cpu", **kw)
    tc.predictor.load_params(convert.from_jax(params, "cpu"))
    return jc, tc


@pytest.mark.parametrize("scenario", ["planetlab", "overload"])
@pytest.mark.parametrize("name", ["start", "start-eager"])
def test_start_policies_match_jax(trained, scenario, name):
    jcls = {"start": jax_start_tech.START,
            "start-eager": jax_start_tech.STARTEager}[name]
    cfg = scenarios.make_config(scenario, seed=1, **SIZE)
    jcfg = jax_scenarios.make_config(scenario, seed=1, **SIZE)
    jc, tc = _controllers(trained, cfg)
    sim_j = JaxSimulation(jcfg, technique=jcls(controller=jc))
    sim_t = Simulation(cfg, technique=policy.get(name).factory(
        controller=tc))
    r = chip_smoke.lockstep(sim_j, sim_t, cfg.n_intervals)
    assert r["max_rel"] <= chip_smoke.TIER1_REL
    # the comparison is not vacuous: the runs share most of the
    # intervals, and decisions were made in them
    assert r["intervals"] >= cfg.n_intervals // 2
    assert r["actions_compared"] > 0
    if r["parted_at"] is None:
        assert sim_t.summary() | {"avg_overhead_s": 0} == \
            sim_j.summary() | {"avg_overhead_s": 0}


def test_a_flip_away_from_a_boundary_is_refused(trained):
    """The lockstep check has teeth: an action the other run does not
    take, for a job whose E_S lies far from any boundary, fails it."""
    cfg = scenarios.make_config("planetlab", seed=1, **SIZE)
    sims = []
    for _ in range(2):
        _, tc = _controllers(trained, cfg)
        sims.append(Simulation(cfg, technique=start_tech.START(
            controller=tc)))
    inner = sims[1].technique.decide

    def decide(view):
        acts = inner(view)
        if view.event == "interval" and view.t == 40:
            job = int(view.jobs.active()[0])
            task = int(view.jobs.incomplete_tasks(job)[0])
            acts = acts + [policy.Action(kind="rerun", task=task, target=0)]
        return acts

    sims[1].technique.decide = decide
    with pytest.raises(AssertionError, match="away from any decision"):
        chip_smoke.lockstep(sims[0], sims[1], 41)


def test_start_pretrains_through_the_registry_on_the_cpu():
    cfg = SimConfig(**SIZE, seed=0)
    pol = policy.get("start-eager").pretrain.fn(policy.PretrainContext(
        config=cfg, epochs=1, kwargs={"device": "cpu", "hysteresis": 2}))
    assert isinstance(pol, start_tech.STARTEager) and pol.hysteresis == 2
    ctrl = pol.controller
    assert ctrl.trigger == "per_task" and ctrl.predictor.device.type == "cpu"
    assert len(ctrl.predictor.losses) == 1
    assert np.isfinite(ctrl.predictor.losses).all()
    assert Simulation(dataclasses.replace(cfg, n_intervals=12),
                      technique=pol).run()["tasks_total"] > 0


@pytest.mark.parametrize("name", ["start-pod", "start-eager-pod",
                                  "start-pod-online", "start-pod-service",
                                  "FIELD"])
def test_names_not_ported_yet_raise_with_their_roadmap_item(name):
    """(Named when the pod policies were not ported.)  The pod runtime's
    four policies are registered for the ``pod`` substrate alone once
    ``repro_torch.distributed.straggler_runtime`` is imported, and make a
    policy; every name of the JAX package's ``FIELD`` (case ``FIELD``) is
    registered for the simulator and makes a policy."""
    import repro_torch.distributed.straggler_runtime  # noqa: F401
    import repro_torch.sim.techniques as techniques
    if name == "FIELD":
        assert techniques.FIELD == jax_techniques.FIELD
        assert set(jax_techniques.FIELD) <= set(policy.names("sim"))
        for n in jax_techniques.FIELD:
            kw = {"device": "cpu"} if n == "igru-sd" else {}
            assert isinstance(policy.make(n, **kw), policy.Policy), n
    else:
        assert policy.get(name).substrates == ("pod",)
        assert name in policy.names("pod") and name not in policy.names("sim")
        pol = policy.make(name)
        assert isinstance(pol, policy.Policy) and pol.name == name
    with pytest.raises(policy.UnknownPolicyError):
        policy.make("no-such-technique")
    assert not hasattr(policy.registry, "NOT_PORTED")


def test_start_eager_refuses_a_pod_view():
    """(Named when the port refused a pod view.)  START-eager is
    registered for both substrates; on a pod view it hands ``observe``,
    ``decide`` and ``forget_tasks`` to a ``StartEagerPodPolicy`` with its
    hysteresis and cooldown, builds no controller, and equals the JAX
    policy over a 16-host, 40-step pod trace (actions, summary, E_S
    within the Tier-1 bound)."""
    from repro.distributed import straggler_runtime as J
    from repro_torch.distributed import straggler_runtime as T
    assert policy.get("start-eager").substrates == ("sim", "pod")
    jpol = jax_start_tech.STARTEager(hysteresis=2, cooldown=3)
    tpol = start_tech.STARTEager(hysteresis=2, cooldown=3, device="cpu")
    jrt = J.StragglerRuntime(J.RuntimeConfig(n_hosts=16), policy=jpol)
    trt = T.StragglerRuntime(T.RuntimeConfig(n_hosts=16, device="cpu"),
                             policy=tpol)
    r = chip_smoke.pod_lockstep(jrt, trt, chip_smoke.pod_trace(40, 16))
    assert r["parted_at"] is None and r["max_rel"] <= chip_smoke.TIER1_REL
    assert r["actions"] > 0
    assert isinstance(tpol._pod, T.StartEagerPodPolicy)
    assert (tpol._pod.hysteresis, tpol._pod.cooldown) == (2, 3)
    assert tpol._controller is None
