"""IGRU-SD in the port against the JAX package, on the CPU, from the same
converted weights: the GRU's forward within the Tier-1 bound, three
``_gru_step``s within 1e-5 relative, ``torch.nn.GRU`` shown to compute
another function (the JAX cell drops the candidate's bias), the trained
policy in lockstep with the JAX policy (``chip_smoke.lockstep`` with
``compare_gru``, as the card's run is held against the CPU's), and a
pickled policy that continues its run as one that was never pickled."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import encoder_lstm as jnet
from repro.sim import scenarios as jax_scenarios
from repro.sim.engine import Simulation as JaxSimulation
from repro.sim.techniques import baselines as jax_baselines
from repro_torch import convert, policy
from repro_torch.core import encoder_lstm as net
from repro_torch.sim import scenarios
from repro_torch.sim.engine import Simulation
from repro_torch.sim.techniques import baselines
from tolerance import assert_tier1

SIZE = dict(n_hosts=32, n_intervals=72)
T, B, FEATS, HIDDEN = 5, 8, 3, 16
REL = 1e-5                    # losses and params, relative (in norm)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    """||got - want|| / ||want|| over every leaf of two params trees (or
    two scalars), in float64."""
    g = [np.asarray(x, np.float64).ravel() for x in convert.leaves(got)]
    w = [np.asarray(x, np.float64).ravel() for x in convert.leaves(want)]
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(g, w))
    den = sum(float((b ** 2).sum()) for b in w)
    return (num / den) ** 0.5


def _jax_params(seed: int = 0) -> dict:
    """JAX's ``gru_init`` draws with a nonzero bias (an initialised GRU's
    is zero, a trained one's is not), as numpy arrays."""
    p = _np(jax_baselines.gru_init(jax.random.PRNGKey(seed), FEATS, HIDDEN))
    rng = np.random.default_rng(seed)
    p["b"] = rng.normal(0, 0.5, 3 * HIDDEN).astype(np.float32)
    p["head"]["b"] = rng.normal(0, 0.5, 1).astype(np.float32)
    return p


def _data(seed: int = 0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(T, B, FEATS)).astype(np.float32)
    y = rng.uniform(0.5, 3.0, size=B).astype(np.float32)
    return xs, y


def test_gru_apply_matches_jax():
    p = _jax_params()
    xs, _ = _data()
    want = np.asarray(jax_baselines.gru_apply(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(xs)))
    got = baselines.gru_apply(convert.from_jax(p, "cpu"),
                              torch.as_tensor(xs))
    assert got.shape == (B,) and got.dtype == torch.float32
    assert_tier1(got.numpy(), want, context="gru_apply")


def test_three_gru_steps_match_jax():
    p = _jax_params()
    xs, y = _data()
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jopt = jnet.adam_init(jp)
    tp = convert.from_jax(p, "cpu")
    topt = net.adam_init(tp)
    for _ in range(3):
        jp, jopt, jloss = jax_baselines._gru_step(jp, jopt, jnp.asarray(xs),
                                                  jnp.asarray(y))
        tp, topt, tloss = baselines._gru_step(tp, topt, torch.as_tensor(xs),
                                              torch.as_tensor(y))
        assert abs(float(tloss) - float(jloss)) <= REL * abs(float(jloss))
        assert _rel(convert.to_numpy(tp), _np(jp)) <= REL
        assert not any(t.requires_grad for t in convert.leaves(tp))
    assert int(topt.step) == 3


def _torch_gru(p: dict, n_bias_on_input: bool) -> torch.nn.GRU:
    """``torch.nn.GRU`` holding the JAX cell's weights (its gates packed
    [r, z, n] as the JAX cell's [r, u, n]); the candidate's bias goes to
    the input side (``b_in``) or the hidden side (``b_hn``)."""
    gru = torch.nn.GRU(FEATS, HIDDEN)
    b = torch.tensor(p["b"])
    b_ih, b_hh = b.clone(), torch.zeros(3 * HIDDEN)
    if not n_bias_on_input:
        b_ih[2 * HIDDEN:], b_hh[2 * HIDDEN:] = 0.0, b[2 * HIDDEN:]
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.tensor(p["wx"]).T)
        gru.weight_hh_l0.copy_(torch.tensor(p["wh"]).T)
        gru.bias_ih_l0.copy_(b_ih)
        gru.bias_hh_l0.copy_(b_hh)
    return gru


@pytest.mark.parametrize("n_bias_on_input", [True, False])
def test_torch_nn_gru_with_the_same_weights_differs(n_bias_on_input):
    """The JAX cell computes ``tanh(x·Wx_n + r ⊙ (h·Wh_n))``: no bias in
    the candidate, wherever ``torch.nn.GRU`` puts it.  With that bias
    zeroed the two agree, so the mapping of the weights is right and the
    bias is the whole difference."""
    p = _jax_params()
    xs, _ = _data()
    tp = convert.from_jax(p, "cpu")
    ours = baselines.gru_apply(tp, torch.as_tensor(xs))

    def through(gru):
        with torch.no_grad():
            h, _ = gru(torch.as_tensor(xs))
            return net.softplus((h[-1] @ tp["head"]["w"]
                                 + tp["head"]["b"])[..., 0])

    assert (through(_torch_gru(p, n_bias_on_input)) - ours).abs().max() \
        > 1e-2
    p0 = dict(p, b=p["b"].copy())
    p0["b"][2 * HIDDEN:] = 0.0
    ours0 = baselines.gru_apply(convert.from_jax(p0, "cpu"),
                                torch.as_tensor(xs))
    assert_tier1(through(_torch_gru(p0, n_bias_on_input)).numpy(),
                 ours0.numpy(), context="nn.GRU without the candidate bias")


@pytest.fixture(scope="module")
def trained():
    """The JAX package's IGRU-SD pretrained (20 epochs) on a seed-9
    warmup, as numpy params."""
    cfg = jax_scenarios.make_config("planetlab", seed=9, **SIZE)
    warm = JaxSimulation(cfg)
    warm.run()
    tech = jax_baselines.IGRUSD()
    jax_baselines.pretrain_igru(tech, warm.snapshot(), epochs=20)
    return _np(tech.params)


def _recording(monkeypatch):
    """Record each output of the JAX package's ``gru_apply`` (the JAX
    policy keeps no predictions); returns the reader for ``GRULog``."""
    seen = {}
    inner = jax_baselines.gru_apply

    def gru_apply(params, xs):
        out = inner(params, xs)
        seen["p"] = np.asarray(out)
        return out

    monkeypatch.setattr(jax_baselines, "gru_apply", gru_apply)
    return lambda pol: seen["p"]


@pytest.mark.parametrize("scenario", ["planetlab", "overload"])
def test_igru_policy_in_lockstep_with_jax(trained, scenario, monkeypatch):
    preds = _recording(monkeypatch)
    jcfg = jax_scenarios.make_config(scenario, seed=1, **SIZE)
    cfg = scenarios.make_config(scenario, seed=1, **SIZE)
    jtech = jax_baselines.IGRUSD()
    jtech.params = jax.tree_util.tree_map(jnp.asarray, trained)
    ttech = baselines.IGRUSD(device="cpu")
    ttech.params = convert.from_jax(trained, "cpu")
    sim_j = JaxSimulation(jcfg, technique=jtech)
    sim_t = Simulation(cfg, technique=ttech)
    r = chip_smoke.lockstep(
        sim_j, sim_t, cfg.n_intervals,
        log=lambda pol: chip_smoke.GRULog(
            pol, preds if pol is jtech else None),
        compare=chip_smoke.compare_gru)
    assert r["max_rel"] <= chip_smoke.TIER1_REL
    # not vacuous: most intervals compared, with predictions and actions
    assert r["intervals"] >= cfg.n_intervals // 2
    assert r["predicted"] >= cfg.n_intervals // 2
    assert r["actions_compared"] > 0
    if r["parted_at"] is None:
        assert sim_t.summary() | {"avg_overhead_s": 0} == \
            sim_j.summary() | {"avg_overhead_s": 0}


def test_a_flip_away_from_the_threshold_is_refused(trained):
    """``compare_gru`` has teeth: an action the other run does not take,
    for a task whose prediction lies far from 1.5, fails it."""
    cfg = scenarios.make_config("planetlab", seed=1, **SIZE)
    sims = []
    for _ in range(2):
        tech = baselines.IGRUSD(device="cpu")
        tech.params = convert.from_jax(trained, "cpu")
        sims.append(Simulation(cfg, technique=tech))
    inner = sims[1].technique.decide
    fired = []

    def decide(view):
        acts = inner(view)
        active = np.nonzero(view.tasks.active_mask())[0]
        if view.event == "interval" and view.t >= 40 and len(active) \
                and not fired:
            fired.append(int(active[0]))
            acts = acts + [policy.Action(kind="rerun", task=fired[0],
                                         target=0)]
        return acts

    sims[1].technique.decide = decide
    with pytest.raises(AssertionError, match="away from any decision"):
        chip_smoke.lockstep(sims[0], sims[1], cfg.n_intervals,
                            log=chip_smoke.GRULog,
                            compare=chip_smoke.compare_gru)
    assert fired


def test_a_pickled_policy_continues_the_same_run(trained):
    cfg = scenarios.make_config("overload", seed=2, **SIZE)
    runs = []
    for cut in (None, cfg.n_intervals // 2):
        tech = baselines.IGRUSD(device="cpu")
        tech.params = convert.from_jax(trained, "cpu")
        sim = Simulation(cfg, technique=tech)
        for t in range(cfg.n_intervals):
            if t == cut:
                sim.technique = pickle.loads(pickle.dumps(sim.technique))
                assert sim.technique is not tech and sim.technique.hist
                assert sim.technique.device.type == "cpu"
            sim.step()
        runs.append(sim.summary() | {"avg_overhead_s": 0})
    assert runs[0] == runs[1]
    assert runs[0]["tasks_done"] > 0


def test_igru_pretrains_through_the_registry_on_the_cpu():
    cfg = scenarios.make_config("planetlab", seed=0, **SIZE)
    warm = Simulation(scenarios.make_config("planetlab", seed=9, **SIZE))
    warm.run()
    pol = policy.get("igru-sd").pretrain.fn(policy.PretrainContext(
        config=cfg, epochs=2, warmup=warm.snapshot,
        kwargs={"device": "cpu", "seed": 3}))
    assert isinstance(pol, baselines.IGRUSD)
    assert pol.device.type == "cpu"
    fresh = baselines.IGRUSD(seed=3, device="cpu")
    assert _rel(convert.to_numpy(pol.params),
                convert.to_numpy(fresh.params)) > 0      # it trained
    assert Simulation(cfg, technique=pol).run()["tasks_total"] > 0
