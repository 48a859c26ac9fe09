"""The port's numpy techniques (the paper's baselines but IGRU-SD, RPPS
and the replication family) against the JAX package's, on the CPU: the
same scenario and seed give the same ``deterministic_summary`` key by
key, bit for bit, and pretraining on the same warmup gives the same
learned state (Wrangler's ridge weights, the forks' tail estimate,
IGRU-SD's training pairs)."""
import numpy as np
import pytest

from repro import policy as jax_policy
from repro.sim import scenarios as jax_scenarios
from repro.sim.engine import Simulation as JaxSimulation
from repro.sim.techniques import baselines as jax_baselines
from repro_torch import policy
from repro_torch.sim import scenarios
from repro_torch.sim.engine import Simulation
from repro_torch.sim.sweep import deterministic_summary
from repro_torch.sim.techniques import baselines

SIZE = dict(n_hosts=32, n_intervals=72)
NUMPY_TECHNIQUES = ("nearestfit", "dolly", "grass", "sgc", "wrangler",
                    "rpps", "single-fork", "fork-relaunch",
                    "redundancy-fixed", "redundancy-adaptive")


def _configs(scenario: str, seed: int):
    return (jax_scenarios.make_config(scenario, seed=seed, **SIZE),
            scenarios.make_config(scenario, seed=seed, **SIZE))


def _warmups(scenario: str):
    """The seed-9 warmup of both packages, as the sweeps take it."""
    jcfg, tcfg = _configs(scenario, 9)
    jw, tw = JaxSimulation(jcfg), Simulation(tcfg)
    jw.run()
    tw.run()
    return jw.snapshot(), tw.snapshot()


def _pretrained(name: str, scenario: str):
    """Both packages' instances of ``name``, pretrained through their
    registry entries on their own seed-9 warmups when the entry
    pretrains."""
    jentry, tentry = jax_policy.get(name), policy.get(name)
    assert (jentry.pretrain is None) == (tentry.pretrain is None)
    assert jentry.substrates == tentry.substrates
    if tentry.pretrain is None:
        return jentry.factory(), tentry.factory()
    jw, tw = _warmups(scenario)
    jcfg, tcfg = _configs(scenario, 0)
    return (jentry.pretrain.fn(jax_policy.PretrainContext(
                config=jcfg, warmup=lambda: jw)),
            tentry.pretrain.fn(policy.PretrainContext(
                config=tcfg, warmup=lambda: tw)))


@pytest.mark.parametrize("scenario", ["planetlab", "overload"])
@pytest.mark.parametrize("name", NUMPY_TECHNIQUES)
def test_numpy_technique_summary_equals_jax_bit_for_bit(name, scenario):
    jtech, ttech = _pretrained(name, scenario)
    jcfg, tcfg = _configs(scenario, 1)
    want = deterministic_summary(JaxSimulation(jcfg, technique=jtech).run())
    got = deterministic_summary(Simulation(tcfg, technique=ttech).run())
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    assert got["technique"] == name and got["tasks_done"] > 0


@pytest.mark.parametrize("scenario", ["planetlab", "overload"])
def test_wrangler_weights_equal_jax_after_pretraining(scenario):
    jtech, ttech = _pretrained("wrangler", scenario)
    assert ttech.w is not None and ttech.w.shape == (6,)
    assert ttech.w.dtype == jtech.w.dtype
    np.testing.assert_array_equal(ttech.w, jtech.w)


@pytest.mark.parametrize("name", ["single-fork", "fork-relaunch"])
def test_fork_tail_estimate_equals_jax_after_pretraining(name):
    jtech, ttech = _pretrained(name, "planetlab")
    assert ttech.alpha0 is not None
    assert (ttech.alpha0, ttech.beta0) == (jtech.alpha0, jtech.beta0)


def test_igru_training_pairs_equal_jax_bit_for_bit(monkeypatch):
    """``igru_training_data`` builds the pairs the JAX package's
    ``pretrain_igru`` hands to ``IGRUSD.train``."""
    jw, tw = _warmups("planetlab")
    seen = {}
    monkeypatch.setattr(jax_baselines.IGRUSD, "train",
                        lambda self, xs, y, epochs=200: seen.update(
                            xs=xs, y=y, epochs=epochs))
    jax_baselines.pretrain_igru(jax_baselines.IGRUSD(), jw, epochs=3)
    xs, ys = baselines.igru_training_data(tw)
    assert seen["epochs"] == 3 and xs.shape[1] > 0
    assert xs.dtype == seen["xs"].dtype and ys.dtype == seen["y"].dtype
    np.testing.assert_array_equal(xs, seen["xs"])
    np.testing.assert_array_equal(ys, seen["y"])


def test_igru_training_data_is_none_for_an_empty_warmup():
    warm = Simulation(scenarios.make_config("planetlab", seed=9, n_hosts=4,
                                            n_intervals=1))
    warm.run()
    assert baselines.igru_training_data(warm.snapshot()) is None
