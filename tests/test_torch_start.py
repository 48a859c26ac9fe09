"""The port's STARTController against the JAX package's over 30 seeded
intervals, in both triggers, with the same weights and telemetry: E_S
within the Tier-1 bound every interval, and equal action streams except
where an E_S or a score lies within the bound of a decision boundary.
The telemetry and the comparison are ``chip_smoke.py``'s own, which
holds the card's run against the CPU's the same way."""
import jax
import numpy as np
import pytest

import chip_smoke
from repro.core.start import JobView as JaxJobView
from repro.core.start import STARTController as JaxController
from repro_torch import convert
from repro_torch.core.start import JobView, STARTController

N_HOSTS, MAX_TASKS = 8, 10
SCHEDULE = [1, 3, 8, 20, 12, 5]          # active jobs, 5 intervals each


def _pair(**kw):
    kw = dict(n_hosts=N_HOSTS, max_tasks=MAX_TASKS, horizon=5, seed=0, **kw)
    jc = JaxController(**kw)
    tc = STARTController(device="cpu", **kw)
    tc.predictor.load_params(convert.from_jax(
        jax.tree_util.tree_map(np.asarray, jc.predictor.params), "cpu"))
    return jc, tc


def _run(jc, tc, intervals=30):
    tel_gen = chip_smoke.Telemetry(N_HOSTS, MAX_TASKS, seed=3)
    actions = 0
    for t, n in enumerate(np.repeat(SCHEDULE, 5)[:intervals]):
        tel = tel_gen.step(int(n))
        acts_j = chip_smoke.decide(jc, tel)
        acts_t = chip_smoke.decide(tc, tel)
        chip_smoke.compare_interval(t, jc, tc, tel, acts_j, acts_t)
        actions += len(acts_j)
    return actions


@pytest.mark.parametrize("trigger,score_on", [
    ("milestone", 0.0), ("per_task", 0.0), ("per_task", 0.15)])
def test_controller_matches_jax(trigger, score_on):
    jc, tc = _pair(trigger=trigger, score_on=score_on)
    assert _run(jc, tc) > 0              # the comparison is not vacuous
    assert tc.predictor.h2d_stages == 31   # cold ring + one per interval
    assert tc._mitigated == jc._mitigated


def test_unfused_path_matches_jax(monkeypatch):
    monkeypatch.setenv("REPRO_DISABLE_FUSED_STEP", "1")
    jc, tc = _pair(trigger="per_task")
    assert not tc.use_fused_step
    _run(jc, tc, intervals=12)
    assert tc.predictor.h2d_stages == 0


def test_jobview_decide_matches_jax():
    jc, tc = _pair()
    rng = np.random.default_rng(2)
    for t in range(6):
        m_h = rng.uniform(0, 1, (N_HOSTS, 11)).astype(np.float32)
        jc.observe_hosts(m_h)
        tc.observe_hosts(m_h)
        views = []
        for j in range(12):
            mt = rng.uniform(0, 1, (MAX_TASKS, 5)).astype(np.float32)
            kw = dict(job_id=100 * t + j, q=MAX_TASKS, deadline_oriented=bool(
                j % 2), incomplete_task_ids=[j], task_hosts=[j % N_HOSTS],
                task_matrix=mt)
            views.append((JaxJobView(**kw), JobView(**kw)))
        acts_j = jc.decide([v[0] for v in views])
        acts_t = tc.decide([v[1] for v in views])
        assert chip_smoke._action_keys(acts_t) == \
            chip_smoke._action_keys(acts_j)


def test_a_flip_away_from_a_boundary_is_refused():
    """The boundary check has teeth: an extra action for a job whose E_S
    is far from an integer fails the comparison."""
    jc, tc = _pair()
    tel = chip_smoke.Telemetry(N_HOSTS, MAX_TASKS, seed=3).step(4)
    acts_j = chip_smoke.decide(jc, tel)
    acts_t = chip_smoke.decide(tc, tel)
    job = int(tel["job_ids"][0])
    e_s = jc._es_cache[job]
    assert abs(e_s - round(e_s)) > 1e-3
    extra = tc.apply_milestone(np.array([job]), np.array([float(MAX_TASKS)]),
                               np.array([1]), np.array([True]),
                               tel["incomplete_fn"])
    with pytest.raises(AssertionError, match="away from any decision"):
        chip_smoke.compare_interval(0, jc, tc, tel, acts_j, acts_t + extra)


def test_unknown_trigger_is_refused():
    with pytest.raises(ValueError):
        STARTController(n_hosts=2, max_tasks=2, trigger="eager",
                        device="cpu")
