"""The port's grid runner ``repro_torch.sim.sweep`` on the CPU: a spec
that cannot run fails before any worker starts; serial and 2-worker runs
are bit-equal (START and IGRU-SD on the CPU through ``technique_kwargs``,
pretrained in the parent and broadcast); over numpy techniques the
aggregate and the CSVs equal the JAX package's ``sweep.run``; and the
pool's recovery paths (a warmup that fails, a worker killed mid-grid)
keep the grid bit-equal."""
import concurrent.futures as cf
import csv
import dataclasses
import os

import numpy as np
import pytest

from repro.sim import sweep as jax_sweep
from repro_torch import convert, policy
from repro_torch.sim import sweep
from repro_torch.sim.sweep import (CellResult, SweepResult, SweepSpec,
                                   deterministic_summary as _det, run,
                                   run_cell)
from repro_torch.sim.techniques import baselines

ON_CPU = {"start": {"device": "cpu"}, "igru-sd": {"device": "cpu"}}
NUMPY_GRID = dict(techniques=("grass", "wrangler", "single-fork", "rpps"),
                  seeds=(0, 1), scenarios=("planetlab", "overload"),
                  n_hosts=16, n_intervals=36, arrival_rate=0.8,
                  max_workers=1)


def _tiny_spec(**kw):
    base = dict(techniques=("start", "igru-sd"), seeds=(0, 1),
                scenarios=("planetlab", "overload"), n_hosts=10,
                n_intervals=20, arrival_rate=0.8, max_workers=1,
                pretrain_epochs=2, igru_epochs=5, technique_kwargs=ON_CPU)
    base.update(kw)
    return SweepSpec(**base)


def _assert_bit_equal(a: SweepResult, b: SweepResult) -> None:
    assert len(a.cells) == len(b.cells) == len(a.spec.cells())
    for x, y in zip(a.cells, b.cells):
        assert (x.scenario, x.technique, x.seed) == (y.scenario,
                                                     y.technique, y.seed)
        assert _det(x.summary) == _det(y.summary), (x.scenario,
                                                    x.technique, x.seed)


@pytest.fixture(scope="module")
def serial():
    return run(_tiny_spec())


# ------------------------------ validation ---------------------------------

@pytest.mark.parametrize("field", ["techniques", "seeds", "scenarios"])
def test_empty_grid_axis_rejected_at_construction(field):
    kw = dict(techniques=("none",), seeds=(0,), scenarios=("planetlab",))
    kw[field] = ()
    with pytest.raises(ValueError, match=field):
        SweepSpec(**kw)


def test_unknown_technique_and_scenario_raise_before_any_worker():
    sweep.shutdown_pool()
    with pytest.raises(policy.UnknownPolicyError,
                       match="registered techniques"):
        _tiny_spec(techniques=("bogus",), max_workers=2)
    with pytest.raises(policy.UnknownPolicyError):
        _tiny_spec(technique_kwargs={"bogus": {"p": 1}})
    with pytest.raises(KeyError):
        _tiny_spec(scenarios=("bogus",), max_workers=2)
    with pytest.raises(ValueError, match="registered techniques"):
        run_cell(_tiny_spec(), "planetlab", "bogus", 0)
    assert sweep._POOL is None


def test_a_technique_on_an_absent_card_raises_before_any_worker(
        monkeypatch):
    """START's default device is the card: a parallel run with no card
    refuses in the parent, before the kernels build or a worker spawns."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sweep.shutdown_pool()
    spec = _tiny_spec(techniques=("start", "grass"), technique_kwargs={},
                      max_workers=2)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        run(spec)
    assert sweep._POOL is None


def test_every_field_technique_is_a_sweep_technique():
    from repro.sim.techniques import FIELD as JAX_FIELD
    from repro_torch.sim.techniques import FIELD
    assert FIELD == JAX_FIELD
    spec = SweepSpec(techniques=FIELD, technique_kwargs={
        "start": {"device": "cpu"}, "start-eager": {"device": "cpu"},
        "igru-sd": {"device": "cpu"}})
    assert [c[1] for c in spec.cells()] == list(FIELD)


# ---------------------------- serial == parallel ----------------------------

def test_sweep_parallel_bitwise_equals_serial(serial):
    """The pool warmed first, so the workers run cells (START and IGRU-SD
    each at least one, unpickled onto the CPU there) rather than the
    parent running the grid alone while they import."""
    sweep.warm_pool(2)
    parallel = run(dataclasses.replace(_tiny_spec(), max_workers=2))
    assert parallel.n_workers == 2 and parallel.pretrain_s >= 0
    _assert_bit_equal(serial, parallel)
    in_workers = [c for c in parallel.cells if c.pid != os.getpid()]
    assert {c.technique for c in in_workers} == {"start", "igru-sd"}
    assert {c.device for c in in_workers} == {"cpu"}
    assert {c.pid for c in serial.cells} == {os.getpid()}
    c = serial.cell("overload", "igru-sd", 1)
    assert c.summary["tasks_done"] > 0 and c.wall_s > 0


def test_make_technique_returns_fresh_pretrained_instances():
    spec = _tiny_spec()
    cfg = spec.cell_config("planetlab", 0)
    kw = dict(igru_epochs=spec.igru_epochs,
              technique_kwargs=spec.kwargs_for("igru-sd"))
    t1 = sweep.make_technique("igru-sd", cfg, **kw)
    t2 = sweep.make_technique("igru-sd", cfg, **kw)
    assert isinstance(t1, baselines.IGRUSD) and t1 is not t2
    assert t1.device.type == "cpu" and t1.params["wx"].device.type == "cpu"
    for a, b in zip(convert.leaves(t1.params), convert.leaves(t2.params)):
        assert a is not b
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# --------------------------- against the JAX sweep ---------------------------

@pytest.fixture(scope="module")
def numpy_grids():
    return (run(SweepSpec(**NUMPY_GRID)),
            jax_sweep.run(jax_sweep.SweepSpec(**NUMPY_GRID)))


def test_aggregate_over_numpy_techniques_equals_jax(numpy_grids):
    ours, theirs = numpy_grids
    want = theirs.aggregate()
    got = ours.aggregate()
    assert list(got) == list(want)
    assert got == want
    for a, b in zip(ours.cells, theirs.cells):
        assert _det(a.summary) == jax_sweep.deterministic_summary(b.summary)


def test_overrides_pretrain_on_the_dimension_config_as_jax():
    """A regime override (the figures' arrival_rate / QoS sweeps) changes
    the cells but not where the pretrained numpy techniques (the fork
    family's Pareto fit, Wrangler) train: only the dimension overrides
    reach the pretraining config, and every cell equals the JAX sweep's
    bit for bit."""
    grid = dict(techniques=("single-fork", "fork-relaunch", "wrangler"),
                seeds=(0,), scenarios=("planetlab", "overload"),
                n_hosts=16, n_intervals=36, arrival_rate=0.8, max_workers=1,
                overrides={"arrival_rate": 0.4, "n_hosts": 12})
    spec = SweepSpec(**grid)
    pcfg, cfg = spec.pretrain_config("overload", 0), \
        spec.cell_config("overload", 0)
    assert pcfg.n_hosts == cfg.n_hosts == 12
    assert pcfg == SweepSpec(**dict(grid, overrides={"n_hosts": 12})) \
        .cell_config("overload", 0) != cfg
    ours, theirs = run(spec), jax_sweep.run(jax_sweep.SweepSpec(**grid))
    for a, b in zip(ours.cells, theirs.cells):
        assert (a.scenario, a.technique) == (b.scenario, b.technique)
        assert _det(a.summary) == jax_sweep.deterministic_summary(b.summary)


def test_write_csv_writes_the_jax_sweeps_rows(numpy_grids, tmp_path):
    ours, theirs = numpy_grids
    paths = {}
    for name, res in (("ours", ours), ("theirs", theirs)):
        paths[name] = res.write_csv(str(tmp_path / name))
        assert [os.path.basename(p) for p in paths[name]] == \
            ["sweep_cells.csv", "sweep_agg.csv"]
    for p_ours, p_theirs in zip(paths["ours"], paths["theirs"]):
        with open(p_ours) as f:
            rows = list(csv.reader(f))
        with open(p_theirs) as f:
            want = list(csv.reader(f))
        assert rows[0] == want[0]
        assert len(rows) == len(want) > 1
        if p_ours.endswith("_cells.csv"):      # all but the wall clock
            rows = [r[:3] + r[4:] for r in rows]
            want = [r[:3] + r[4:] for r in want]
        assert rows == want


def test_aggregate_mean_and_ci():
    spec = SweepSpec(techniques=("none",), seeds=(0, 1, 2),
                     scenarios=("planetlab",), metrics=("m",))
    cells = [CellResult("planetlab", "none", i, {"m": v}, 0.0)
             for i, v in enumerate((1.0, 2.0, 3.0))]
    res = SweepResult(spec=spec, cells=cells, wall_s=0.0, n_workers=1)
    st = res.aggregate()[("planetlab", "none")]["m"]
    assert st["mean"] == pytest.approx(2.0)
    assert st["n"] == 3
    assert st["ci95"] == pytest.approx(1.96 * 1.0 / np.sqrt(3))


# ---------------------------- pool hardening ---------------------------------

def test_ready_lanes_counts_only_successful_warmups(monkeypatch):
    import warnings

    monkeypatch.setattr(sweep, "_WARMUP_WARNED", False)
    ok = cf.Future()
    ok.set_result(True)
    bad = cf.Future()
    bad.set_exception(RuntimeError("warmup exploded"))
    cancelled = cf.Future()
    cancelled.cancel()
    pending = cf.Future()
    with pytest.warns(RuntimeWarning, match="warmup"):
        assert sweep._ready_lanes([ok, bad, cancelled, pending]) == 1
    with warnings.catch_warnings():      # warned once, not per poll
        warnings.simplefilter("error")
        assert sweep._ready_lanes([ok, bad, cancelled, pending]) == 1


def test_all_warmups_failed_falls_back_to_parent(serial, monkeypatch):
    monkeypatch.setenv("REPRO_TEST_FAIL_WARMUP", "1")
    sweep.shutdown_pool()                # fresh pool inherits the env
    try:
        sweep._pool(2)
        cf.wait(sweep._POOL_READY, timeout=120)
        with pytest.warns(RuntimeWarning, match="warmup"):
            parallel = run(dataclasses.replace(_tiny_spec(), max_workers=2))
    finally:
        sweep.shutdown_pool()            # don't leak poisoned workers
    _assert_bit_equal(serial, parallel)


def test_worker_killed_mid_grid_recovers_bitwise(serial, tmp_path,
                                                 monkeypatch):
    """SIGKILL a pool worker mid-cell: the parent reruns the lost unit,
    respawns the pool, and the grid still lands bit-equal to serial."""
    marker = tmp_path / "pool-killed-once"
    monkeypatch.setenv("REPRO_TEST_KILL_CELL",
                       f"planetlab:start:0:{marker}")
    sweep.shutdown_pool()                # fresh pool inherits the env
    try:
        sweep.warm_pool(2)
        parallel = run(dataclasses.replace(_tiny_spec(), max_workers=2))
    finally:
        sweep.shutdown_pool()            # recycle the armed workers
    assert marker.exists(), "the kill drill never fired in a worker"
    _assert_bit_equal(serial, parallel)
