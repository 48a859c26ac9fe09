"""The port's sweep fabric with spawned node agents, on the CPU: a grid of
36 cells (``none``, ``sgc`` and ``start`` on the CPU x planetlab,
fault-storm x 6 seeds) served to two agents, to one agent with two
lanes, and to two agents one of which is SIGKILLed mid-unit, each
bit-equal to serial ``run()``; the CLI as two subprocesses; the chaos
drill through the port's ``ChaosProxy`` with authenticated frames; and a
pool warmed by ``warm_pool_caches`` bit-equal to serial.

Bounds: every grid runs under ``timeout=``, every spawned agent and
subprocess is joined with a timeout and then killed, every socket has
a timeout.  The kill hook (``REPRO_TEST_KILL_CELL``) fires only in a
spawned agent or lane, never in the pytest process."""
import dataclasses
import multiprocessing
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.chaos import ChaosProxy, FaultPlan
from repro_torch.sim import sweep
from repro_torch.sim.fabric import FabricCoordinator, worker_main
from repro_torch.sim.sweep import SweepSpec, deterministic_summary as _det

ROOT = Path(__file__).resolve().parents[1]
GRID_TIMEOUT = 120.0
JOIN_TIMEOUT = 30.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread here, so the coordinator ships 1 to its agents:
    agents with the test process's default count, beside the other test
    workers, oversubscribe the cores and a 10-host START cell takes
    seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(**kw) -> SweepSpec:
    base = dict(techniques=("none", "sgc", "start"),
                scenarios=("planetlab", "fault-storm"),
                seeds=(0, 1, 2, 3, 4, 5), n_hosts=10, n_intervals=20,
                arrival_rate=0.8, max_workers=1, pretrain_epochs=2,
                technique_kwargs={"start": {"device": "cpu"}})
    base.update(kw)
    return SweepSpec(**base)


@pytest.fixture(scope="module")
def serial():
    spec = _spec()
    assert len(spec.cells()) == 36
    return sweep.run(spec)


def _assert_bit_equal(serial, res) -> None:
    assert [(c.scenario, c.technique, c.seed) for c in res.cells] == \
        serial.spec.cells()
    for a, b in zip(serial.cells, res.cells):
        assert _det(a.summary) == _det(b.summary), (a.scenario,
                                                    a.technique, a.seed)


def _spawn(host, port, lanes=(1, 1)):
    ctx = multiprocessing.get_context("spawn")
    # an agent with a local pool has children, so it cannot be daemonic
    procs = [ctx.Process(target=worker_main, args=(host, port),
                         kwargs=dict(node=f"node{i}", lanes=n),
                         daemon=n == 1)
             for i, n in enumerate(lanes)]
    for p in procs:
        p.start()
    return procs


def _children(pid: int) -> list[int]:
    """The processes whose parent is ``pid`` (an agent's pool lanes)."""
    out = []
    for d in Path("/proc").iterdir():
        try:
            ppid = int((d / "stat").read_text().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid:
            out.append(int(d.name))
    return out


def _reap(procs) -> None:
    for p in procs:
        p.join(timeout=JOIN_TIMEOUT)
        if p.is_alive():
            for child in _children(p.pid):   # lanes would outlive it
                os.kill(child, signal.SIGKILL)
            p.kill()
            p.join(timeout=5)
    assert not any(p.is_alive() for p in procs)


def _fabric_run(spec, lanes=(1, 1), via=None, **coord_kw):
    """``spec``'s grid served to agents spawned with ``lanes``
    (through ``via(coord)``'s address when given); returns the result,
    the agents and the coordinator's last stats."""
    with FabricCoordinator(**{"lease_s": 60.0, **coord_kw}) as coord:
        host, port = via(coord) if via else (coord.host, coord.port)
        procs = _spawn(host, port, lanes)
        try:
            res = coord.run_grid(spec, timeout=GRID_TIMEOUT)
            stats = coord.stats()
        finally:
            _reap(procs)
    return res, procs, stats


def test_two_spawned_agents_bitwise_equal_serial(serial):
    res, procs, stats = _fabric_run(serial.spec)
    _assert_bit_equal(serial, res)
    pids = {c.pid for c in res.cells}
    assert os.getpid() not in pids and len(pids) >= 1
    assert {c.device for c in res.cells if c.technique == "start"} == \
        {"cpu"}
    assert [p.exitcode for p in procs] == [0, 0]
    assert stats["done_cells"] == stats["total_cells"] == 36


def test_an_agent_with_two_lanes_bitwise_equals_serial(serial):
    res, procs, _ = _fabric_run(serial.spec, lanes=(2,))
    _assert_bit_equal(serial, res)
    lanes = {c.pid for c in res.cells}
    assert procs[0].pid not in lanes and len(lanes) >= 1   # pool workers
    assert procs[0].exitcode == 0


def test_grid_completes_after_an_agent_is_killed_mid_unit(
        serial, tmp_path, monkeypatch):
    marker = tmp_path / "killed-once"
    monkeypatch.setenv("REPRO_TEST_KILL_CELL",
                       f"planetlab:start:1:{marker}")
    res, procs, _ = _fabric_run(serial.spec)
    assert marker.exists(), "the kill drill never fired"
    assert sorted(p.exitcode for p in procs) == [-9, 0]
    _assert_bit_equal(serial, res)


def test_warm_pool_caches_then_parallel_equals_serial(serial):
    spec = dataclasses.replace(serial.spec, max_workers=2)
    sweep.shutdown_pool()
    try:
        assert sweep.warm_pool_caches(spec, 2) > 0
        parallel = sweep.run(spec)
    finally:
        sweep.shutdown_pool()
    _assert_bit_equal(serial, parallel)
    assert any(c.pid != os.getpid() for c in parallel.cells)


def test_cli_coordinator_and_worker_end_to_end(tmp_path):
    spec = tmp_path / "grid.json"
    spec.write_text('{"techniques": ["none", "sgc"], "seeds": [0, 1], '
                    '"scenarios": ["planetlab"], "n_hosts": 10, '
                    '"n_intervals": 20}')
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.sim.fabric"]
    coord = subprocess.Popen(cmd + ["coordinator", "--spec", str(spec),
                                    "--bind", "127.0.0.1:0"],
                             env=env, cwd=tmp_path, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    worker = None
    try:
        line = coord.stdout.readline()
        m = re.search(r"on ([\d.]+):(\d+) \((\d+) cells\)", line)
        assert m and m.group(3) == "4", line
        worker = subprocess.run(
            cmd + ["worker", "--connect", f"{m.group(1)}:{m.group(2)}",
                   "--lanes", "1", "--node", "cli"],
            env=env, cwd=tmp_path, text=True, capture_output=True,
            timeout=GRID_TIMEOUT)
        out, err = coord.communicate(timeout=JOIN_TIMEOUT)
    finally:
        if coord.poll() is None:
            coord.kill()
            coord.communicate(timeout=5)
    assert worker.returncode == 0, worker.stderr
    assert "node agent done: 4 cells" in worker.stdout
    assert coord.returncode == 0, err
    assert "grid complete: 4 cells" in out


@pytest.mark.slow
def test_fabric_chaos_drill_bitwise_equals_serial(serial, tmp_path,
                                                  monkeypatch):
    """Two agents through the port's chaos proxy with authenticated
    frames: scripted corruption (MAC-rejected before unpickling), a
    mid-frame RST, a stall longer than the lease, and one agent
    SIGKILLed mid-unit — the grid is still bit-equal to serial."""
    marker = tmp_path / "killed-once"
    monkeypatch.setenv("REPRO_TEST_KILL_CELL",
                       f"fault-storm:sgc:1:{marker}")
    monkeypatch.setenv("REPRO_FABRIC_KEY", "drill-0")
    c2s = FaultPlan(corrupt=0.01, skip_first=4, max_faults=2,
                    script={5: ("corrupt", 1234), 9: ("reset", None)},
                    stall_after=12, stall_s=5.0)
    s2c = FaultPlan(corrupt=0.01, skip_first=4, max_faults=2,
                    script={6: ("corrupt", 999)})
    proxies = []

    def via(coord):
        px = ChaosProxy((coord.host, coord.port), seed=0, c2s=c2s,
                        s2c=s2c).start()
        proxies.append(px)
        return px.host, px.port

    try:
        res, procs, _ = _fabric_run(serial.spec, via=via, lease_s=3.0)
    finally:
        for px in proxies:
            px.stop()
    assert marker.exists(), "the SIGKILL drill never fired"
    assert -9 in [p.exitcode for p in procs], "no agent actually died"
    kinds = {e["fault"] for e in proxies[0].events}
    assert {"corrupt", "reset", "stall"} <= kinds, kinds
    _assert_bit_equal(serial, res)
