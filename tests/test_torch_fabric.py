"""The port's sweep fabric ``repro_torch.sim.fabric`` on the CPU, held
against the JAX package's ``repro.sim.fabric``, in one process:

  * frames are byte-equal across the two packages, with and without
    ``REPRO_FABRIC_KEY``, each package reads the other's, and a tampered
    or unauthenticated frame on a keyed port dies at the MAC check before
    the unpickler runs; oversized and truncated frames fail as in JAX;
  * the port's coordinator, driven by the same scripted messages under
    one fake clock as the JAX coordinator (``tests/test_fabric.py``'s
    scenarios), gives the same replies (``op``, ``uid``, ``cells``,
    ``epoch``, ``for_s``) and the same ``stats()`` after every message;
  * kernel-library shipping ships only the current sources' libraries,
    never overwrites, and keeps to its cap;
  * ``_spec_from_json`` and ``_parse_bind`` read as JAX's do;
  * an in-thread node agent serves ``run(spec, fabric=...)`` bit-equal to
    serial ``run(spec)`` (and, for the numpy techniques, to the JAX
    sweep); a node that cannot run the grid's techniques poisons it;
  * the sweep's ``pretrain_knobs`` / ``make_technique(extra_knobs=)`` and
    ``shared_pretrain=False`` against the JAX sweep.

The spawned-process cases are in ``test_torch_fabric_drill.py``.  Every
grid here runs under a ``timeout=``, every thread is joined with one."""
import dataclasses
import functools
import io
import json
import pickle
import random
import struct
import threading
import time
import types

import pytest
import torch

from repro import policy as jax_policy
from repro.sim import fabric as jax_fabric
from repro.sim import sweep as jax_sweep
from repro_torch import policy
from repro_torch.kernels import _build
from repro_torch.policy import Policy
from repro_torch.sim import fabric, sweep
from repro_torch.sim.fabric import (FabricCoordinator, FabricWorker,
                                    ProtocolError, recv_frame, send_frame)
from repro_torch.sim.sweep import SweepSpec, deterministic_summary as _det

GRID_TIMEOUT = 60.0
ON_CPU = {"start": {"device": "cpu"}}


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


def _spec_kw(**kw) -> dict:
    base = dict(techniques=("none", "sgc"), seeds=(0, 1),
                scenarios=("planetlab",), n_hosts=10, n_intervals=20,
                arrival_rate=0.8, max_workers=1)
    base.update(kw)
    return base


def _framed(mod, obj, key=None) -> bytes:
    buf = io.BytesIO()
    mod.send_frame(buf, obj, key=key)
    return buf.getvalue()


# ------------------------------ wire frames --------------------------------

FRAMES = [{"op": "hello", "node": "n1", "lanes": 4},
          {"op": "t", "n": -(2 ** 62), "x": 1e300, "blob": b"\x00\xff" * 4,
           "nest": {"seq": [1, 2.5, None]}},
          {"op": "unit", "epoch": 3, "uid": 7,
           "cells": (("planetlab", "sgc", 0), ("planetlab", "sgc", 1))}]


@pytest.mark.parametrize("key", [None, b"k1", "str-key"])
@pytest.mark.parametrize("obj", FRAMES, ids=lambda o: o["op"])
def test_frames_are_byte_equal_to_jax_and_cross_read(obj, key):
    ours, theirs = _framed(fabric, obj, key), _framed(jax_fabric, obj, key)
    assert ours == theirs
    assert recv_frame(io.BytesIO(theirs), key=key) == obj
    assert jax_fabric.recv_frame(io.BytesIO(ours), key=key) == obj


def test_key_comes_from_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_FABRIC_KEY", "from-env")
    obj = FRAMES[0]
    raw = _framed(fabric, obj)
    assert raw == _framed(jax_fabric, obj) \
        == _framed(fabric, obj, key=b"from-env")
    assert len(raw) == fabric.MAC_LEN + len(_framed(fabric, obj, key=b""))
    assert recv_frame(io.BytesIO(raw)) == obj
    monkeypatch.delenv("REPRO_FABRIC_KEY")
    with pytest.raises(ProtocolError):        # tag bytes are not a pickle
        recv_frame(io.BytesIO(raw))


class _Canary:
    """Flips a class flag if its pickle is ever executed."""
    unpickled = False


def _trip_canary():
    _Canary.unpickled = True
    return "tripped"


class _Bomb:
    def __reduce__(self):
        return (_trip_canary, ())


@pytest.mark.parametrize("seed", [0, 1])
def test_tampered_or_unkeyed_frame_rejected_before_unpickle(seed):
    _Canary.unpickled = False
    raw = _framed(fabric, {"op": "x", "payload": _Bomb()}, key=b"secret")
    rng = random.Random(seed)
    for _ in range(32):
        i = fabric._HDR.size + rng.randrange(len(raw) - fabric._HDR.size)
        bad = raw[:i] + bytes([raw[i] ^ 0xFF]) + raw[i + 1:]
        with pytest.raises(ProtocolError, match="MAC"):
            recv_frame(io.BytesIO(bad), key=b"secret")
    with pytest.raises(ProtocolError, match="MAC"):
        recv_frame(io.BytesIO(raw), key=b"other")
    # an unauthenticated frame on a keyed port, from either package
    for mod in (fabric, jax_fabric):
        plain = _framed(mod, {"op": "x", "payload": _Bomb()})
        with pytest.raises(ProtocolError, match="MAC|too short"):
            recv_frame(io.BytesIO(plain), key=b"secret")
    assert not _Canary.unpickled, "untrusted bytes reached the unpickler"
    assert recv_frame(io.BytesIO(raw), key=b"secret")["payload"] == \
        "tripped"                          # the genuine frame still loads


def test_frame_roundtrip_and_clean_eof():
    buf = io.BytesIO()
    send_frame(buf, {"op": "hello", "blob": b"\x00\xff"})
    send_frame(buf, {"op": "bye"})
    buf.seek(0)
    assert recv_frame(buf)["blob"] == b"\x00\xff"
    assert recv_frame(buf)["op"] == "bye"
    assert recv_frame(buf) is None


@pytest.mark.parametrize("cut", [1, 4, 7])
def test_truncated_header_is_clean_eof(cut):
    assert recv_frame(io.BytesIO(_framed(fabric, {"op": "t"})[:cut])) is None


@pytest.mark.parametrize("cut", [1, 10, 20])
def test_truncated_payload_rejected(cut):
    raw = _framed(fabric, {"op": "t", "pad": b"x" * 64})
    with pytest.raises(ProtocolError, match="mid-frame"):
        recv_frame(io.BytesIO(raw[:-cut]))


@pytest.mark.parametrize("excess", [1, 2 ** 30])
def test_oversized_length_rejected(excess):
    hdr = struct.pack(">Q", fabric.MAX_FRAME + excess)
    assert fabric.MAX_FRAME == jax_fabric.MAX_FRAME
    with pytest.raises(ProtocolError, match="MAX_FRAME"):
        recv_frame(io.BytesIO(hdr + b"x" * 16))


def test_a_frame_must_be_a_dict_with_an_op():
    for obj in ([1, 2], {"no": "op"}):
        buf = io.BytesIO()
        data = pickle.dumps(obj)
        buf.write(struct.pack(">Q", len(data)) + data)
        with pytest.raises(ProtocolError, match="'op'"):
            recv_frame(io.BytesIO(buf.getvalue()))


# ---------------- the coordinator against the JAX coordinator --------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


COMPARED = ("op", "uid", "cells", "epoch", "for_s")


class _Pair:
    """The port's and the JAX package's coordinators under one fake
    clock: every message goes to both, and their replies and ``stats()``
    must be equal after it."""

    def __init__(self):
        self.clock = _Clock()
        self.ours = FabricCoordinator(lease_s=30.0, clock=self.clock)
        self.theirs = jax_fabric.FabricCoordinator(lease_s=30.0,
                                                   clock=self.clock)
        self.both = (self.ours, self.theirs)

    def close(self):
        for c in self.both:
            c.stop()

    def stats(self) -> dict:
        """Both coordinators' ``stats()``, equal; the port's also counts
        steals and dropped duplicates."""
        ours, theirs = self.ours.stats(), self.theirs.stats()
        assert set(ours) - set(theirs) == {"steals", "duplicates"}
        assert {k: ours[k] for k in theirs} == theirs
        return ours

    def _check(self, a: dict, b: dict) -> dict:
        assert {k: a.get(k) for k in COMPARED} == \
            {k: b.get(k) for k in COMPARED}
        self.stats()
        return a

    def load(self, **kw):
        self.ours._load_grid(SweepSpec(**_spec_kw(**kw)))
        self.theirs._load_grid(jax_sweep.SweepSpec(**_spec_kw(**kw)))
        self.stats()

    def send(self, msg: dict) -> dict:
        return self._check(self.ours._dispatch(dict(msg)),
                           self.theirs._dispatch(dict(msg)))

    def join(self, node: str) -> int:
        self.send({"op": "hello", "node": node, "lanes": 1})
        grid = self.send({"op": "request", "node": node, "epoch": -1})
        assert grid["op"] == "grid"
        return grid["epoch"]

    def pull(self, node: str, epoch: int) -> dict:
        return self.send({"op": "request", "node": node, "epoch": epoch})

    def result(self, node: str, unit: dict) -> dict:
        replies = []
        for coord, cls in ((self.ours, sweep.CellResult),
                           (self.theirs, jax_sweep.CellResult)):
            replies.append(coord._dispatch({
                "op": "result", "node": node, "uid": unit["uid"],
                "results": [cls(sc, tech, seed, {"tasks_done": 1}, 0.0)
                            for sc, tech, seed in unit["cells"]]}))
        return self._check(*replies)

    def disconnect(self, node: str) -> None:
        for c in self.both:
            c._disconnect(node)
        self.stats()

    def attr(self, name: str):
        a, b = (getattr(c, name) for c in self.both)
        if isinstance(a, type(threading.Event())):
            a, b = a.is_set(), b.is_set()
        elif isinstance(a, dict):          # each package's CellResults
            a, b = sorted(a), sorted(b)
        assert a == b, (name, a, b)
        return a


def _lease_reclaim(p: _Pair):
    p.load(seeds=(0,), techniques=("none",))
    got = p.pull("a", p.join("a"))
    assert got["op"] == "unit"
    p.clock.t += 30.0 + 1.0
    got_b = p.pull("b", p.join("b"))
    assert got_b["op"] == "unit" and got_b["uid"] == got["uid"]
    assert "a" not in p.ours._nodes and "a" not in p.theirs._nodes
    p.result("b", got_b)
    assert p.attr("_grid_done")


def _disconnect_requeues(p: _Pair):
    p.load(seeds=(0,), techniques=("none",))
    got = p.pull("a", p.join("a"))
    p.disconnect("a")
    assert list(p.attr("_queue")) == [got["uid"]]


def _steal_and_drop_duplicate(p: _Pair):
    p.load(seeds=(0, 1), techniques=("none",))
    ep = p.join("a")
    u1, u2 = p.pull("a", ep), p.pull("a", ep)
    assert (u1["op"], u2["op"]) == ("unit", "unit")
    stolen = p.pull("b", p.join("b"))
    assert stolen["op"] == "unit" and stolen["uid"] == u1["uid"]
    p.result("b", stolen)
    done = len(p.attr("_done_cells"))
    p.result("a", u1)                      # the duplicate: dropped
    assert len(p.attr("_done_cells")) == done
    p.result("a", u2)
    assert p.attr("_grid_done")
    assert p.pull("a", ep)["op"] == "drain"
    assert (p.stats()["steals"], p.stats()["duplicates"]) == (1, 1)


def _stealing_disabled_waits(p: _Pair):
    for c in p.both:
        c.max_speculate = 0
    p.load(seeds=(0,), techniques=("none",))
    assert p.pull("a", p.join("a"))["op"] == "unit"
    assert p.pull("b", p.join("b"))["op"] == "wait"


def _failed_requeues_then_poisons(p: _Pair):
    p.load(seeds=(0,), techniques=("none",))
    ep = p.join("a")
    for attempt in range(p.attr("max_unit_failures")):
        got = p.pull("a", ep)
        assert got["op"] == "unit", attempt
        p.send({"op": "failed", "node": "a", "uid": got["uid"],
                "detail": "ValueError: boom"})
    assert p.attr("_grid_done") and "boom" in p.attr("_grid_error")


def _drain_after_complete(p: _Pair):
    p.load(seeds=(0, 1), techniques=("none", "sgc"))
    ep = p.join("a")
    units = []
    while True:
        got = p.pull("a", ep)
        if got["op"] != "unit":
            break
        units.append(got)
    assert got["op"] == "wait"
    for u in units[:-1]:
        p.result("a", u)
        assert p.pull("a", ep)["op"] != "drain"
    p.result("a", units[-1])
    assert p.pull("a", ep)["op"] == "drain"
    part = p.ours.partial_result()
    assert [(c.scenario, c.technique, c.seed) for c in part.cells] == \
        SweepSpec(**_spec_kw(seeds=(0, 1))).cells()


def _two_sequential_grids(p: _Pair):
    for seeds in ((0,), (1,)):
        p.load(seeds=seeds, techniques=("none",))
        ep = p.join("a")
        while True:
            got = p.pull("a", ep)
            if got["op"] == "drain":
                break
            assert got["op"] == "unit"
            p.result("a", got)
        assert p.attr("_grid_done")
    assert p.attr("_epoch") == 2


@pytest.mark.parametrize("scenario", [
    _lease_reclaim, _disconnect_requeues, _steal_and_drop_duplicate,
    _stealing_disabled_waits, _failed_requeues_then_poisons,
    _drain_after_complete, _two_sequential_grids],
    ids=lambda f: f.__name__.strip("_"))
def test_coordinator_replies_equal_the_jax_coordinators(scenario):
    p = _Pair()
    try:
        scenario(p)
    finally:
        p.close()


def test_grid_reply_carries_the_thread_count():
    p = _Pair()
    try:
        p.load(seeds=(0,), techniques=("none",))
        p.send({"op": "hello", "node": "a", "lanes": 1})
        grid = p.ours._dispatch({"op": "request", "node": "a",
                                 "epoch": -1})
        assert grid["threads"] == torch.get_num_threads()
        assert grid["spec"] == SweepSpec(**_spec_kw(seeds=(0,),
                                                    techniques=("none",)))
        assert grid["cache_files"] == {}
    finally:
        p.close()


def test_a_poisoned_grid_drains_its_nodes():
    """After the grid is poisoned the failed unit keeps no holder; a node
    that asks again is told to drain (the JAX coordinator fails that
    request)."""
    with FabricCoordinator(lease_s=30.0, clock=_Clock()) as c:
        c._load_grid(SweepSpec(**_spec_kw(seeds=(0,), techniques=("none",))))
        c._dispatch({"op": "hello", "node": "a", "lanes": 1})
        ep = c._dispatch({"op": "request", "node": "a",
                          "epoch": -1})["epoch"]
        for _ in range(c.max_unit_failures):
            got = c._dispatch({"op": "request", "node": "a", "epoch": ep})
            c._dispatch({"op": "failed", "node": "a", "uid": got["uid"],
                         "detail": "boom"})
        assert c._dispatch({"op": "request", "node": "a",
                            "epoch": ep})["op"] == "drain"


# ------------------------------ cache shipping -----------------------------

def _fake_build(root, stale=True):
    root.mkdir(parents=True, exist_ok=True)
    want = {}
    for name, src in _build.sources().items():
        t = _build.target(src).name
        want[t] = f"lib-{name}".encode()
        (root / t).write_bytes(want[t])
        (root / t).with_suffix(".log").write_text("ptxas info")
    if stale:
        (root / "lstm_cell-0000000000000000.so").write_bytes(b"old")
        (root / "notes.txt").write_text("x")
    return want


def test_collect_ships_only_the_current_libraries(tmp_path):
    want = _fake_build(tmp_path / "src")
    assert len(want) == len(_build.sources()) == 5
    assert fabric.collect_cache_files(str(tmp_path / "src")) == want
    assert fabric.collect_cache_files(str(tmp_path / "none")) == {}
    assert fabric.install_cache_files({}) is None


def test_install_round_trips_and_never_overwrites(tmp_path):
    want = _fake_build(tmp_path / "src")
    dst = tmp_path / "dst"
    dst.mkdir()
    first = next(iter(want))
    (dst / first).write_bytes(b"local-wins")
    assert fabric.install_cache_files(want, str(dst)) == str(dst)
    got = fabric.collect_cache_files(str(dst))
    assert got == dict(want, **{first: b"local-wins"})
    assert sorted(p.name for p in dst.iterdir()) == sorted(want)
    fresh = tmp_path / "fresh" / "kernels"
    fabric.install_cache_files(want, str(fresh))
    assert fabric.collect_cache_files(str(fresh)) == want


def test_install_refuses_names_that_are_not_libraries(tmp_path):
    for bad in ("../evil.so", "sub/x.so", "x.py"):
        with pytest.raises(ProtocolError, match="library"):
            fabric.install_cache_files({bad: b"x"}, str(tmp_path))
    assert not list(tmp_path.iterdir())


def test_shipping_keeps_to_its_cap(tmp_path, monkeypatch):
    want = _fake_build(tmp_path, stale=False)
    sizes = [len(want[_build.target(s).name])
             for s in _build.sources().values()]
    monkeypatch.setattr(fabric, "MAX_CACHE_SHIP_BYTES", sum(sizes[:2]))
    got = fabric.collect_cache_files(str(tmp_path))
    assert len(got) == 2 and sum(map(len, got.values())) <= sum(sizes[:2])


# ------------------------------ CLI helpers --------------------------------

def test_spec_from_json_reads_as_jax(tmp_path):
    path = tmp_path / "grid.json"
    path.write_text(json.dumps({
        "techniques": ["none", "sgc", "start"], "seeds": [0, 1],
        "scenarios": ["planetlab"], "n_hosts": 10, "n_intervals": 20,
        "overrides": {"arrival_rate": 0.4}, "pretrain_knobs": {"x": 2},
        "technique_kwargs": {"start": {"device": "cpu"}},
        "shared_pretrain": False}))
    ours = fabric._spec_from_json(str(path))
    theirs = jax_fabric._spec_from_json(str(path))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.techniques == ("none", "sgc", "start")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nope": 1}))
    with pytest.raises(ValueError, match="nope"):
        fabric._spec_from_json(str(bad))
    for s in (":0", "10.0.0.2:9999", "localhost:5"):
        assert fabric._parse_bind(s) == jax_fabric._parse_bind(s)
    assert fabric._parse_bind(":0") == ("127.0.0.1", 0)


# ------------------------- full stack, in-thread ---------------------------

def _serve_in_thread(coord, spec, **kw):
    w = FabricWorker(coord.host, coord.port, node="t1",
                     exit_on_drain=False, **kw)
    th = threading.Thread(target=w.run, daemon=True)
    th.start()
    try:
        # the grid bounded in time
        return w, sweep.run(spec, fabric=types.SimpleNamespace(
            run_grid=functools.partial(coord.run_grid,
                                       timeout=GRID_TIMEOUT)))
    finally:
        w.stop()
        th.join(timeout=20)
        assert not th.is_alive(), "the node agent did not stop"


def test_in_thread_fabric_bitwise_equals_serial_and_jax():
    kw = _spec_kw(techniques=("none", "sgc", "start"),
                  scenarios=("planetlab", "fault-storm"),
                  pretrain_epochs=2)
    spec = SweepSpec(**kw, technique_kwargs=ON_CPU)
    serial = sweep.run(spec)
    with FabricCoordinator(lease_s=30.0) as coord:
        w, res = _serve_in_thread(coord, spec)
        stats = coord.stats()
    assert [(c.scenario, c.technique, c.seed) for c in res.cells] == \
        spec.cells()
    assert w.cells_done == len(spec.cells()) == stats["done_cells"]
    for a, b in zip(serial.cells, res.cells):
        assert _det(a.summary) == _det(b.summary), (a.scenario,
                                                    a.technique, a.seed)
        assert b.device == a.device and b.lstm_cell_launches == 0
    assert {c.device for c in res.cells if c.technique == "start"} == \
        {"cpu"}
    theirs = jax_sweep.run(jax_sweep.SweepSpec(
        **dict(kw, techniques=("none", "sgc"))))
    ours = {(c.scenario, c.technique, c.seed): c for c in res.cells}
    for c in theirs.cells:
        assert _det(ours[(c.scenario, c.technique, c.seed)].summary) == \
            jax_sweep.deterministic_summary(c.summary)


def test_run_grid_timeout_keeps_the_partial_result():
    with FabricCoordinator(clock=_Clock()) as coord:
        with pytest.raises(TimeoutError, match="partial_result"):
            coord.run_grid(SweepSpec(**_spec_kw(seeds=(0,),
                                                techniques=("none",))),
                           timeout=0.5)
        assert coord.partial_result().cells == []
        assert coord.stats()["queued_units"] == 1


def test_node_without_the_card_fails_its_units_and_poisons(monkeypatch):
    """START on ``cuda`` and no card: the node reports each unit it is
    handed ``failed`` with the error, never runs it on the CPU, and the
    coordinator poisons the grid after ``max_unit_failures``.  (The
    coordinator's own build and pretraining stand in for a machine that
    has the card.)"""
    real = sweep._prebuild_kernels
    main = threading.main_thread()
    monkeypatch.setattr(sweep, "_prebuild_kernels", lambda spec: (
        None if threading.current_thread() is main else real(spec)))
    monkeypatch.setattr(sweep, "_build_payloads", lambda spec: {})
    ran = []
    monkeypatch.setattr(sweep, "_run_unit", lambda *a: ran.append(a))
    spec = SweepSpec(**_spec_kw(techniques=("start",), seeds=(0,)),
                     technique_kwargs={"start": {"device": "cuda"}})
    with FabricCoordinator(lease_s=30.0) as coord:
        with pytest.raises(RuntimeError, match="CUDA was asked for") as e:
            _serve_in_thread(coord, spec)
        assert f"failed {coord.max_unit_failures}x" in str(e.value)
    assert ran == []


def test_grid_sets_the_nodes_thread_count(monkeypatch):
    w = FabricWorker("127.0.0.1", 1, node="n")
    seen = []
    monkeypatch.setattr(torch, "set_num_threads", seen.append)
    spec = SweepSpec(**_spec_kw(seeds=(0,), techniques=("none",)))
    w._install_grid({"epoch": 1, "spec": spec, "threads": 3,
                     "payloads": pickle.dumps({}),
                     "cache_files": {}})
    assert seen == [3] and w._threads == 3 and w._unit_error is None


def test_worker_gives_up_when_the_coordinator_is_gone():
    coord = FabricCoordinator().start()
    w = FabricWorker(coord.host, coord.port, node="w",
                     reconnect_tries=2, reconnect_delay_s=0.05,
                     io_timeout_s=5.0)
    w._connect()
    coord.stop()
    w._drop_conn()
    t0 = time.perf_counter()
    with pytest.raises(ConnectionError):
        w._request({"op": "request", "node": "w", "epoch": -1})
    assert time.perf_counter() - t0 < 30


# --------------------------- the sweep's additions -------------------------

class _CustomKnob(Policy):
    def __init__(self, epochs=None):
        self.epochs = epochs

    @classmethod
    def pretrain(cls, ctx):
        return cls(epochs=ctx.epochs)


class _JaxCustomKnob(jax_policy.Policy):
    __init__ = _CustomKnob.__init__
    pretrain = _CustomKnob.__dict__["pretrain"]


@pytest.fixture
def custom_knob_policies():
    """One policy with the epochs knob ``my_epochs`` in each package's
    registry, taken out again afterwards."""
    name = "test-torch-custom-knob"
    for reg, cls in ((policy, _CustomKnob), (jax_policy, _JaxCustomKnob)):
        reg.register(name, epochs_knob="my_epochs",
                     description="test-only: custom epochs knob")(cls)
    yield name
    for reg in (policy, jax_policy):
        reg.registry._REGISTRY.pop(name, None)


def test_undeclared_knob_raises_and_pretrain_knobs_reach_the_policy(
        custom_knob_policies):
    name = custom_knob_policies
    spec_kw = _spec_kw(techniques=(name,), seeds=(0,), n_hosts=8,
                       n_intervals=10)
    cfg = SweepSpec(**spec_kw).cell_config("planetlab", 0)
    jcfg = jax_sweep.SweepSpec(**spec_kw).cell_config("planetlab", 0)
    with pytest.raises(ValueError, match="my_epochs") as ours:
        sweep.make_technique(name, cfg)
    with pytest.raises(ValueError, match="my_epochs") as theirs:
        jax_sweep.make_technique(name, jcfg)
    assert str(ours.value) == str(theirs.value)
    assert sweep.make_technique(name, cfg,
                                extra_knobs={"my_epochs": 11}).epochs == 11
    spec = SweepSpec(**spec_kw, pretrain_knobs={"my_epochs": 7})
    assert spec.pretrain_knobs == (("my_epochs", 7),)
    assert pickle.loads(
        sweep.pretrain_payload(spec, "planetlab", name)).epochs == 7
    res = sweep.run(spec)
    want = jax_sweep.run(jax_sweep.SweepSpec(
        **spec_kw, pretrain_knobs={"my_epochs": 7}))
    assert _det(res.cells[0].summary) == \
        jax_sweep.deterministic_summary(want.cells[0].summary)


def test_unshared_pretrain_trains_on_the_cell_config_as_jax():
    """``shared_pretrain=False`` with a regime override: every cell equals
    the JAX sweep's (the fork family's Pareto fit and Wrangler pretrain on
    the cell config), and START's trained controller is keyed on the
    cell config, not on ``pretrain_config``."""
    grid = _spec_kw(techniques=("single-fork", "wrangler"), seeds=(0,),
                    scenarios=("planetlab", "overload"), n_hosts=12,
                    n_intervals=24, overrides={"arrival_rate": 0.4})
    for shared in (True, False):
        ours = sweep.run(SweepSpec(**grid, shared_pretrain=shared))
        theirs = jax_sweep.run(jax_sweep.SweepSpec(**grid,
                                                   shared_pretrain=shared))
        for a, b in zip(ours.cells, theirs.cells):
            assert (a.scenario, a.technique) == (b.scenario, b.technique)
            assert _det(a.summary) == \
                jax_sweep.deterministic_summary(b.summary)
    spec = SweepSpec(**dict(grid, techniques=("start",)),
                     technique_kwargs=ON_CPU, pretrain_epochs=1,
                     shared_pretrain=False)
    cell_cfg = spec.cell_config("overload", 0)
    assert cell_cfg != spec.pretrain_config("overload", 0)
    blob = sweep.pretrain_payload(spec, "overload", "start")
    key = sweep._pretrain_entry(
        "start", cell_cfg, pretrain_epochs=1,
        technique_kwargs=spec.kwargs_for("start"))[1]
    assert sweep._PRETRAINED[key] is blob
    shared = sweep._pretrain_entry(
        "start", cell_cfg, pretrain_cfg=spec.pretrain_config("overload", 0),
        pretrain_epochs=1, technique_kwargs=spec.kwargs_for("start"))[1]
    assert shared != key
