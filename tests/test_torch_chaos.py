"""The port's chaos harness (``repro_torch.chaos``) and the service drills
of ``tests/test_chaos.py`` run against the port's daemon, on the CPU.

- ``FaultPlan.decide`` gives the JAX harness's decisions for the same
  seeds, and the proxy injects what its plan says.
- ``SkewClock`` is driven by a fake base clock, so nothing sleeps.
- The service drills: the client's per-request timeout, the
  ``MAX_LINE`` cap, seq-deduped resends, admission tokens, a daemon
  killed and restarted mid-stream, and a tenant streamed through the
  chaos proxy; each holds the invariant that every snapshot is applied
  exactly once and the last answer equals a bare predictor's, bit for
  bit.
- The wire is one across packages: the JAX package's ``ServiceClient``
  against the port's daemon, and the port's client against the JAX
  daemon, get the answers the same-package pairs get.
"""
import json
import os
import random
import socket
import threading
import time

import numpy as np
import pytest

from repro.chaos import FaultPlan as JFaultPlan
from repro.service import Profile as JProfile
from repro.service import ServiceConfig as JConfig
from repro.service import ServiceDaemon as JDaemon
from repro.service.daemon import ServiceClient as JClient
from repro_torch.chaos import ChaosProxy, FaultPlan, SkewClock
from repro_torch.core import features
from repro_torch.core.predictor import StragglerPredictor
from repro_torch.policy import wire
from repro_torch.service import (LocalClient, PredictionService, Profile,
                                 ServiceConfig, ServiceDaemon)
from repro_torch.service import protocol
from repro_torch.service.daemon import RetrainScheduler, ServiceClient

N_HOSTS, MAX_TASKS, HORIZON = 3, 4, 5


def pytest_generate_tests(metafunc):
    if "chaos_seed" in metafunc.fixturenames:
        raw = os.environ.get("REPRO_CHAOS_SEEDS", "0")
        seeds = [int(s) for s in raw.split(",") if s.strip()]
        metafunc.parametrize("chaos_seed", seeds or [0])


def profile(**kw) -> Profile:
    return Profile(n_hosts=N_HOSTS, max_tasks=MAX_TASKS, horizon=HORIZON,
                   **kw)


def config(**kw) -> ServiceConfig:
    return ServiceConfig(profile=profile(), device="cpu", **kw)


def rand_mh(rng):
    return rng.random((N_HOSTS, features.HOST_FEATURES)).astype(np.float32)


def rand_mt(rng, q=3):
    m_t = np.zeros((MAX_TASKS, features.TASK_FEATURES), np.float32)
    m_t[:q] = rng.random((q, features.TASK_FEATURES))
    return m_t


def mk_snap(tenant, seq, m_h, m_t, q=3, job_id=1):
    tasks = [(100 + i, i % N_HOSTS, i) for i in range(q)]
    return wire.snapshot_to_wire(
        tenant, seq, m_h,
        jobs=[wire.job_to_wire(job_id, q, m_t, tasks=tasks)])


def _reference_run(m_hs, m_t, q):
    pred = StragglerPredictor(n_hosts=N_HOSTS, max_tasks=MAX_TASKS,
                              horizon=HORIZON, device="cpu")
    out = None
    for m_h in m_hs:
        pred.push_host_row(m_h)
        out = pred.predict_interval(m_t[None],
                                    np.array([float(q)], np.float32))
    return out


# ------------------------------ SkewClock ---------------------------------

class _FakeBase:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_skewclock_advance_freeze_thaw_monotonic():
    base = _FakeBase()
    clk = SkewClock(base=base)
    t0 = clk()
    clk.advance(10.0)
    assert clk() == t0 + 10.0
    with pytest.raises(ValueError, match="monotonic"):
        clk.advance(-1.0)
    clk.freeze()
    a = clk()
    base.t += 3.0
    assert clk() == a                     # pinned
    clk.advance(5.0)
    assert clk() == a + 5.0               # skew applies while frozen
    clk.thaw()
    assert clk() == a + 5.0               # the frozen window folds away
    base.t += 1.0
    assert clk() == a + 6.0
    clk.thaw()                            # idempotent


def test_skewclock_triggers_wall_clock_retrain():
    clk = SkewClock(base=_FakeBase())
    sched = RetrainScheduler(60.0, clock=clk)
    assert not sched.due()
    clk.advance(61.0)
    assert sched.due()
    assert not sched.due()                # re-armed, fires once
    clk.freeze()
    clk.advance(200.0)                    # three missed periods coalesce
    assert sched.due() and not sched.due()


# ------------------------------ FaultPlan ---------------------------------

def _decisions(plan, seed, n=200):
    rng = random.Random(f"{seed}/0/c2s")
    return [plan.decide(rng, i) for i in range(n)]


PLANS = [
    dict(drop=0.05, delay=0.05, duplicate=0.05, truncate=0.05,
         corrupt=0.05),
    dict(reset=0.1, corrupt=0.2, skip_first=3, max_faults=7),
    dict(delay=0.3, delay_s=(0.001, 0.002), stall_after=11, stall_s=0.5),
    dict(corrupt=0.5, script={2: ("reset", None), 9: ("corrupt", 1234)}),
]


@pytest.mark.parametrize("seed", [0, 7, 8])
@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_fault_plan_decisions_match_jax(plan, seed):
    kw = PLANS[plan]
    got = _decisions(FaultPlan(**{k: (dict(v) if isinstance(v, dict)
                                      else v) for k, v in kw.items()}),
                     seed)
    want = _decisions(JFaultPlan(**{k: (dict(v) if isinstance(v, dict)
                                        else v) for k, v in kw.items()}),
                      seed)
    assert got == want
    assert any(k != "pass" for k, _ in got)


def test_fault_plan_budget_and_one_shot_script():
    plan = FaultPlan(corrupt=1.0, max_faults=3)
    _decisions(plan, 0, n=50)
    assert plan.faults_injected() == 3
    plan = FaultPlan(script={2: ("reset", None)})
    got = _decisions(plan, 0, n=5)
    assert got[2] == ("reset", None)
    assert _decisions(plan, 0, n=5)[2] == ("pass", None)


def test_fault_plan_stall_claimed_once():
    plan = FaultPlan(stall_after=1, stall_s=0.5)
    assert ("stall", 0.5) in _decisions(plan, 0, n=3)
    assert all(k == "pass" for k, _ in _decisions(plan, 0, n=3))


# ------------------------------ ChaosProxy --------------------------------

def _echo_server():
    srv = socket.create_server(("127.0.0.1", 0))
    host, port = srv.getsockname()

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return

            def pump(c):
                try:
                    while True:
                        d = c.recv(65536)
                        if not d:
                            return
                        c.sendall(d)
                except OSError:
                    pass
                finally:
                    c.close()
            threading.Thread(target=pump, args=(conn,), daemon=True).start()
    threading.Thread(target=serve, daemon=True).start()
    return srv, host, port


def test_proxy_passthrough_preserves_bytes(tmp_path):
    srv, host, port = _echo_server()
    try:
        with ChaosProxy((host, port), seed=0) as px:
            c = socket.create_connection((px.host, px.port), timeout=5)
            payload = bytes(range(256)) * 16
            c.sendall(payload)
            got = b""
            while len(got) < len(payload):
                got += c.recv(65536)
            assert got == payload
            c.close()
            assert px.events == []
            art = json.load(open(px.dump_artifact(str(tmp_path / "a.json"))))
            assert art["connections"] == 1 and art["seed"] == 0
    finally:
        srv.close()


def test_proxy_scripted_corrupt_and_duplicate():
    srv, host, port = _echo_server()
    try:
        plan = FaultPlan(script={0: ("corrupt", 1234),
                                 1: ("duplicate", None)})
        with ChaosProxy((host, port), seed=0, c2s=plan) as px:
            c = socket.create_connection((px.host, px.port), timeout=5)
            c.sendall(b"A" * 64)          # chunk 0: corrupted
            got = c.recv(65536)
            assert len(got) == 64 and got != b"A" * 64
            c.sendall(b"B" * 8)           # chunk 1: duplicated
            got = b""
            while len(got) < 16:
                got += c.recv(65536)
            assert got == b"B" * 16
            c.close()
        assert {e["fault"] for e in px.events} == {"corrupt", "duplicate"}
    finally:
        srv.close()


def test_proxy_reset_mid_chunk_gives_connreset():
    srv, host, port = _echo_server()
    try:
        plan = FaultPlan(script={0: ("reset", None)})
        with ChaosProxy((host, port), seed=0, c2s=plan) as px:
            c = socket.create_connection((px.host, px.port), timeout=5)
            with pytest.raises(OSError):   # RST mid-frame, not clean FIN
                c.sendall(b"X" * (1 << 16))
                for _ in range(50):
                    if c.recv(65536) == b"":
                        raise ConnectionResetError("EOF after reset")
            c.close()
        assert [e["fault"] for e in px.events] == ["reset"]
    finally:
        srv.close()


def test_proxy_quiesce_freezes_injection():
    srv, host, port = _echo_server()
    try:
        with ChaosProxy((host, port), seed=0,
                        c2s=FaultPlan(corrupt=1.0)) as px:
            px.quiesce()
            c = socket.create_connection((px.host, px.port), timeout=5)
            c.sendall(b"hello")
            assert c.recv(65536) == b"hello"
            c.close()
        assert px.events == []
    finally:
        srv.close()


# --------------------------- service hardening ----------------------------

def test_service_client_timeout_is_applied():
    srv = socket.create_server(("127.0.0.1", 0))
    host, port = srv.getsockname()
    conns = []
    threading.Thread(target=lambda: conns.append(srv.accept()),
                     daemon=True).start()
    c = ServiceClient(host, port, "t0", retries=1)
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        c.request({"op": "stats"}, timeout=0.4)
    assert time.perf_counter() - t0 < 5.0
    assert c._file is None                # connection dropped, not reused
    c.close()
    srv.close()


def test_max_line_peer_answered_then_dropped():
    with ServiceDaemon(config()) as d:
        sock = socket.create_connection(("127.0.0.1", d.port), timeout=10)
        sock.sendall(b"x" * (protocol.MAX_LINE + 16))
        f = sock.makefile("rb")
        resp = protocol.decode(f.readline())
        assert not resp["ok"] and resp["error"] == "frame-too-long"
        assert f.readline() == b""        # server dropped the connection
        sock.close()


def test_snapshot_resend_is_deduped_not_reapplied():
    svc = PredictionService(config())
    c = LocalClient(svc, "t0")
    assert c.hello(profile())["ok"]
    rng = np.random.default_rng(3)
    snap = mk_snap("t0", 0, rand_mh(rng), rand_mt(rng))
    r1 = c.snapshot(snap)
    assert r1["ok"] and "resent" not in r1
    r2 = c.snapshot(snap)
    assert r2["ok"] and r2["resent"] is True
    assert r2["jobs"] == r1["jobs"]
    st = svc.stats()
    assert st["snapshots"] == 1 and st["resends"] == 1
    assert c.snapshot(mk_snap("t0", 1, rand_mh(rng), rand_mt(rng)))["ok"]
    assert svc.stats()["snapshots"] == 2


def test_hello_token_auth(monkeypatch):
    monkeypatch.delenv("REPRO_SERVICE_TOKEN", raising=False)
    with ServiceDaemon(config(auth_token="s3cret")) as d:
        bad = ServiceClient("127.0.0.1", d.port, "t0", token="nope")
        r = bad.request({"op": "hello", "tenant": "t0",
                         "profile": profile().to_wire(), "token": "nope"})
        assert not r["ok"] and r["error"] == "auth-failed"
        bad.close()
        good = ServiceClient("127.0.0.1", d.port, "t0", token="s3cret")
        assert good.hello(profile())["ok"]
        st = good.stats()
        assert st["auth_failures"] == 1 and st["tenants"] == 1
        good.bye()


def test_token_from_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_SERVICE_TOKEN", "envtok")
    with ServiceDaemon(config()) as d:
        assert d.service.cfg.auth_token == "envtok"
        c = ServiceClient("127.0.0.1", d.port, "t0")   # token from env
        assert c.hello(profile())["ok"]
        c.bye()


def test_daemon_kill_restart_mid_stream(tmp_path):
    prof = profile()
    ckpt = str(tmp_path / "ckpt")
    d1 = ServiceDaemon(config(ckpt_dir=ckpt)).start()
    port = d1.port
    c = ServiceClient("127.0.0.1", port, "t0", retries=8, backoff_s=0.05)
    assert c.hello(prof)["ok"]
    rng = np.random.default_rng(11)
    m_t = rand_mt(rng)
    m_hs = [rand_mh(rng) for _ in range(6)]
    for i in range(3):
        assert c.snapshot(mk_snap("t0", i, m_hs[i], m_t))["ok"]
    assert d1.service.stats()["snapshots"] == 3
    d1.stop()                             # daemon dies mid-stream
    d2 = None
    for _ in range(20):                   # rebinding the same port
        try:
            d2 = ServiceDaemon(config(ckpt_dir=ckpt), port=port).start()
            break
        except OSError:
            time.sleep(0.1)
    assert d2 is not None, "could not rebind the daemon port"
    try:
        last = None
        for i in range(3, 6):             # client heals transparently
            last = c.snapshot(mk_snap("t0", i, m_hs[i], m_t))
            assert last["ok"], last
        ref = _reference_run(m_hs[3:], m_t, 3)
        assert last["jobs"][0]["e_s"] == float(ref[0])
        assert d2.service.stats()["snapshots"] == 3
        c.bye()
    finally:
        d2.stop()


def test_service_chaos_smoke_state_never_corrupted(chaos_seed, tmp_path):
    prof = profile()
    with ServiceDaemon(config()) as d:
        c2s = FaultPlan(reset=0.05, skip_first=2, max_faults=2)
        s2c = FaultPlan(corrupt=0.10, reset=0.05, skip_first=2,
                        max_faults=3)
        with ChaosProxy(("127.0.0.1", d.port), seed=chaos_seed,
                        c2s=c2s, s2c=s2c) as px:
            c = ServiceClient(px.host, px.port, "t0", retries=8,
                              backoff_s=0.05, timeout=5.0)
            assert c.hello(prof)["ok"]
            rng = np.random.default_rng(2)
            m_t = rand_mt(rng)
            m_hs = [rand_mh(rng) for _ in range(8)]
            for i, m_h in enumerate(m_hs[:-1]):
                r = None
                for _ in range(6):        # resends dedupe server-side
                    try:
                        r = c.snapshot(mk_snap("t0", i, m_h, m_t))
                    except (ConnectionError, TimeoutError):
                        continue
                    if isinstance(r, dict) and r.get("ok"):
                        break
                assert isinstance(r, dict) and r.get("ok"), r
            px.quiesce()
            r = c.snapshot(mk_snap("t0", len(m_hs) - 1, m_hs[-1], m_t))
            assert r["ok"]
            ref = _reference_run(m_hs, m_t, 3)
            assert r["jobs"][0]["e_s"] == float(ref[0])
            assert d.service.stats()["snapshots"] == len(m_hs), \
                "an interval was lost or double-applied under chaos"
            px.dump_artifact(str(tmp_path / f"smoke-seed{chaos_seed}.json"))
            c.bye()


def test_service_restart_survives_torn_pointer(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    svc = PredictionService(config(ckpt_dir=ckpt))
    assert svc.model_version == 0 and not svc.degraded
    with open(os.path.join(ckpt, "CURRENT"), "w") as f:
        f.write('{"curr')                 # torn mid-write
    svc2 = PredictionService(config(ckpt_dir=ckpt))
    assert not svc2.degraded and svc2.model_version == 0


# --------------------------- one wire, two packages -----------------------

def _session(client_cls, host, port, tenant, snaps, prof_wire) -> list:
    """hello, the snapshots, stats and bye through one client; the
    answers as JSON text (what crossed the wire)."""
    c = client_cls(host, port, tenant)

    class _P:
        def to_wire(self):
            return prof_wire

    out = [c.hello(_P())]
    out += [c.snapshot(s) for s in snaps]
    st = c.stats()
    out.append({k: v for k, v in st.items() if k != "compile_count"})
    out.append(c.bye())
    return [json.dumps(r, sort_keys=True) for r in out]


@pytest.mark.parametrize("daemon", ["port", "jax"])
def test_clients_of_either_package_get_the_same_answers(daemon):
    rng = np.random.default_rng(4)
    m_t = rand_mt(rng)
    snaps = [mk_snap("w", i, rand_mh(rng), m_t) for i in range(4)]
    prof_wire = profile().to_wire()

    def serve():
        if daemon == "port":
            return ServiceDaemon(config())
        return JDaemon(JConfig(profile=JProfile(**prof_wire)))

    answers = {}
    for name, cls in (("port", ServiceClient), ("jax", JClient)):
        with serve() as d:
            answers[name] = _session(cls, "127.0.0.1", d.port, "w", snaps,
                                     prof_wire)
    assert answers["jax"] == answers["port"]
    first = json.loads(answers["port"][1])
    assert first["ok"] and len(first["jobs"]) == 1
