"""Discrete-interval cloud simulation engine (CloudSim analogue, §4.3).

Semantics per scheduling interval (300 s):
  1. host downtimes tick down; new jobs arrive (Poisson);
  2. the bound Policy sees a submit-time TelemetryView (clone/delay);
  3. pending tasks are placed by the shared scheduler (VM-creation faults
     bounce placements);
  4. Weibull fault events fire (host downtime -> resident tasks restart;
     cloudlet faults -> task restarts);
  5. the Policy observes an interval TelemetryView and decides
     speculate/rerun actions;
  6. tasks progress at host effective speed (contention + heterogeneity);
     completions are interpolated within the interval;
  7. metrics are recorded; completed jobs update per-host straggler
     moving averages (ground truth via per-job Pareto-K threshold).

Policies never touch ``sim.tasks``/``sim.cluster`` directly: the
``Simulation.snapshot()`` view (``repro_torch.policy.telemetry``) is the only
state they read, and ``repro_torch.policy.Action`` the only way they act.

Speculative copies are first-result-wins: whichever of {original, copy}
finishes first completes the logical task and cancels the others.
"""
from __future__ import annotations

import time as _time

import numpy as np

from repro_torch.core import pareto
from repro_torch.policy import (Action, Policy, TelemetryView,
                                EVENT_INTERVAL, EVENT_SUBMIT)
from repro_torch.policy.telemetry import (CANCELLED, DONE, PENDING, RUNNING,
                                          HostTelemetry, JobTelemetry,
                                          make_task_telemetry, readonly)
from repro_torch.sim import metrics as M
from repro_torch.sim.cluster import Cluster
from repro_torch.sim.config import SimConfig
from repro_torch.sim.faults import FaultInjector, FaultKind
from repro_torch.sim.scheduler import Scheduler, UtilizationAwareScheduler
from repro_torch.sim.workload import WorkloadGenerator

__all__ = ["PENDING", "RUNNING", "DONE", "CANCELLED", "TaskTable",
           "JobTable", "SimAction", "Technique", "NoMitigation",
           "Simulation"]


class TaskTable:
    """Struct-of-arrays task store with amortized growth."""

    _F = dict(job_id=np.int64, state=np.int8, host=np.int64,
              work=np.float64, progress=np.float64, submit_s=np.float64,
              start_s=np.float64, finish_s=np.float64, deadline_s=np.float64,
              is_deadline=bool, sla_weight=np.float64, restarts=np.int64,
              is_copy=bool, orig=np.int64, delayed_until=np.int64,
              prev_host=np.int64)

    def __init__(self, cap: int = 1024):
        self.n = 0
        self._cap = cap
        for f, dt in self._F.items():
            setattr(self, f, np.zeros(cap, dt))
        self.req = np.zeros((cap, 4))

    def _grow(self, need: int) -> None:
        if self.n + need <= self._cap:  # amortized O(1): copy only on growth
            return
        while self.n + need > self._cap:
            self._cap *= 2
        for f, dt in self._F.items():
            a = getattr(self, f)
            b = np.zeros(self._cap, dt)
            b[:len(a)] = a
            setattr(self, f, b)
        r = np.zeros((self._cap, 4))
        r[:len(self.req)] = self.req
        self.req = r

    def add(self, **kw) -> int:
        return int(self.add_batch(1, **kw)[0])

    def add_batch(self, n_new: int, **kw) -> np.ndarray:
        """Vectorized add of n_new tasks; kw values are scalars or (n_new,)
        arrays. Returns the new task indices."""
        if n_new == 0:
            return np.zeros(0, np.int64)
        self._grow(n_new)
        idx = np.arange(self.n, self.n + n_new, dtype=np.int64)
        self.n += n_new
        self.host[idx] = -1
        self.orig[idx] = -1
        self.prev_host[idx] = -1
        self.finish_s[idx] = -1.0
        for k, v in kw.items():
            getattr(self, k)[idx] = v
        return idx

    def active_mask(self) -> np.ndarray:
        return (self.state[:self.n] == RUNNING)

    def view(self, field: str) -> np.ndarray:
        return getattr(self, field)[:self.n]


class JobTable:
    """CSR job index with amortized growth.

    Job ``j``'s original tasks are the contiguous TaskTable range
    ``[start[j], start[j] + count[j])`` — arrivals append whole jobs in
    submission order and speculative copies are never job members — so
    per-job lookups are O(1) slices and the active-job scan is one
    vectorized mask over dense arrays (no dict bookkeeping).
    """

    _F = dict(start=np.int64, count=np.int64, open_count=np.int64,
              done=bool, deadline=bool)

    def __init__(self, cap: int = 256):
        self.n = 0
        self._cap = cap
        for f, dt in self._F.items():
            setattr(self, f, np.zeros(cap, dt))

    def _grow(self, need: int) -> None:
        if self.n + need <= self._cap:
            return
        while self.n + need > self._cap:
            self._cap *= 2
        for f, dt in self._F.items():
            a = getattr(self, f)
            b = np.zeros(self._cap, dt)
            b[:len(a)] = a
            setattr(self, f, b)

    def add_batch(self, first_task: np.ndarray, counts: np.ndarray,
                  deadline: np.ndarray) -> None:
        n_new = len(counts)
        if n_new == 0:
            return
        self._grow(n_new)
        idx = np.arange(self.n, self.n + n_new)
        self.n += n_new
        self.start[idx] = first_task
        self.count[idx] = counts
        self.open_count[idx] = counts
        self.deadline[idx] = deadline

    def view(self, field: str) -> np.ndarray:
        return getattr(self, field)[:self.n]

    def task_ids(self, job: int) -> np.ndarray:
        s = int(self.start[job])
        return np.arange(s, s + int(self.count[job]), dtype=np.int64)

    def active(self) -> np.ndarray:
        return np.nonzero((self.open_count[:self.n] > 0)
                          & ~self.done[:self.n])[0]


#: the simulator's historical action type — now the unified vocabulary.
#: ``SimAction("clone", i, n_clones=2)`` keeps constructing as before.
SimAction = Action


class Technique(Policy):
    """Legacy adapter for engine-coupled techniques.

    New policies subclass :class:`repro_torch.policy.Policy` and consume only
    the :class:`TelemetryView`; this adapter keeps the old
    ``bind(sim)`` / ``on_submit`` / ``on_interval`` surface working for
    existing subclasses (tests, ad-hoc drills) by translating the
    policy-protocol calls back into the old hooks.
    """

    name = "none"
    sim: "Simulation"

    def bind(self, sim: "Simulation") -> None:
        self.sim = sim

    def on_submit(self, new_idx: np.ndarray) -> list[Action]:
        return []

    def on_interval(self) -> list[Action]:
        return []

    def decide(self, view: TelemetryView) -> list[Action]:
        if view.event == EVENT_SUBMIT:
            return self.on_submit(view.new_tasks)
        return self.on_interval()


class NoMitigation(Technique):
    name = "none"


class Simulation:
    def __init__(self, cfg: SimConfig, technique: Policy | None = None,
                 scheduler: Scheduler | None = None):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.cluster = Cluster(cfg, self.rng)
        self.workload = WorkloadGenerator(cfg, self.rng)
        self.faults = FaultInjector(cfg, self.rng)
        self.scheduler = scheduler or UtilizationAwareScheduler()
        self.technique = technique or NoMitigation()
        if hasattr(self.technique, "bind"):  # legacy Technique subclasses
            self.technique.bind(self)
        self.tasks = TaskTable()
        self.jobs = JobTable()
        self.log = M.MetricsLog()
        self.t = 0  # current interval index
        self.host_ips = cfg.host_ips_array()  # (n_hosts,) MI/s per speed
        # incremental job-completion bookkeeping (no per-interval
        # all-jobs/all-tasks scan): the JobTable's open counts, jobs that
        # hit zero this interval, and orig -> copy ids so first-result-wins
        # cancellation never scans the full task table
        self._jobs_newly_closed: list[int] = []
        self._copy_groups: dict[int, list[int]] = {}
        self.straggler_ma = np.zeros(cfg.n_hosts)
        self.host_straggler_counts = np.zeros(cfg.n_hosts)
        # per completed job: (finish interval, task times, straggler flags,
        # hosts) for ground-truth accounting
        self.completed_jobs: list[dict] = []
        self._interval_straggler_done: list[int] = []
        self.util_history: list[np.ndarray] = []  # (n_hosts, 4) per interval

    # ------------------------------ helpers -------------------------------

    @property
    def now_s(self) -> float:
        return self.t * self.cfg.interval_seconds

    def active_jobs(self) -> np.ndarray:
        return self.jobs.active()

    def job_incomplete_tasks(self, job: int) -> np.ndarray:
        t = self.jobs.task_ids(job)
        return t[self.tasks.state[t] <= RUNNING]

    def snapshot(self, event: str = EVENT_INTERVAL,
                 new_tasks: np.ndarray | None = None) -> TelemetryView:
        """Publish the policy-facing telemetry view (paper M_H/M_T inputs
        plus clocks and the job index).

        Zero-copy: every array is a read-only numpy view onto live engine
        buffers, so the view reflects engine state *at the moment a
        policy reads it* and is only valid for the current hook call.
        """
        tt, c = self.tasks, self.cluster
        return TelemetryView(
            event=event, t=self.t, now_s=self.now_s,
            interval_seconds=self.cfg.interval_seconds, config=self.cfg,
            tasks=make_task_telemetry(tt.n, tt.view, tt.req[:tt.n]),
            hosts=HostTelemetry(
                util=readonly(c.util), speed=readonly(c.speed),
                cap=readonly(c.cap), cost=readonly(c.cost),
                power_max=readonly(c.power_max),
                power_min=readonly(c.power_min),
                n_tasks=readonly(c.n_tasks),
                downtime=readonly(c.downtime),
                ips=readonly(self.host_ips)),
            jobs=JobTelemetry(
                start=readonly(self.jobs.view("start")),
                count=readonly(self.jobs.view("count")),
                open_count=readonly(self.jobs.view("open_count")),
                done=readonly(self.jobs.view("done")),
                deadline=readonly(self.jobs.view("deadline")),
                _state=tt.view("state")),
            new_tasks=(np.asarray(new_tasks, np.int64)
                       if new_tasks is not None
                       else np.zeros(0, np.int64)),
            straggler_ma=readonly(self.straggler_ma),
            completed_jobs=self.completed_jobs,
            util_history=self.util_history,
            rng=self.rng)

    def _place(self, i: int, forced: int | None = None) -> None:
        """Place task i (VM-creation faults bounce to rescheduling)."""
        tt = self.tasks
        host = forced if forced is not None else self.scheduler.place(
            self.cluster, tt.req[i], self.rng,
            exclude=int(tt.prev_host[i]) if tt.prev_host[i] >= 0 else None)
        if self.cluster.downtime[host] > 0:
            host = self.scheduler.place(self.cluster, tt.req[i], self.rng)
        tt.host[i] = host
        tt.state[i] = RUNNING
        if tt.start_s[i] == 0.0:
            tt.start_s[i] = self.now_s

    # ---------------------------- main stepping ----------------------------

    def step(self) -> None:
        cfg, tt = self.cfg, self.tasks
        self.cluster.begin_interval()
        self._interval_straggler_done = []

        # 1. arrivals (batched task insertion)
        batch = self.workload.sample_interval(self.t)
        new_idx = tt.add_batch(
            len(batch.job_ids), job_id=batch.job_ids, state=PENDING,
            work=batch.work, submit_s=self.now_s,
            deadline_s=batch.deadline_rel, is_deadline=batch.is_deadline,
            sla_weight=batch.sla_weight)
        if len(new_idx):
            tt.req[new_idx] = batch.req
            # whole jobs arrive as contiguous task blocks with dense,
            # sequential ids — register them in the CSR job table
            firsts = np.nonzero(np.r_[True,
                                      batch.job_ids[1:]
                                      != batch.job_ids[:-1]])[0]
            counts = np.diff(np.r_[firsts, len(batch.job_ids)])
            if (batch.job_ids[firsts]
                    != np.arange(self.jobs.n,
                                 self.jobs.n + len(firsts))).any():
                raise AssertionError(
                    "workload batches must emit dense, sequential job ids "
                    "with each job's tasks contiguous (CSR job index)")
            self.jobs.add_batch(new_idx[firsts], counts,
                                batch.is_deadline[firsts])

        # 2. policy submit-time decision point (clone / delay) — skipped
        # for policies that declare submit_hook=False (the view and an
        # ignoring decide() are both pure, so this is behavior-preserving)
        t0 = _time.perf_counter()
        if getattr(self.technique, "submit_hook", True):
            for act in self.technique.decide(self.snapshot(EVENT_SUBMIT,
                                                           new_idx)):
                self._apply(act)
        submit_overhead = _time.perf_counter() - t0

        # 3. schedule pending tasks whose delay has expired — one
        # place_batch call for the whole interval (bitwise-equal to the
        # old per-task loop), then bounce VM-creation-fault placements
        events = self.faults.interval_events()
        vm_fault_hosts = [e.host for e in events
                          if e.kind == FaultKind.VM_CREATION]
        ready = np.nonzero((tt.view("state") == PENDING)
                           & (tt.view("delayed_until") <= self.t))[0]
        if ready.size:
            hosts = self.scheduler.place_batch(
                self.cluster, tt.req[ready], self.rng,
                exclude=tt.prev_host[ready])
            tt.host[ready] = hosts
            tt.state[ready] = RUNNING
            fresh = ready[tt.start_s[ready] == 0.0]
            tt.start_s[fresh] = self.now_s
            if vm_fault_hosts:
                bounced = ready[np.isin(hosts, vm_fault_hosts)]
                if bounced.size:                # VM creation fault: bounce
                    tt.state[bounced] = PENDING  # to next interval; avoid
                    tt.restarts[bounced] += 1    # the host on re-place; a
                    tt.prev_host[bounced] = tt.host[bounced]  # pending task
                    tt.host[bounced] = -1        # holds no host

        # 4. fault events: host downtime restarts residents, cloudlet
        # faults restart sampled active tasks (both batched)
        failed = [ev for ev in events if ev.kind == FaultKind.HOST]
        for ev in failed:
            self.cluster.fail_host(ev.host, ev.downtime)
        if failed:
            self._restart_batch(np.nonzero(
                (tt.view("state") == RUNNING)
                & np.isin(tt.view("host"),
                          [ev.host for ev in failed]))[0])
        active = tt.active_mask()
        cl_faults = self.faults.cloudlet_faults(int(active.sum()))
        self._restart_batch(np.nonzero(active)[0][cl_faults])

        # 5. policy interval decision point (speculate / rerun): one view
        # feeds telemetry ingestion and the decision — same state, built
        # zero-copy once
        t0 = _time.perf_counter()
        view = self.snapshot(EVENT_INTERVAL)
        self.technique.observe(view)
        for act in self.technique.decide(view):
            self._apply(act)
        predicted = self.technique.predicted_straggler_count()
        interval_overhead = _time.perf_counter() - t0 + submit_overhead

        # 6. progress
        active = tt.active_mask()
        self.cluster.recompute_utilization(tt.view("req")[:, :],
                                           tt.view("host"), active)
        rate = self.cluster.effective_speed() * self.host_ips  # MI/s, per host
        run = np.nonzero(active)[0]
        inc = rate[tt.host[run]] * cfg.interval_seconds
        prog0 = tt.progress[run]
        tt.progress[run] = prog0 + inc
        finished = tt.progress[run] >= tt.work[run]
        fin_idx = run[finished]
        if fin_idx.size:
            frac = np.clip((tt.work[fin_idx] - prog0[finished])
                           / np.maximum(inc[finished], 1e-9), 0, 1)
            fins = self.now_s + frac * cfg.interval_seconds
            # first-result-wins is decided by interpolated finish time:
            # complete earliest-first and skip tasks a sibling already
            # cancelled (or completed) earlier within this interval
            order = np.argsort(fins, kind="stable")
            for i, fs in zip(fin_idx[order], fins[order]):
                if tt.state[i] == RUNNING:
                    self._complete(int(i), float(fs))

        self.util_history.append(self.cluster.util.copy())

        # 7. metrics + ground-truth straggler accounting
        cont = M.contention_metric(self.cluster, tt.view("req"),
                                   tt.view("host"), tt.active_mask())
        self.log.record_interval(self.cluster, cont,
                                 int(tt.active_mask().sum()), predicted,
                                 interval_overhead)
        self._update_job_completion()
        self.t += 1

    def run(self) -> dict:
        for _ in range(self.cfg.n_intervals):
            self.step()
        return self.summary()

    def summary(self) -> dict:
        s = M.summarize(self.log, self.tasks, self.cfg.interval_seconds,
                        self.cfg.restart_overhead_s)
        s["technique"] = self.technique.name
        s["jobs_done"] = int(self.jobs.view("done").sum())
        return s

    # ------------------------------ actions -------------------------------

    def _apply(self, act: SimAction) -> None:
        tt = self.tasks
        i = act.task
        if tt.state[i] not in (PENDING, RUNNING):
            return
        if act.kind == "delay":
            if tt.state[i] == PENDING:
                tt.delayed_until[i] = self.t + act.delay
        elif act.kind == "rerun":
            self._restart(i, target=act.target)
        elif act.kind in ("speculate", "clone"):
            for c in range(act.n_clones if act.kind == "clone" else 1):
                j = tt.add(job_id=tt.job_id[i], state=PENDING,
                           work=tt.work[i], submit_s=self.now_s,
                           deadline_s=tt.deadline_s[i],
                           is_deadline=tt.is_deadline[i],
                           sla_weight=tt.sla_weight[i], is_copy=True,
                           orig=i)
                tt.req[j] = tt.req[i]
                self._copy_groups.setdefault(int(i), []).append(j)
                self._place(j, forced=act.target)

    def _restart(self, i: int, target: int | None = None) -> None:
        tt = self.tasks
        tt.progress[i] = 0.0
        tt.restarts[i] += 1
        tt.prev_host[i] = tt.host[i]
        if target is not None:
            self._place(i, forced=target)
        else:
            tt.state[i] = PENDING
            tt.host[i] = -1

    def _restart_batch(self, idx: np.ndarray) -> None:
        """Fault-path restarts (no forced target): tasks lose progress and
        re-queue unplaced, remembering the host for re-place avoidance."""
        if idx.size == 0:
            return
        tt = self.tasks
        tt.progress[idx] = 0.0
        tt.restarts[idx] += 1
        tt.prev_host[idx] = tt.host[idx]
        tt.state[idx] = PENDING
        tt.host[idx] = -1

    def _complete(self, i: int, finish_s: float) -> None:
        tt = self.tasks
        tt.state[i] = DONE
        tt.finish_s[i] = finish_s
        # first-result-wins across the whole copy DAG: techniques may
        # speculate on running copies, so resolve the chain to the true
        # original, complete it with the winner's stamp, and cancel every
        # other member reachable from the root — a one-level cancel would
        # leave grandchild copies running (and later "completing") after
        # the logical task is done
        root = i
        while tt.is_copy[root]:
            root = int(tt.orig[root])
        if root == i:
            self._close_original(i)
        elif tt.state[root] in (PENDING, RUNNING):
            tt.state[root] = DONE
            tt.finish_s[root] = finish_s
            self._close_original(root)
        stack = [root]
        while stack:
            for g in self._copy_groups.get(stack.pop(), ()):
                if tt.state[g] != DONE:
                    tt.state[g] = CANCELLED
                stack.append(g)

    def _close_original(self, i: int) -> None:
        """Original task i reached a terminal state: update the per-job open
        count and queue the job for ground-truth accounting at zero."""
        job = int(self.tasks.job_id[i])
        self.jobs.open_count[job] -= 1
        if self.jobs.open_count[job] == 0 and not self.jobs.done[job]:
            self._jobs_newly_closed.append(job)

    # ----------------------- job-level bookkeeping ------------------------

    def _update_job_completion(self) -> None:
        """Ground-truth accounting for jobs whose last original task reached
        a terminal state this interval (tracked incrementally by
        ``_close_original`` — no all-jobs/all-tasks rescan)."""
        tt = self.tasks
        k = self.cfg.k
        counts = np.zeros(self.cfg.n_hosts)
        for job in self._jobs_newly_closed:
            tids = self.jobs.task_ids(job)
            times = np.maximum(tt.finish_s[tids] - tt.submit_s[tids], 1e-3)
            hosts = tt.host[tids].copy()
            a, b = pareto.fit_pareto_np(times)
            thr = float(pareto.straggler_threshold_np(a, b, k))
            strag = times > thr
            # a task finished via its copy while unplaced has host == -1;
            # don't let the wrap-around credit the last host
            placed = strag & (hosts >= 0)
            np.add.at(counts, hosts[placed], 1)
            self.jobs.done[job] = True
            self.completed_jobs.append(dict(
                job=job, t=self.t, times=times, straggler=strag,
                hosts=hosts, deadline=bool(self.jobs.deadline[job])))
        self._jobs_newly_closed = []
        decay = 0.8
        self.straggler_ma = decay * self.straggler_ma + (1 - decay) * counts
        self.host_straggler_counts += counts

    # ------------------ post-hoc per-interval actuals (MAPE) ---------------

    def actual_stragglers_per_interval(self) -> np.ndarray:
        """actual_t = number of straggler tasks active at interval t.

        Computable only post-hoc (a task is a straggler relative to its
        job's fitted Pareto threshold once the job completes).
        """
        out = np.zeros(self.t)
        if self.t == 0 or not self.completed_jobs:
            return out
        dt = self.cfg.interval_seconds
        tt = self.tasks
        tids = np.concatenate(
            [self.jobs.task_ids(rec["job"])
             for rec in self.completed_jobs])
        flags = np.concatenate(
            [np.asarray(rec["straggler"], bool)
             for rec in self.completed_jobs])
        tids = tids[flags]
        if tids.size == 0:
            return out
        # difference-array accumulation over [lo, hi] interval spans
        lo = (tt.submit_s[tids] // dt).astype(np.int64)
        hi = (np.maximum(tt.finish_s[tids], tt.submit_s[tids])
              // dt).astype(np.int64)
        lo = np.clip(lo, 0, self.t)
        hi_end = np.clip(np.minimum(hi + 1, self.t), 0, self.t)
        diff = np.zeros(self.t + 1)
        np.add.at(diff, lo, 1.0)
        np.add.at(diff, hi_end, -1.0)
        return np.cumsum(diff)[:self.t]
