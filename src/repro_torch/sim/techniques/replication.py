"""Replication-timing and redundancy-level baseline families (a numpy
copy of the JAX package's ``repro.sim.techniques.replication``).

Two policy families from the replication literature the paper's
evaluation field draws on, as first-class registry entries on the
unified policy API (both substrates):

* **Replication timing** — Wang, Joshi & Wornell, "Efficient Straggler
  Replication in Large-scale Parallel Computing": wait until a fraction
  ``p`` of a job's work is complete, then replicate the tasks still in
  the tail (single fork).  ``single-fork`` keeps originals running
  (first result wins); ``fork-relaunch`` is the earliest-kill variant
  (kill the laggard, relaunch fresh on a new host).  The fork point is
  not a fixed delay: when ``p`` is not pinned it is chosen from the
  *empirical* execution-time tail — the existing Pareto MLE fit plus
  the fork-point quantile helper — by minimizing an approximate
  ``latency + cost_weight * cost`` objective over candidate fractions
  (``cost_weight`` is the paper's latency-vs-cost knob: 0 buys latency
  at any cost, large values replicate only when nearly free).

* **Redundancy level** — Aktas & Soljanin, "Optimizing Redundancy
  Levels in Master-Worker Compute Clusters for Straggler Mitigation":
  launch every task with ``r`` replicas up front (``redundancy-fixed``)
  — and, since their central observation is that the optimal ``r``
  flips with load, ``redundancy-adaptive`` scales ``r`` down from
  ``r_max`` toward 1 as task-attributable utilization (observed CPU
  utilization minus the configured reserved floor — the same signal
  START's regime-adaptive guard uses) approaches ``util_knee``.

Both families also run on the distributed training pod: the runtime
translates ``speculate`` to a backup shard and ``rerun`` to an eviction,
and each host's horizon-step window is one synthetic task, so the fork
trigger (window progress fraction) and the tail filter (window-elapsed
beyond the fitted fork quantile) carry over unchanged.

Decide paths are vectorized: per-interval work is numpy over the CSR
job index (segment sums over contiguous task ranges) — Python loops
touch only the handful of emitted actions, never the task table.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import pareto
from repro_torch.policy import (Action, DONE, EVENT_INTERVAL, EVENT_SUBMIT,
                          Policy, PretrainContext, RUNNING, TelemetryView,
                          register)

#: candidate launch fractions for the tail-adaptive fork point
P_GRID = np.linspace(0.50, 0.95, 10)
#: minimum completed-task samples before trusting the online tail fit
MIN_TAIL_SAMPLES = 8
#: nominal tail size the fork objective prices replicas against (the
#: paper's jobs have 2-10 tasks; what matters is only that forking
#: earlier replicates *more* tasks, so the constant's scale is enough)
TAIL_Q = 8.0


# ----------------------- fork-point objective (Wang) -----------------------

def _integral_grid() -> np.ndarray:
    # fixed quadrature grid in units of beta: dense below beta (where the
    # fresh replica cannot finish), log-spaced into the tail
    return np.concatenate([np.linspace(0.0, 1.0, 33)[1:],
                           np.geomspace(1.0, 256.0, 64)[1:]])


def fork_objective(alpha: float, p: np.ndarray, cost_weight: float,
                   kill: bool) -> np.ndarray:
    """Approximate normalized cost of forking at fraction ``p``.

    Scale-free (everything in units of beta, so only the tail index
    matters).  A task still running at the fork point t_p = F^{-1}(p)
    has residual R with P(R > s) = ((t_p+s)/t_p)^-alpha; a fresh
    replica Y is Pareto(alpha, 1).  Each of the m = TAIL_Q * (1-p)
    forked tasks then finishes after a further Z = min(R, Y) (no kill)
    or Z = Y (kill/relaunch), so

        J(p) = t_p + E[Z] * max(1, m)^(1/a_Z)
                   + cost_weight * m * E[replica runtime]

    where a_Z is Z's regular-variation index (2*alpha for the min of
    two alpha-tails, alpha after a kill) and m^(1/a_Z) is the standard
    Frechet growth rate of the max of m heavy-tailed residuals — the
    order-statistics term that makes early forking pay a latency *and*
    cost price for replicating more of the job.  A coarse stand-in for
    Wang et al.'s exact expressions, but it preserves what the policy
    consumes: cost_weight up -> fork later, kill variants fork later
    than no-kill ones, heavier tails fork earlier.
    """
    p = np.asarray(p, np.float64)
    t_p = pareto.pareto_quantile_np(alpha, 1.0, p)          # (P,)
    s = _integral_grid()                                     # (S,)
    surv_r = ((t_p[:, None] + s[None, :]) / t_p[:, None]) ** (-alpha)
    surv_y = np.where(s >= 1.0, s ** (-alpha), 1.0)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    e_min = trapezoid(surv_r * surv_y[None, :], s, axis=1)   # E[min(R, Y)]
    e_y = alpha / (alpha - 1.0)                              # E[Y], alpha > 1
    m = TAIL_Q * (1.0 - p)
    if kill:
        e_z, a_z = e_y, alpha
    else:
        e_z, a_z = e_min, 2.0 * alpha
    latency = t_p + e_z * np.maximum(m, 1.0) ** (1.0 / a_z)
    return latency + cost_weight * m * e_z


def fork_fraction(alpha: float, cost_weight: float, kill: bool) -> float:
    """The launch fraction minimizing :func:`fork_objective` on ``P_GRID``."""
    return float(P_GRID[int(np.argmin(
        fork_objective(alpha, P_GRID, cost_weight, kill)))])


# -------------------- replication-timing policies (Wang) -------------------

@register("single-fork", substrates=("sim", "pod"),
          description="single-fork replication at launch fraction p, fork "
                      "point from the empirical Pareto tail; originals "
                      "keep running, first result wins [Wang et al.]")
class SingleFork(Policy):
    """Replicate a job's tail once a fraction ``p`` of its work is done.

    ``p=None`` (default) re-derives the launch fraction every interval
    from the fitted execution-time tail via :func:`fork_fraction`;
    passing ``p`` pins it.  Pretraining (generic, through the registry)
    seeds the tail estimate from a warmup run so early jobs fork
    sensibly before enough completions accumulate online.
    """

    name = "single-fork"
    kill = False

    def __init__(self, p: float | None = None, cost_weight: float = 0.5,
                 alpha0: float | None = None, beta0: float | None = None):
        self.p = p
        self.cost_weight = cost_weight
        self.alpha0 = alpha0
        self.beta0 = beta0
        self._forked: set[int] = set()

    @classmethod
    def pretrain(cls, ctx: PretrainContext) -> "SingleFork":
        warm = ctx.warmup()
        tech = cls(**ctx.kwargs)
        times = _done_original_times(warm)
        if times.size >= 2:
            a, b = pareto.fit_pareto_np(times.astype(np.float32))
            tech.alpha0, tech.beta0 = float(a), float(b)
        return tech

    def forget_tasks(self, task_ids) -> None:
        # substrate signal that task ids were rebound (the pod runtime, at
        # every horizon-window boundary): the new window is a new "job",
        # so the fork-once latch must reset with it
        self._forked.clear()

    # ----------------------------- tail model -----------------------------

    def _tail(self, view: TelemetryView) -> tuple[float, float] | None:
        times = _done_original_times(view)
        if times.size == 0 and _on_pod(view) and view.completed_jobs:
            # pod substrate ONLY: window tasks never reach DONE, so the
            # completed horizon-window records carry the per-host elapsed
            # times.  On the simulator these records hold queue-inclusive
            # sojourn times (finish - submit), which would inflate beta —
            # there the policy waits for real execution-time samples.
            times = np.concatenate(
                [np.asarray(r["times"], np.float64)
                 for r in view.completed_jobs])
        if times.size >= MIN_TAIL_SAMPLES:
            a, b = pareto.fit_pareto_np(times.astype(np.float32))
            return float(a), float(b)
        if self.alpha0 is not None and self.beta0 is not None:
            return self.alpha0, self.beta0
        return None

    # ------------------------------- decide --------------------------------

    def decide(self, view: TelemetryView) -> list[Action]:
        if view.event != EVENT_INTERVAL:
            return []
        tail = self._tail(view)
        if tail is None:
            return []
        alpha, beta = tail
        p = self.p if self.p is not None else fork_fraction(
            alpha, self.cost_weight, self.kill)
        if _on_pod(view) and view.tasks.n:
            # a pod window's progress fraction tops out one step short of
            # the horizon ((horizon-1)/horizon, work == horizon): clamp
            # the fork point strictly below that (epsilon absorbs the
            # one-ulp float gap vs the bincount-computed fraction), or a
            # late adaptive p silently never triggers on the pod
            horizon = float(np.max(view.tasks.work))
            if horizon > 1.0:
                p = min(p, 1.0 - 1.0 / horizon - 1e-9)
        jobs = view.jobs
        active = jobs.active()
        if self._forked:
            forked = np.fromiter(self._forked, np.int64,
                                 len(self._forked))
            active = active[~np.isin(active, forked)]
        if active.size == 0:
            return []
        # per-job completed work fraction over the CSR task ranges, one
        # vectorized segment mean (done tasks contribute 1.0)
        tt = view.tasks
        counts = jobs.count[active]
        rows = np.repeat(np.arange(len(active)), counts)
        offs = (np.arange(int(counts.sum()))
                - np.repeat(np.cumsum(counts) - counts, counts))
        tids = np.repeat(jobs.start[active], counts) + offs
        frac = np.clip(tt.progress[tids]
                       / np.maximum(tt.work[tids], 1e-9), 0.0, 1.0)
        done_frac = np.bincount(rows, weights=frac,
                                minlength=len(active)) / counts
        trig = done_frac >= p
        if not trig.any():
            return []
        # the fork set: running tasks of triggered jobs already past the
        # fork-point quantile of the fitted tail (under the model, every
        # task alive beyond t_p is a tail task)
        t_p = float(pareto.pareto_quantile_np(alpha, beta, p))
        cand_mask = (trig[rows]
                     & (tt.state[tids] == RUNNING)
                     & (view.now_s - tt.start_s[tids] > t_p))
        # the fork-once latch applies to jobs that actually forked; a job
        # triggered while its tail tasks are still pending/restarting
        # stays eligible, otherwise its eventual stragglers would never
        # be replicated
        self._forked.update(int(j)
                            for j in active[np.unique(rows[cand_mask])])
        cand = tids[cand_mask]
        if cand.size == 0:
            return []
        h = view.hosts
        score = np.where(h.online(), h.util[:, 0] - 0.2 * h.speed, np.inf)
        order = np.argsort(score, kind="stable")
        order = order[np.isfinite(score[order])]       # online hosts only
        if order.size == 0:
            return []
        kind = "rerun" if self.kill else "speculate"
        acts = []
        for rank, i in enumerate(cand):                # fork set only —
            i = int(i)                                 # never the task table
            tgt = int(order[rank % len(order)])
            if tgt == int(tt.host[i]) and len(order) > 1:
                tgt = int(order[(rank + 1) % len(order)])
            acts.append(Action(kind, i, target=tgt))
        return acts


@register("fork-relaunch", substrates=("sim", "pod"),
          description="earliest-kill single-fork variant: at the fork "
                      "point the tail task is killed and relaunched fresh "
                      "on a new host [Wang et al.]")
class ForkRelaunch(SingleFork):
    """Kill-and-relaunch variant: same fork clock, but the laggard is
    killed (``rerun``) instead of raced against a copy — cheaper in
    machine-time, costlier in forfeited progress, so the tail-adaptive
    objective forks it later."""

    name = "fork-relaunch"
    kill = True


def _done_original_times(view: TelemetryView) -> np.ndarray:
    """Execution times (start -> finish) of completed original tasks."""
    tt = view.tasks
    d = (tt.state == DONE) & ~tt.is_copy & (tt.finish_s > 0)
    return np.maximum((tt.finish_s[d] - tt.start_s[d]), 1e-3)


def _on_pod(view: TelemetryView) -> bool:
    """Is this the pod substrate's view?  (The runtime publishes its raw
    step times under ``extra``; the simulator never does.)"""
    return "step_times" in view.extra


# ------------------- redundancy-level policies (Aktas) ---------------------

@register("redundancy-fixed", substrates=("sim", "pod"),
          description="launch every task with r replicas up front "
                      "[Aktas & Soljanin]")
class FixedRedundancy(Policy):
    """Upfront redundancy level ``r``: every submitted task starts with
    ``r - 1`` clones (first result wins).  A fractional ``r`` is
    realized in expectation via the substrate's own RNG stream, which
    keeps sweep cells pure functions of their spec.

    On the pod substrate (no submit events) the level maps to backup
    shards: the ``round(r) - 1`` slowest online hosts of the last step
    get their shard backed up each step.
    """

    name = "redundancy-fixed"

    def __init__(self, r: float = 2.0):
        self.r = float(r)

    def _level(self, view: TelemetryView) -> float:
        return self.r

    def decide(self, view: TelemetryView) -> list[Action]:
        if view.event == EVENT_SUBMIT and len(view.new_tasks):
            return self._upfront_clones(view)
        if view.event == EVENT_INTERVAL and _on_pod(view):
            return self._pod_backups(view)
        return []

    def _upfront_clones(self, view: TelemetryView) -> list[Action]:
        r = max(self._level(view), 1.0)
        new = view.new_tasks
        extra = np.full(len(new), int(r) - 1, np.int64)
        fray = r - int(r)
        if fray > 0.0:
            extra = extra + (view.rng.random(len(new)) < fray)
        return [Action("clone", int(i), n_clones=int(e))
                for i, e in zip(new, extra) if e > 0]

    def _pod_backups(self, view: TelemetryView) -> list[Action]:
        n_back = int(round(max(self._level(view), 1.0))) - 1
        if n_back <= 0:
            return []
        last = np.asarray(view.extra["step_times"][-1], np.float64)
        online = view.hosts.online()
        slowest = [int(h) for h in np.argsort(-last) if online[h]]
        # task id == host id on the pod; the runtime translates the
        # speculate into a backup shard and picks the backup host
        return [Action("speculate", h) for h in slowest[:n_back]]


@register("redundancy-adaptive", substrates=("sim", "pod"),
          description="load-adaptive redundancy: r scales from r_max "
                      "toward 1 as task-attributable utilization rises "
                      "[Aktas & Soljanin]")
class AdaptiveRedundancy(FixedRedundancy):
    """Redundancy that backs off under load — Aktas & Soljanin's point
    that the optimal ``r`` flips with load, on the same
    task-attributable-utilization signal as START's regime-adaptive
    guard: ``r_max`` at an idle cluster, linearly down to 1 as observed
    CPU utilization (minus the reserved floor) reaches ``util_knee``."""

    name = "redundancy-adaptive"

    def __init__(self, r_max: float = 3.0, util_knee: float = 0.7):
        super().__init__(r=r_max)
        self.util_knee = util_knee

    def _level(self, view: TelemetryView) -> float:
        raw = float(np.clip(view.hosts.util[:, 0].mean(), 0.0, 1.0))
        reserved = float(getattr(view.config, "reserved_utilization", 0.0))
        u = float(np.clip(raw - reserved, 0.0, 1.0))
        return 1.0 + (self.r - 1.0) * max(0.0, 1.0 - u / self.util_knee)
