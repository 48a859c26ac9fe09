"""Straggler policies applied to distributed training pods (beyond-paper),
a copy of the JAX package's ``repro.distributed.straggler_runtime``.

In synchronous SPMD training every collective waits for the slowest host,
so one straggler host taxes the whole step. Prior systems detect this
reactively (timeout, then restart); START's insight — predict the latency
*tail* from host+work features over a Pareto model — transfers directly.

This module is the pod-side *substrate* of the unified policy API
(``repro_torch.policy``): it accumulates per-step telemetry, publishes the
same :class:`~repro_torch.policy.telemetry.TelemetryView` the cloud
simulator publishes, and executes the unified
:class:`~repro_torch.policy.Action` vocabulary.  Task-level verbs are
translated to pod semantics:

  * SPECULATE/CLONE -> backup shards: a healthy host also computes the
    predicted straggler's microbatch; at the gradient reduce a
    first-done-wins mask keeps exactly one contribution (gradient-exact).
  * RERUN/EVICT -> evict-and-remesh: chronic stragglers are dropped at a
    step boundary.
  * DELAY has no pod analogue and is ignored.

Because both substrates speak one view/action vocabulary, cloud baselines
port over: ``StragglerRuntime(cfg, policy=IGRUSD())`` runs the paper's
IGRU-SD baseline on a training pod (see ``pretrain_igru_pod``).  The pod
maps each host's current *horizon-step window* to one synthetic "task":
all hosts complete the same shard work per step (synchronous SPMD), so
progress advances uniformly while per-host elapsed time carries the
slowdown — exactly the progress/elapsed/expected geometry the cloud
policies reason about.

The default policy, :class:`StartPodPolicy`, is START's Algorithm 1
mapped to pod semantics: E_S (Eq. 4) from the fitted step-time tail
sizes the speculative backup set, chronic stragglers are evicted.

The runtime's bookkeeping is numpy on the host.  ``RuntimeConfig.device``
(default ``"cuda"``) is where its policies compute: the tail fit, the
Encoder-LSTM of ``start-pod-online`` and the in-process service of
``start-pod-service``.  The four ``start-pod*`` names register when this
module is imported.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import features, pareto
from repro_torch.core.predictor import resolve_device
from repro_torch.policy import (Action, ActionKind, EVENT_INTERVAL, Policy,
                                TelemetryView, host_action, register)
from repro_torch.policy.telemetry import (CANCELLED, RUNNING, HostTelemetry,
                                          JobTelemetry, TaskTelemetry,
                                          readonly)

#: legacy constructor name: a host-level Action (kind, host, backup=...)
HostAction = host_action


@dataclasses.dataclass
class RuntimeConfig:
    n_hosts: int
    horizon: int = 5
    k: float = 1.5
    evict_after: int = 3        # consecutive straggler intervals -> evict
    ma_decay: float = 0.8
    seed: int = 0

    #: the pod's normalized clock: fleet-median step time == 1.0 "second"
    #: of work at unit speed, so policy-side expected-time math holds
    host_ips_mean: float = 1.0
    max_tasks: int = 1
    #: where the policies compute (tail fit, networks, service)
    device: str = "cuda"


def _fit(step_times: list, horizon: int, device) -> tuple:
    """MLE Pareto fit over the recent per-host step times, as two
    float32 tensors on ``device``."""
    recent = np.concatenate(step_times[-horizon:])
    recent = recent[recent > 0]
    return pareto.fit_pareto(torch.as_tensor(
        np.asarray(recent, np.float32), device=resolve_device(device)))


def fitted_tail(step_times: list, horizon: int,
                device: str = "cuda") -> tuple[float, float]:
    """MLE Pareto fit over the recent per-host step times."""
    a, b = torch.stack(_fit(step_times, horizon, device)).tolist()
    return a, b


def expected_stragglers(step_times: list, n_hosts: int, k: float,
                        horizon: int, device: str = "cuda") -> float:
    """E_S (Eq. 4) from the fitted step-time tail."""
    if not step_times:
        return 0.0
    a, b = _fit(step_times, horizon, device)
    return float(pareto.expected_stragglers(float(n_hosts), a, b, k))


@register("start-pod", substrates=("pod",),
          description="START's Algorithm 1 on pod semantics: Pareto-tail "
                      "E_S sizes the backup-shard set, chronic stragglers "
                      "are evicted")
class StartPodPolicy(Policy):
    """Algorithm 1 per training interval.

    Chronic stragglers are evicted unconditionally (a host that is slow
    ``evict_after`` intervals in a row delays every step regardless of
    the tail estimate); E_S sizes the *speculative* backup set, exactly
    as floor(E_S) sizes the mitigation set in the paper.  All state it
    reads comes from the runtime's TelemetryView: raw step times under
    ``view.extra``, the straggler moving average as
    ``view.straggler_ma``, eviction status as host downtime.
    """

    name = "start-pod"

    def _expected_stragglers(self, view: TelemetryView) -> float:
        """E_S for the current interval — the prediction seam.  The base
        policy fits the MLE Pareto tail over recent step times;
        subclasses swap in the Encoder-LSTM (online-trained or served)
        without touching the trigger/translation logic."""
        cfg = view.config
        return expected_stragglers(view.extra["step_times"], cfg.n_hosts,
                                   cfg.k, cfg.horizon, cfg.device)

    def decide(self, view: TelemetryView) -> list[Action]:
        cfg = view.config
        step_times = view.extra.get("step_times", ())
        if not step_times:
            return []
        online = view.hosts.online()
        chronic = view.extra["chronic"]
        actions: list[Action] = []
        evicting: set[int] = set()
        for h in np.nonzero(chronic >= cfg.evict_after)[0]:
            h = int(h)
            if online[h]:
                actions.append(host_action(ActionKind.EVICT, h))
                evicting.add(h)
        e_s = self._expected_stragglers(view)
        n_mit = int(math.floor(e_s))
        if n_mit <= 0:
            return actions
        last = step_times[-1]
        order = np.argsort(-last)  # slowest first
        healthy = [int(h) for h in np.argsort(view.straggler_ma)
                   if online[h] and int(h) not in evicting]
        hi = 0
        acted = {a.host for a in actions}
        for h in order[:n_mit]:
            h = int(h)
            if not online[h] or h in evicting or h in acted:
                continue
            while hi < len(healthy) and healthy[hi] == h:
                hi += 1
            backup = healthy[hi % len(healthy)] if healthy else h
            hi += 1
            actions.append(host_action(ActionKind.BACKUP_SHARD, h,
                                       backup=backup))
        return actions


@register("start-eager-pod", substrates=("pod",),
          description="START's per-task predicted-straggler trigger on "
                      "pod semantics: hosts in the predicted set get "
                      "backup shards after a hysteresis streak, chronic "
                      "stragglers are evicted")
class StartEagerPodPolicy(StartPodPolicy):
    """The per-task eager trigger translated to pod semantics.

    :class:`StartPodPolicy` only launches backups once the fitted tail's
    floor(E_S) reaches 1 — the pod analogue of the simulator's late
    completion-milestone trigger.  Here a host enters the predicted
    straggler set when it either ranks among the top-floor(E_S) slowest
    of the last step or exceeds the per-interval straggler threshold
    (relative step time > k, the same signal the runtime's chronic
    counter uses); it gets a backup shard after ``hysteresis``
    consecutive in-set steps and then rests ``cooldown`` steps, so a
    host flapping around the threshold cannot spam backups.  Chronic
    stragglers are evicted exactly as in the base policy.  Per-host
    streak state is dropped on ``forget_tasks`` (the runtime rebinds the
    per-host task ids at every horizon-window boundary).
    """

    name = "start-eager-pod"

    def __init__(self, hysteresis: int = 2, cooldown: int = 5):
        self.hysteresis = hysteresis
        self.cooldown = cooldown
        self._tick = 0
        self._streak: dict[int, int] = {}
        self._cool: dict[int, int] = {}

    def forget_tasks(self, task_ids) -> None:
        for t in task_ids:
            t = int(t)
            self._streak.pop(t, None)
            self._cool.pop(t, None)

    def decide(self, view: TelemetryView) -> list[Action]:
        cfg = view.config
        step_times = view.extra.get("step_times", ())
        if not step_times:
            return []
        self._tick += 1
        online = view.hosts.online()
        chronic = view.extra["chronic"]
        actions: list[Action] = []
        unavailable: set[int] = set()
        for h in np.nonzero(chronic >= cfg.evict_after)[0]:
            h = int(h)
            if online[h]:
                actions.append(host_action(ActionKind.EVICT, h))
                unavailable.add(h)
        last = np.asarray(step_times[-1], float)
        med = np.median(last[last > 0]) if (last > 0).any() else 1.0
        rel = last / max(med, 1e-9)
        e_s = self._expected_stragglers(view)
        n_pred = int(math.floor(e_s)) if math.isfinite(e_s) else 0
        n_pred = min(max(n_pred, 0), cfg.n_hosts)
        members = {int(h) for h in np.argsort(-rel)[:n_pred]}
        members |= {int(h) for h in np.nonzero(rel > cfg.k)[0]}
        for h in sorted(members, key=lambda i: (-rel[i], i)):
            if not online[h] or h in unavailable:
                continue
            streak = self._streak.get(h, 0) + 1
            self._streak[h] = streak
            if streak < self.hysteresis \
                    or self._cool.get(h, 0) > self._tick:
                continue
            # backup host left to the runtime's lowest-MA pick
            actions.append(host_action(ActionKind.BACKUP_SHARD, h))
            self._cool[h] = self._tick + self.cooldown
            self._streak[h] = 0
        for h in [h for h in self._streak if h not in members]:
            del self._streak[h]
        return actions


@register("start-pod-online", substrates=("pod",),
          description="start-pod with the Encoder-LSTM trained online "
                      "on completed step windows: E_S comes from the "
                      "network once enough windows have been fit, the "
                      "MLE tail until then")
class OnlineStartPodPolicy(StartPodPolicy):
    """START's full pipeline on the pod, trained online.

    :class:`StartPodPolicy` only ever runs the paper's *fallback* — the
    MLE Pareto fit over raw step times (no Encoder-LSTM).  This policy
    closes the gap: every completed horizon-step window becomes one
    training pair through the predictor's standard ``fit()`` path (the
    pod is one ``n_hosts``-task job; targets are the MLE fit of the
    window's per-host elapsed times, the same construction the
    simulator's offline pretrainer uses), and once ``min_windows`` pairs
    have been absorbed, E_S comes from the network's (alpha, beta) head
    instead of the raw-tail fit.  Everything downstream — backup-set
    sizing, eviction, hysteresis in the eager subclass — is inherited
    unchanged through the ``_expected_stragglers`` seam.

    The predictor lives on the runtime's ``RuntimeConfig.device``.
    """

    name = "start-pod-online"

    def __init__(self, epochs_per_update: int = 8, lr: float = 1e-3,
                 min_windows: int = 2, seed: int = 0):
        self.epochs_per_update = epochs_per_update
        self.lr = lr
        self.min_windows = min_windows
        self.seed = seed
        self.predictor = None
        self._seen = 0              # completed windows already trained on
        self._xs: list[np.ndarray] = []
        self._ys: list[list[float]] = []
        self.trained_pairs = 0

    # ---------------- feature construction (pod -> paper matrices) ------

    @staticmethod
    def _m_h(util: np.ndarray) -> np.ndarray:
        """(n, 4) pod utilization -> (n, HOST_FEATURES) M_H.  The pod
        has no price/power/capacity telemetry: capacities, cost and
        power normalize to ones (homogeneous fleet), n_tasks is one
        shard per host."""
        n = util.shape[0]
        ones = np.ones(n, np.float32)
        return features.host_matrix_np(
            np.clip(util, 0.0, 2.0), np.ones((n, 4), np.float32),
            ones, ones, np.ones(n, np.int64))

    @staticmethod
    def _m_t(util: np.ndarray) -> np.ndarray:
        """(n, 4) pod utilization -> (n, TASK_FEATURES) M_T: each host's
        shard "requires" what the host currently burns; previous host is
        the host itself (shards are pinned)."""
        n = util.shape[0]
        return features.task_matrix_batch_np(
            np.clip(util, 0.0, 1.0), np.arange(n),
            np.zeros(n, np.int64), np.arange(n), 1, n, n)[0]

    def _host_window(self, util_history: list,
                     t_end: int, horizon: int) -> np.ndarray:
        """Trailing ``horizon`` M_H rows ending at step ``t_end``
        (1-based), left-clamped to the first observation — the same
        windowing as ``NoOpRecorder.dataset``."""
        idx = np.maximum(np.arange(t_end - horizon, t_end), 0)
        idx = np.minimum(idx, len(util_history) - 1)
        return np.stack([self._m_h(np.asarray(util_history[i],
                                              np.float32))
                         for i in idx])

    # ---------------- online training -----------------------------------

    def _ensure_predictor(self, cfg) -> None:
        if self.predictor is None:
            from repro_torch.core.predictor import StragglerPredictor
            self.predictor = StragglerPredictor(
                n_hosts=cfg.n_hosts, max_tasks=cfg.n_hosts, k=cfg.k,
                horizon=cfg.horizon, seed=self.seed, beta_scale=1.0,
                device=cfg.device)

    def _maybe_train(self, view: TelemetryView) -> None:
        cfg = view.config
        new = view.completed_jobs[self._seen:]
        if not new:
            return
        self._ensure_predictor(cfg)
        h = cfg.horizon
        for rec in new:
            t_end = min(int(rec["t"]), len(view.util_history))
            seq = self._host_window(view.util_history, t_end, h)
            m_t = self._m_t(np.asarray(
                view.util_history[t_end - 1], np.float32))
            x = np.concatenate(
                [seq.reshape(h, -1),
                 np.broadcast_to(m_t.reshape(-1),
                                 (h, m_t.size))], axis=1)
            self._xs.append(x.astype(np.float32))
            times = np.asarray(rec["times"], np.float32)
            a, b = pareto.fit_pareto_np(times[times > 0].reshape(1, -1))
            self._ys.append([float(a[0]), float(b[0])])
        self._seen = len(view.completed_jobs)
        xs = np.stack(self._xs, axis=1)              # (h, pairs, dim)
        ys = np.array(self._ys, np.float32)
        self.predictor.fit(xs, ys, epochs=self.epochs_per_update,
                           lr=self.lr)
        self.trained_pairs = len(self._xs)

    # ---------------- the prediction seam --------------------------------

    def _expected_stragglers(self, view: TelemetryView) -> float:
        self._maybe_train(view)
        cfg = view.config
        if self.trained_pairs < self.min_windows:
            return super()._expected_stragglers(view)
        n = cfg.n_hosts
        t_end = len(view.util_history)
        seq = self._host_window(view.util_history, t_end, cfg.horizon)
        m_t = self._m_t(np.asarray(view.util_history[-1], np.float32))
        pred = self.predictor.predict_features(
            seq, m_t[None], np.array([float(n)], np.float32))
        e_s = float(np.asarray(pred.e_s)[0])
        if not math.isfinite(e_s):
            return super()._expected_stragglers(view)
        return float(np.clip(e_s, 0.0, n))


@register("start-pod-service", substrates=("pod",),
          description="pod substrate as a prediction-service tenant: "
                      "per-step snapshots go to a repro_torch.service "
                      "daemon (in-process by default), whose wire actions "
                      "are translated back to backup-shard/evict")
class ServiceBackedPodPolicy(Policy):
    """The pod substrate as a client of ``repro_torch.service``.

    Each step the policy serializes the runtime's telemetry into one
    wire snapshot (M_H from host utilization, one ``n_hosts``-task job
    for the current horizon window, completed windows as ``done``
    records feeding the service's continuous retraining) and answers
    with the service's mitigation actions — speculate becomes a backup
    shard, rerun an eviction, via the runtime's standard translation.

    With no explicit ``client`` the policy spins up a private in-process
    :class:`~repro_torch.service.core.PredictionService` on the
    runtime's ``RuntimeConfig.device`` on first use (the
    zero-infrastructure path); hand it a
    :class:`~repro_torch.service.daemon.ServiceClient` to share a real
    daemon (of either package: the wire is one) across pods — the tenant
    name is ``self.tenant``.  A shed or degraded answer (``ok: false``)
    fails open: no actions that step.
    """

    name = "start-pod-service"

    def __init__(self, client=None, tenant: str = "pod0",
                 trigger: str = "per_task", hysteresis: int = 2,
                 cooldown: int = 5):
        self.client = client
        self.tenant = tenant
        self.trigger = trigger
        self.hysteresis = hysteresis
        self.cooldown = cooldown
        self._admitted = False
        self._seq = 0
        self._sent_done = 0
        self.last_response: dict | None = None

    def _ensure_client(self, cfg) -> None:
        from repro_torch.service import (LocalClient, PredictionService,
                                         Profile, ServiceConfig)
        profile = Profile(
            n_hosts=cfg.n_hosts, max_tasks=cfg.n_hosts,
            horizon=cfg.horizon, k=cfg.k, trigger=self.trigger,
            hysteresis=self.hysteresis, cooldown=self.cooldown)
        if self.client is None:
            svc = PredictionService(ServiceConfig(profile=profile,
                                                  device=cfg.device))
            self.client = LocalClient(svc, self.tenant)
        if not self._admitted:
            resp = self.client.hello(profile)
            if not resp.get("ok"):
                raise RuntimeError(f"service admission failed: {resp}")
            self._admitted = True

    def decide(self, view: TelemetryView) -> list[Action]:
        from repro_torch.policy import wire

        cfg = view.config
        if not view.extra.get("step_times"):
            return []
        self._ensure_client(cfg)
        n = cfg.n_hosts
        util = np.asarray(view.hosts.util, np.float32)
        m_h = OnlineStartPodPolicy._m_h(util)
        m_t = OnlineStartPodPolicy._m_t(util)
        online = view.hosts.online()
        window = len(view.completed_jobs)     # current window's job id
        tasks = [(h, h, h) for h in range(n) if online[h]]
        done = [{"id": int(rec["job"]),
                 "times": [float(x) for x in rec["times"]
                           if float(x) > 0]}
                for rec in view.completed_jobs[self._sent_done:]]
        snap = wire.snapshot_to_wire(
            self.tenant, self._seq, m_h,
            jobs=[wire.job_to_wire(window, n, m_t, deadline=True,
                                   tasks=tasks)],
            done=done)
        self._seq += 1
        resp = self.client.snapshot(snap)
        self.last_response = resp
        if not resp.get("ok"):
            return []                 # shed/degraded: fail open, no acts
        self._sent_done = len(view.completed_jobs)
        actions: list[Action] = []
        for job in resp.get("jobs", ()):
            for a in job.get("actions", ()):
                actions.append(wire.action_from_wire(a))
        return actions

    def forget_tasks(self, task_ids) -> None:
        # window boundary: the service's per-task trigger state is
        # scoped to the service-side controller; job ids advance per
        # window so no client-side state needs dropping
        pass


class StragglerRuntime:
    """Per-step telemetry in, mitigation actions out.

    Runtime-agnostic: it consumes step-time observations (real timers on
    hardware; simulated Pareto latencies in tests/examples), publishes a
    :class:`TelemetryView`, and executes whatever registered pod policy
    it was built with — :class:`StartPodPolicy` by default.  Raises when
    ``cfg.device`` names CUDA and there is no card.
    """

    def __init__(self, cfg: RuntimeConfig, policy: Policy | None = None):
        resolve_device(cfg.device)
        self.cfg = cfg
        self.policy = policy if policy is not None else StartPodPolicy()
        self.t = 0                            # observed steps
        self.step_times: list[np.ndarray] = []
        self.chronic = np.zeros(cfg.n_hosts, np.int64)
        self.ma = np.zeros(cfg.n_hosts)
        self.evicted: set[int] = set()
        self.util_history: list[np.ndarray] = []   # (n_hosts, 4) per step
        self.completed_windows: list[dict] = []
        self._util = np.zeros((cfg.n_hosts, 4))
        self._win_elapsed = np.zeros(cfg.n_hosts)  # normalized seconds
        self._win_steps = 0
        # executed-action counters + the per-step synchronization barrier
        # (max step time over surviving hosts, with a backed-up shard
        # finishing at its backup host's pace) — the comparison surface
        # for running several policies over one trace (pod baseline grid)
        self.action_counts: dict[str, int] = {"backup_shard": 0,
                                              "evict": 0}
        self.sync_barrier_s: list[float] = []
        self._pending_backups: dict[int, int] = {}  # host -> backup

    # ------------------------------ telemetry ------------------------------

    def observe_step(self, step_times_s: np.ndarray,
                     mem_util: np.ndarray | None = None,
                     net_util: np.ndarray | None = None) -> None:
        cfg = self.cfg
        n = cfg.n_hosts
        st = np.asarray(step_times_s, float)
        self.step_times.append(st)
        # barrier accounting: backups issued at the previous decide()
        # apply to THIS step — a backed-up shard is done when either the
        # owner or its backup host finishes.  Re-validate against the
        # eviction set: a backup host chosen early in a decide() round
        # may have been evicted by a later action in the same round
        eff = st.copy()
        for h, b in self._pending_backups.items():
            if b not in self.evicted:
                eff[h] = min(eff[h], st[b])
        self._pending_backups = {}
        alive = np.ones(n, bool)
        if self.evicted:
            alive[list(self.evicted)] = False
        self.sync_barrier_s.append(
            float(eff[alive].max()) if alive.any() else 0.0)
        med = np.median(st[st > 0]) if (st > 0).any() else 1.0
        rel = st / max(med, 1e-9)
        mem = mem_util if mem_util is not None else np.zeros(n)
        net = net_util if net_util is not None else np.zeros(n)
        self._util = np.stack([np.clip(rel - 1, 0, 2), mem, net,
                               np.zeros(n)], 1)
        self.util_history.append(self._util)
        self.ma = cfg.ma_decay * self.ma + (1 - cfg.ma_decay) \
            * (rel > cfg.k)
        self.chronic = np.where(rel > cfg.k, self.chronic + 1, 0)
        self.t += 1
        # window clock: each step advances the normalized clock by 1.0;
        # a host's window-elapsed accrues its *relative* slowdown
        self._win_elapsed = self._win_elapsed + rel
        self._win_steps += 1
        if self._win_steps >= cfg.horizon:
            self.completed_windows.append(dict(
                job=len(self.completed_windows), t=self.t,
                times=self._win_elapsed.copy(),
                straggler=self._win_elapsed > cfg.k * cfg.horizon,
                hosts=np.arange(n), deadline=True))
            self._win_elapsed = np.zeros(n)
            self._win_steps = 0
            # the per-host task ids now denote a NEW window: per-task
            # policy state (histories, once-only flags) must not carry
            # over, or a chronic straggler gets mitigated once per run
            self.policy.forget_tasks(range(n))
        self.policy.observe(self.snapshot())

    # ------------------------------- the view ------------------------------

    def snapshot(self) -> TelemetryView:
        """Publish pod state in the unified telemetry geometry.

        One synthetic task per host — host h's current horizon-step
        window: ``work``/``progress`` advance one normalized unit per
        step for every host (synchronous SPMD: everyone finishes every
        step), while ``start_s`` is back-dated so ``now_s - start_s``
        equals the host's *relative* elapsed time — slow hosts age
        faster than they progress, which is precisely the straggler
        signal task-level policies key on.
        """
        cfg = self.cfg
        n = cfg.n_hosts
        now = float(self.t)
        evicted_arr = np.zeros(n, np.int64)
        if self.evicted:
            evicted_arr[list(self.evicted)] = np.iinfo(np.int64).max // 2
        w = float(self._win_steps)
        state = np.where(evicted_arr > 0, CANCELLED, RUNNING) \
            .astype(np.int8)
        tasks = TaskTelemetry(
            n=n,
            job_id=readonly(np.zeros(n, np.int64)),
            state=readonly(state),
            host=readonly(np.arange(n, dtype=np.int64)),
            work=readonly(np.full(n, float(cfg.horizon))),
            progress=readonly(np.full(n, w)),
            submit_s=readonly(now - self._win_elapsed),
            start_s=readonly(now - self._win_elapsed),
            finish_s=readonly(np.full(n, -1.0)),
            deadline_s=readonly(np.full(n, 2.0 * cfg.horizon)),
            is_deadline=readonly(np.ones(n, bool)),
            sla_weight=readonly(np.ones(n)),
            restarts=readonly(self.chronic),
            is_copy=readonly(np.zeros(n, bool)),
            orig=readonly(np.full(n, -1, np.int64)),
            delayed_until=readonly(np.zeros(n, np.int64)),
            prev_host=readonly(np.full(n, -1, np.int64)),
            req=readonly(np.zeros((n, 4))))
        ones = np.ones(n)
        hosts = HostTelemetry(
            util=readonly(self._util), speed=readonly(ones),
            cap=readonly(np.ones((n, 4))), cost=readonly(ones),
            power_max=readonly(ones), power_min=readonly(ones),
            n_tasks=readonly(np.ones(n, np.int64)),
            downtime=readonly(evicted_arr), ips=readonly(ones))
        jobs = JobTelemetry(
            start=readonly(np.zeros(1, np.int64)),
            count=readonly(np.array([n], np.int64)),
            open_count=readonly(np.array([int((state == RUNNING).sum())],
                                         np.int64)),
            done=readonly(np.zeros(1, bool)),
            deadline=readonly(np.ones(1, bool)),
            _state=state)
        return TelemetryView(
            event=EVENT_INTERVAL, t=self.t, now_s=now,
            interval_seconds=1.0, config=cfg, tasks=tasks, hosts=hosts,
            jobs=jobs, new_tasks=np.zeros(0, np.int64),
            straggler_ma=readonly(self.ma),
            completed_jobs=self.completed_windows,
            util_history=self.util_history,
            extra={"step_times": self.step_times,
                   "chronic": self.chronic})

    # ------------------------------ decision -------------------------------

    def fitted_tail(self) -> tuple[float, float]:
        return fitted_tail(self.step_times, self.cfg.horizon,
                           self.cfg.device)

    def expected_stragglers(self) -> float:
        return expected_stragglers(self.step_times, self.cfg.n_hosts,
                                   self.cfg.k, self.cfg.horizon,
                                   self.cfg.device)

    def _pick_backup(self, host: int) -> int:
        order = [int(h) for h in np.argsort(self.ma)
                 if int(h) != host and int(h) not in self.evicted]
        return order[0] if order else host

    def decide(self) -> list[Action]:
        """Run the bound policy and execute/translate its actions.

        Host-level actions pass through; task-level actions are mapped
        onto their hosts (speculate/clone -> backup shard, rerun ->
        evict, delay -> dropped).  At most one action per host per step;
        evictions update the runtime's membership bookkeeping.
        """
        if not self.step_times:
            return []
        view = self.snapshot()
        out: list[Action] = []
        acted: set[int] = set()
        for a in self.policy.decide(view):
            kind = ActionKind(a.kind)
            backup = a.backup
            if kind in (ActionKind.BACKUP_SHARD, ActionKind.EVICT):
                h = int(a.host)
            elif kind in (ActionKind.SPECULATE, ActionKind.CLONE):
                h, kind = int(view.tasks.host[a.task]), \
                    ActionKind.BACKUP_SHARD
            elif kind is ActionKind.RERUN:
                h, kind = int(view.tasks.host[a.task]), ActionKind.EVICT
            else:                      # DELAY: no pod analogue
                continue
            if h in self.evicted or h in acted:
                continue
            acted.add(h)
            if kind is ActionKind.EVICT:
                self.evicted.add(h)
                self.action_counts["evict"] += 1
                out.append(host_action(ActionKind.EVICT, h))
            else:
                if backup is None or backup == h \
                        or backup in self.evicted:
                    backup = self._pick_backup(h)
                self.action_counts["backup_shard"] += 1
                self._pending_backups[h] = backup
                out.append(host_action(ActionKind.BACKUP_SHARD, h,
                                       backup=backup))
        return out

    def summary(self) -> dict:
        """Comparison metrics for one policy over one step trace: how
        often it acted, whom it dropped, and the synchronization barrier
        the pod actually paid (per-step max over surviving hosts, after
        crediting backup shards issued at the previous step's decide)."""
        bar = np.asarray(self.sync_barrier_s, float)
        return {
            "policy": getattr(self.policy, "name", "?"),
            "steps": self.t,
            "backup_shards": self.action_counts["backup_shard"],
            "evictions": self.action_counts["evict"],
            "evicted_hosts": sorted(self.evicted),
            "mean_sync_barrier_s": float(bar.mean()) if bar.size else 0.0,
            "p95_sync_barrier_s": (float(np.percentile(bar, 95))
                                   if bar.size else 0.0),
        }


def pretrain_igru_pod(tech, runtime: StragglerRuntime,
                      epochs: int = 200) -> None:
    """Fit an IGRU-SD policy's GRU on the pod's completed step windows.

    Reuses the cloud pretrainer's idealized-history reconstruction: each
    (host, window) pair is a task that took ``window_elapsed`` normalized
    seconds against ``horizon`` expected — the same
    completion/expected-ratio regression, sourced from pod telemetry.
    """
    from repro_torch.sim.techniques.baselines import \
        synthetic_progress_history

    horizon = float(runtime.cfg.horizon)
    xs, ys = [], []
    for rec in runtime.completed_windows:
        for total in rec["times"]:
            total = float(total)
            xs.append(synthetic_progress_history(
                horizon, total, horizon, 1.0))
            ys.append(total / horizon)
    if xs:
        tech.train(np.stack(xs, axis=1).astype(np.float32),
                   np.array(ys, np.float32), epochs=epochs)


def backup_mask(n_hosts: int, actions: list[Action],
                finished_in_time: np.ndarray) -> np.ndarray:
    """First-done-wins combine weights for the gradient reduce.

    finished_in_time[h] — did host h's primary shard meet the deadline.
    Returns (n_hosts,) weights: owner 1.0 if on time, else its backup 1.0;
    exactly one contribution per shard so the gradient stays exact.
    """
    w = np.asarray(finished_in_time, float).copy()
    for a in actions:
        if ActionKind(a.kind) is ActionKind.BACKUP_SHARD \
                and a.backup is not None:
            if not finished_in_time[a.host]:
                w[a.host] = 0.0  # backup host contributes this shard
    return w
