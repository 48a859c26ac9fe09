"""START policy (paper §3 end-to-end) on the unified policy API, over the
port's PyTorch controller (a copy of the JAX package's
``repro.sim.techniques.start_tech``).

Per interval: builds M_H from the host telemetry view, per-active-job M_T
from task requirements/placements, runs the Encoder-LSTM -> Pareto
pipeline and emits Algorithm-1 mitigation actions (speculate for deadline
jobs, rerun otherwise) once a job is down to its floor(E_S) predicted
stragglers.

``pretrain`` reproduces §4.4: run a random-scheduler simulation, collect
per-job (feature sequence, MLE-fitted (alpha, beta)) pairs, train with
MSE.  The class is :class:`repro_torch.policy.Pretrainable`, so runners
pretrain it through the registry entry rather than by name.  The
controller's model lives on ``device`` (default ``"cuda"``; pass
``device="cpu"`` to run on the CPU), where training and every decision
run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import features, pareto
from repro_torch.core.start import STARTController
from repro_torch.policy import (Action, EVENT_INTERVAL, Policy,
                                PretrainContext, TelemetryView, register)
from repro_torch.sim.config import SimConfig
from repro_torch.sim.engine import Simulation
from repro_torch.sim.scheduler import RandomScheduler


def _host_matrix(view: TelemetryView) -> np.ndarray:
    h = view.hosts
    return features.host_matrix_np(
        util=np.clip(h.util, 0, 2), cap=h.cap, cost=h.cost,
        power_max=h.power_max, n_tasks=h.n_tasks)


def _prev_host_feature(view: TelemetryView, tids: np.ndarray) -> np.ndarray:
    """The paper's M_T 'host of the previous interval' column: the current
    placement while a task holds one, else the host it ran on before its
    last restart/bounce (``prev_host``) — NOT -1, which read as 'never
    placed' for every restarted task."""
    tt = view.tasks
    host = tt.host[tids]
    return np.where(host >= 0, host, tt.prev_host[tids])


def _task_matrices(view: TelemetryView, jobs: np.ndarray) -> np.ndarray:
    """(len(jobs), max_tasks, TASK_FEATURES) float32 task matrices for a
    set of jobs, assembled in one CSR-vectorized numpy pass (no per-job
    list comprehensions, no per-job XLA dispatch)."""
    starts = view.jobs.start[jobs]
    counts = view.jobs.count[jobs]
    rows = np.repeat(np.arange(len(jobs)), counts)
    offs = (np.arange(int(counts.sum()))
            - np.repeat(np.cumsum(counts) - counts, counts))
    tids = np.repeat(starts, counts) + offs
    return features.task_matrix_batch_np(
        view.tasks.req[tids], _prev_host_feature(view, tids),
        rows, offs, len(jobs), view.config.n_hosts,
        view.config.max_tasks)


@register("start", epochs_knob="pretrain_epochs",
          description="the paper's Encoder-LSTM -> Pareto predictor with "
                      "Algorithm-1 mitigation and a regime-adaptive "
                      "expected-benefit guard")
class START(Policy):
    """Prediction + mitigation with a utilization-adaptive benefit guard.

    A re-execution starts from zero progress, so it only helps when
    ``work/eff(target) < remaining/eff(source)`` with a safety *margin*
    for the load the migration itself adds.  The paper's CloudSim runs at
    ~7% utilization where nearly any migration pays off; at scaled-down
    load a fixed 25% margin suppressed nearly every action in the
    heavy-tail/overload regimes (START tied ``none`` there).  The margin
    is therefore a policy parameter scaling with *task-attributable*
    cluster utilization (observed CPU utilization minus the configured
    reserved floor): ``margin_lo`` at an idle cluster — negative, i.e.
    optimistic, since a losing speculative copy costs only cheap idle
    capacity while hedging against future contention/faults — rising to
    ``margin_hi`` at saturation.  RERUN kills the original task, so it
    never goes optimistic: its margin is floored at
    ``rerun_margin_floor``.  Pass ``margin=`` to pin a fixed margin for
    both kinds (0.25 reproduces the legacy fixed 25% guard bitwise).
    ``device`` places a controller the policy builds itself.

    The paper's adaptive straggler parameter (§4.3: "we dynamically
    change the k value ... with the initial value as 1.5") follows the
    same utilization signal: ``k_lo`` when idle (flag more of the tail,
    mitigate early) up to ``k_hi`` at saturation.
    """

    name = "start"
    # START only acts at interval decision points (decide() filters on
    # EVENT_INTERVAL) — let the engine skip the submit-time view+call
    submit_hook = False

    def __init__(self, controller: STARTController | None = None,
                 seed: int = 0, margin: float | None = None,
                 margin_lo: float = -0.50, margin_hi: float = 0.60,
                 rerun_margin_floor: float = 0.10,
                 k_lo: float = 1.0, k_hi: float = 1.5,
                 use_fused_step: bool = True,
                 device: str | torch.device = "cuda"):
        self._controller = controller
        self.device = device
        self.controller = controller
        self.use_fused_step = use_fused_step   # forwards to the controller
        self.seed = seed
        self.margin = margin
        self.margin_lo = margin_lo
        self.margin_hi = margin_hi
        self.rerun_margin_floor = rerun_margin_floor
        self.k_lo = k_lo
        self.k_hi = k_hi
        self._util = 0.0
        self._last_es_sum: float | None = None

    @property
    def use_fused_step(self) -> bool:
        """Whether the per-interval pipeline runs as the fused device
        program.  Forwards to the bound controller so the policy flag
        can never disagree with actual behavior — setting it at any
        point (constructor kwarg, sweep ``technique_kwargs``, or plain
        attribute assignment on a pretrained instance) takes effect."""
        if self._controller is not None:
            return self._controller.use_fused_step
        return self._use_fused_step

    @use_fused_step.setter
    def use_fused_step(self, value: bool) -> None:
        self._use_fused_step = bool(value)
        if self._controller is not None:
            self._controller.use_fused_step = bool(value)

    # ------------------------------ pretraining ----------------------------

    @classmethod
    def pretrain(cls, ctx: PretrainContext) -> "START":
        """Train on a seed-7 warmup of ``ctx.config``; the controller
        lives on ``ctx.kwargs["device"]`` (default ``"cuda"``)."""
        ctrl = pretrain(dataclasses.replace(ctx.config, seed=7),
                        epochs=30 if ctx.epochs is None else ctx.epochs,
                        lr=1e-3, device=ctx.kwargs.get("device", "cuda"))
        # ctx.kwargs: per-technique sweep knobs (margin, k_lo, ...)
        return cls(controller=ctrl, **ctx.kwargs)

    # ------------------------------ policy api -----------------------------

    def _ensure_controller(self, view: TelemetryView) -> STARTController:
        if self._controller is None:
            cfg = view.config
            self._controller = STARTController(
                n_hosts=cfg.n_hosts, max_tasks=cfg.max_tasks,
                k=cfg.k, seed=self.seed,
                use_fused_step=self.use_fused_step, device=self.device)
        self.controller = self._controller
        return self._controller

    def observe(self, view: TelemetryView) -> None:
        ctrl = self._ensure_controller(view)
        # task-attributable utilization: the guard/k adaptation should
        # respond to load that mitigation competes with, not the static
        # reserved floor (overload-scenario experiments)
        raw = float(np.clip(view.hosts.util[:, 0].mean(), 0.0, 1.0))
        reserved = float(getattr(view.config, "reserved_utilization", 0.0))
        self._util = float(np.clip(raw - reserved, 0.0, 1.0))
        # adaptive straggler parameter (paper §4.3: "we dynamically change
        # the k value based on empirical results for the data up till the
        # current interval with the initial value as 1.5"): mitigate more
        # aggressively when the cluster has headroom, conservatively when
        # it is loaded.
        ctrl.predictor.k = self.k_lo + (self.k_hi - self.k_lo) * self._util
        ctrl.observe_hosts(_host_matrix(view))
        # ground-truth MA update from jobs completed so far (the engine
        # keeps the 0.8-decay moving average)
        ctrl.observe_straggler_counts(view.straggler_ma)

    def benefit_margin(self, kind: str = "speculate") -> float:
        """Migration-overhead margin for the expected-benefit guard at the
        most recently observed utilization.  RERUN margins never drop
        below ``rerun_margin_floor`` (a re-run forfeits the original's
        progress; a speculative copy does not)."""
        if self.margin is not None:
            return self.margin
        m = self.margin_lo + (self.margin_hi - self.margin_lo) * self._util
        if kind == "rerun":
            m = max(m, self.rerun_margin_floor)
        return m

    def decide(self, view: TelemetryView) -> list[Action]:
        if view.event != EVENT_INTERVAL:
            return []
        ctrl = self._ensure_controller(view)
        active = view.jobs.active()
        if len(active) == 0:
            self._last_es_sum = 0.0
            return []
        # array-native decision path: feature batch + trigger compare run
        # over the whole active set at once (an active job always has
        # open_count incomplete original tasks, so open_count IS the
        # remaining-task count the Algorithm-1 trigger compares against);
        # per-job task-id lists are built only for triggered jobs
        mts = _task_matrices(view, active)
        q = np.asarray(view.jobs.count[active], np.float32)

        def incomplete(job: int):
            # (tids, hosts, slots) — the third element maps each open
            # task to its M_T row (tid - CSR start) for the per-task
            # trigger; the milestone trigger ignores it
            inc = view.jobs.incomplete_tasks(job)
            start = int(view.jobs.start[job])
            return ([int(i) for i in inc],
                    [int(view.tasks.host[i]) for i in inc],
                    [int(i) - start for i in inc])

        # target scoring: prefer fast + idle hosts among straggler-MA ties
        h = view.hosts
        load = h.util[:, 0] - 0.5 * (h.speed / h.speed.max())
        acts = ctrl.decide_arrays(
            active, mts, q, view.jobs.open_count[active],
            view.jobs.deadline[active], incomplete, host_load=load)
        self._last_es_sum = ctrl.es_total(int(j) for j in active)
        # expected-benefit guard: a re-execution starts from zero progress,
        # so it only helps when  work/eff(target) < remaining/eff(source)
        # with the utilization-scaled, kind-aware margin (class docstring)
        eff = h.effective_speed()
        tt = view.tasks
        out = []
        for a in acts:
            src, tgt = a.source_host, a.target_host
            i = a.task_id
            kind = "speculate" if a.kind.value == "speculate" else "rerun"
            down = src >= 0 and h.downtime[src] > 0
            if not down:
                factor = 1.0 / (1.0 + self.benefit_margin(kind))
                src_eff = max(eff[src] if src >= 0 else 0.0, 1e-9)
                tgt_eff = max(eff[tgt], 1e-9)
                remaining = float(tt.work[i] - tt.progress[i])
                t_stay = remaining / src_eff
                t_move = float(tt.work[i]) / (factor * tgt_eff)
                if t_move >= t_stay:
                    continue
            out.append(Action(kind=kind, task=a.task_id,
                              target=a.target_host))
        return out

    def predicted_straggler_count(self) -> float | None:
        return self._last_es_sum


@register("start-eager", epochs_knob="pretrain_epochs",
          substrates=("sim", "pod"),
          description="START with the per-task predicted-straggler "
                      "trigger: mitigation starts as soon as the "
                      "predicted set is nonempty (hysteresis + per-task "
                      "cooldown) instead of at the q - floor(E_S) "
                      "completion milestone")
class STARTEager(START):
    """START with ``trigger="per_task"`` (the late-trigger-gap fix).

    Legacy START waits for a job to be down to its floor(E_S) open
    tasks — in saturated regimes (``overload``) that completion
    milestone arrives rarely and late, so START roughly ties ``none``.
    This variant mitigates the *predicted* stragglers directly: each
    interval the per-task score head ranks a job's open tasks, the
    top-floor(E_S) form the predicted set, and a task that stays in the
    set ``hysteresis`` consecutive intervals is speculated/rerun (then
    rests ``cooldown`` intervals).  Everything else — predictor,
    pretraining, the utilization-adaptive expected-benefit guard — is
    inherited from :class:`START`.

    On the pod substrate the same eager semantics run through
    :class:`repro_torch.distributed.straggler_runtime.StartEagerPodPolicy`
    (per-host predicted-straggler streaks -> backup shards, chronic
    stragglers -> evict), on the runtime's device.
    """

    name = "start-eager"

    def __init__(self, controller: STARTController | None = None,
                 seed: int = 0, score_on: float = 0.10,
                 hysteresis: int = 5, cooldown: int = 30, **kw):
        super().__init__(controller=controller, seed=seed, **kw)
        self.score_on = score_on
        self.hysteresis = hysteresis
        self.cooldown = cooldown
        self._pod = None
        if self._controller is not None:
            self._configure_trigger(self._controller)

    def _configure_trigger(self, ctrl: STARTController) -> None:
        ctrl.trigger = "per_task"
        ctrl.score_on = self.score_on
        ctrl.hysteresis = self.hysteresis
        ctrl.cooldown = self.cooldown

    def _ensure_controller(self, view: TelemetryView) -> STARTController:
        ctrl = super()._ensure_controller(view)
        self._configure_trigger(ctrl)
        return ctrl

    # --------------------------- pod substrate -----------------------------

    def _pod_policy(self):
        if self._pod is None:
            from repro_torch.distributed.straggler_runtime import \
                StartEagerPodPolicy
            self._pod = StartEagerPodPolicy(hysteresis=self.hysteresis,
                                            cooldown=self.cooldown)
        return self._pod

    def observe(self, view: TelemetryView) -> None:
        from repro_torch.sim.techniques.replication import _on_pod
        if _on_pod(view):
            self._pod_policy().observe(view)
            return
        super().observe(view)

    def decide(self, view: TelemetryView) -> list[Action]:
        from repro_torch.sim.techniques.replication import _on_pod
        if _on_pod(view):
            return self._pod_policy().decide(view)
        return super().decide(view)

    def forget_tasks(self, task_ids) -> None:
        if self._pod is not None:
            self._pod.forget_tasks(task_ids)
        if self._controller is not None:
            self._controller.forget_tasks(task_ids)


def collect_training_data(cfg: SimConfig, horizon: int = 5
                          ) -> tuple[np.ndarray, np.ndarray]:
    """§4.4: random-scheduler run ->
    (xs: (T, jobs, dim), targets: (jobs, 2))."""
    sim = Simulation(cfg, technique=NoOpRecorder(horizon),
                     scheduler=RandomScheduler())
    sim.run()
    rec: NoOpRecorder = sim.technique  # type: ignore[assignment]
    return rec.dataset(sim.snapshot())


class EmptyWarmupError(RuntimeError):
    """The warmup simulation completed no jobs — nothing to fit."""


class NoOpRecorder(Policy):
    """Records host matrices + job completions to build the training set."""

    name = "recorder"

    def __init__(self, horizon: int = 5):
        self.horizon = horizon
        self.host_hist: list[np.ndarray] = []

    def observe(self, view: TelemetryView) -> None:
        self.host_hist.append(_host_matrix(view))

    def dataset(self, view: TelemetryView):
        recs = view.completed_jobs
        if not recs:
            raise EmptyWarmupError("no completed jobs to train on")
        hh = np.stack(self.host_hist)  # (T_total, n, m)
        h = self.horizon
        # per-job trailing host-history windows, left-clamped to hh[0]
        # (identical data to the old per-job slice + repeat-pad loop),
        # gathered for every job at once
        t_end = np.array([min(rec["t"], len(hh)) - 1 for rec in recs])
        idx = np.maximum(
            t_end[:, None] + np.arange(-h + 1, 1)[None, :], 0)
        seqs = hh[idx].reshape(len(recs), h, -1)       # (J, h, n*m)
        jobs = np.array([rec["job"] for rec in recs], np.int64)
        mts = _task_matrices(view, jobs).reshape(len(recs), 1, -1)
        xs = np.concatenate(
            [seqs, np.repeat(mts, h, axis=1)], axis=-1)  # (J, h, dim)
        ys = []
        for rec in recs:
            a, b = pareto.fit_pareto_np(rec["times"])
            # beta regressed in interval units (predictor beta_scale)
            ys.append([float(a), float(b) / view.interval_seconds])
        return np.ascontiguousarray(xs.transpose(1, 0, 2)), \
            np.array(ys, np.float32)


def pretrain(cfg: SimConfig, epochs: int = 30, lr: float = 1e-3,
             seed: int = 0, device: str | torch.device = "cuda"
             ) -> STARTController:
    """Train a STARTController's predictor offline (paper §4.4), on
    ``device``, where the controller then stays.

    The paper uses lr = 1e-5 for its long offline phase; benchmarks use a
    larger lr with fewer epochs for wall-clock sanity (same optimizer).

    A saturated training regime (e.g. the overload scenario at small
    grid sizes) can complete zero jobs in the warmup horizon, leaving
    nothing to fit — in that case the arrival rate is halved (up to a
    few times, deterministically) until the warmup yields completions,
    rather than failing the whole sweep.
    """
    train_cfg = cfg
    for _ in range(4):
        try:
            xs, ys = collect_training_data(train_cfg)
            break
        except EmptyWarmupError:
            train_cfg = dataclasses.replace(
                train_cfg, arrival_rate=train_cfg.arrival_rate / 2.0)
    else:
        xs, ys = collect_training_data(train_cfg)  # raise with context
    ctrl = STARTController(n_hosts=cfg.n_hosts, max_tasks=cfg.max_tasks,
                           k=cfg.k, seed=seed,
                           beta_scale=cfg.interval_seconds, device=device)
    ctrl.predictor.fit(xs, ys, epochs=epochs, lr=lr)
    return ctrl
