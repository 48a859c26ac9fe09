"""START controller — Algorithm 1 of the paper, runtime-agnostic, over the
PyTorch predictor.

Consumes per-interval telemetry (host matrix M_H + per-job task matrices
M_T), predicts per-job expected straggler counts E_S via the Encoder-LSTM ->
Pareto pipeline, and emits mitigation actions once a job has only floor(E_S)
tasks left ("run job till completion of q - floor(E_S) tasks", line 12),
or — with ``trigger="per_task"`` — as soon as the predicted straggler set
is nonempty.  The decision logic is the JAX package's, line for line; only
the predictor differs.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import mitigation
from repro_torch.core.predictor import StragglerPredictor


@dataclasses.dataclass
class JobView:
    """Runtime-agnostic snapshot of one in-flight job."""

    job_id: int
    q: int                          # total tasks
    deadline_oriented: bool
    incomplete_task_ids: list[int]  # tasks still running
    task_hosts: list[int]           # host of each incomplete task
    task_matrix: np.ndarray         # (max_tasks, TASK_FEATURES)


class STARTController:
    """Algorithm-1 controller.

    ``use_fused_step`` (default on) routes the per-interval prediction
    through the predictor's fused device step: the M_H history lives in a
    device ring and one staged copy plus one readback serve the interval.
    Set ``REPRO_DISABLE_FUSED_STEP=1`` to force the unfused reference
    path for debugging.  ``device`` (default ``"cuda"``) places the
    controller's own predictor; an injected ``predictor`` keeps its own.
    """

    def __init__(self, n_hosts: int, max_tasks: int, k: float = 1.5,
                 horizon: int = 5, seed: int = 0,
                 ma_decay: float = 0.8, beta_scale: float = 1.0,
                 use_fused_step: bool = True, trigger: str = "milestone",
                 score_on: float = 0.0, hysteresis: int = 2,
                 cooldown: int = 5,
                 predictor: StragglerPredictor | None = None,
                 device: str | torch.device = "cuda"):
        if trigger not in ("milestone", "per_task"):
            raise ValueError(f"unknown trigger mode {trigger!r}")
        # an injected predictor lets many controllers share one model;
        # its hyper-parameters win over the ctor's
        if predictor is not None:
            k, horizon = predictor.k, predictor.horizon
        self.predictor = predictor if predictor is not None \
            else StragglerPredictor(
                n_hosts=n_hosts, max_tasks=max_tasks, k=k, horizon=horizon,
                seed=seed, beta_scale=beta_scale, device=device)
        self.ma = mitigation.StragglerMovingAverage(n_hosts, decay=ma_decay)
        self.horizon = horizon
        self.use_fused_step = use_fused_step and not os.environ.get(
            "REPRO_DISABLE_FUSED_STEP")
        #: "milestone" — Algorithm 1 verbatim: act once a job is down to
        #: floor(E_S) open tasks.  "per_task" — act as soon as the
        #: predicted straggler set is nonempty: each interval the
        #: top-floor(E_S) incomplete tasks by per-task score (>=
        #: ``score_on``) form the set; a task fires after ``hysteresis``
        #: consecutive intervals in the set and then rests ``cooldown``
        #: intervals.
        self.trigger = trigger
        self.score_on = score_on
        self.hysteresis = hysteresis
        self.cooldown = cooldown
        self._host_hist: collections.deque = collections.deque(
            maxlen=horizon)
        self._mitigated: set[int] = set()
        self._es_cache: dict[int, float] = {}
        self._tick = 0                       # decide_arrays intervals seen
        self._streak: dict[int, int] = {}    # task -> consecutive in-set
        self._cool: dict[int, int] = {}      # task -> tick cooldown expires

    # ------------------------------ telemetry -----------------------------

    def observe_hosts(self, m_h: np.ndarray) -> None:
        m_h = np.asarray(m_h, np.float32)
        self._host_hist.append(m_h)
        if self.use_fused_step:
            self.predictor.push_host_row(m_h)

    def observe_straggler_counts(self, counts: np.ndarray) -> None:
        self.ma.update(counts)

    def job_finished(self, job_id: int) -> None:
        self._mitigated.discard(job_id)
        self._es_cache.pop(job_id, None)

    def es_total(self, job_ids) -> float:
        """Sum of the latest per-job E_S predictions over ``job_ids``
        (jobs never predicted contribute 0)."""
        return float(sum(self._es_cache.get(j, 0.0) for j in job_ids))

    def _host_seq(self) -> np.ndarray:
        hist = list(self._host_hist)
        while len(hist) < self.horizon:  # left-pad with oldest snapshot
            hist.insert(0, hist[0])
        return np.stack(hist[-self.horizon:])

    # ------------------------------ decision ------------------------------

    def predict_es(self, jobs: Sequence[JobView]) -> np.ndarray:
        """Batched PredictStraggler (Alg. 1 lines 6-13) over JobViews."""
        if not jobs:
            return np.zeros(0)
        return self.predict_es_batch(
            np.array([j.job_id for j in jobs], np.int64),
            np.stack([j.task_matrix for j in jobs]),
            np.array([j.q for j in jobs], np.float32))

    @staticmethod
    def _sanitize_es(e_s: np.ndarray, q: np.ndarray) -> np.ndarray:
        """Non-finite E_S maps to 0 (mitigating on garbage is worse than
        waiting) and finite values clamp to [0, q]."""
        e_s = np.asarray(e_s)
        e_s = np.where(np.isfinite(e_s), e_s, 0.0)
        return np.clip(e_s, 0.0, np.asarray(q, e_s.dtype))

    def predict_es_batch(self, job_ids: np.ndarray, m_t: np.ndarray,
                         q: np.ndarray) -> np.ndarray:
        """Array-native PredictStraggler over the active-job batch.  A
        repeat predict within the same interval (no fresh host row) takes
        the unfused path."""
        if len(job_ids) == 0 or not self._host_hist:
            return np.zeros(len(job_ids))
        q = np.asarray(q, np.float32)
        if self.use_fused_step and self.predictor.fused_ready:
            e_s = self.predictor.predict_interval(m_t, q)
        else:
            pred = self.predictor.predict_features(self._host_seq(), m_t, q)
            e_s = np.asarray(pred.e_s)
        e_s = self._sanitize_es(e_s, q)
        for j, e in zip(job_ids, e_s):
            self._es_cache[int(j)] = float(e)
        return e_s

    def predict_scores_batch(self, job_ids: np.ndarray, m_t: np.ndarray,
                             q: np.ndarray
                             ) -> tuple[np.ndarray, np.ndarray]:
        """Per-task PredictStraggler: ``(e_s, scores)`` with ``scores``
        of shape (jobs, max_tasks)."""
        if len(job_ids) == 0 or not self._host_hist:
            return (np.zeros(len(job_ids)),
                    np.zeros((len(job_ids), self.predictor.max_tasks)))
        q = np.asarray(q, np.float32)
        if self.use_fused_step and self.predictor.fused_ready:
            e_s, scores = self.predictor.predict_interval(
                m_t, q, per_task=True)
        else:
            e_s, scores = self.predictor.predict_features(
                self._host_seq(), m_t, q, per_task=True)
        e_s = self._sanitize_es(e_s, q)
        scores = np.where(np.isfinite(scores), scores, 0.0)
        for j, e in zip(job_ids, e_s):
            self._es_cache[int(j)] = float(e)
        return e_s, scores

    def decide_arrays(self, job_ids: np.ndarray, m_t: np.ndarray,
                      q: np.ndarray, open_counts: np.ndarray,
                      deadline: np.ndarray, incomplete_fn,
                      host_load: np.ndarray | None = None
                      ) -> list[mitigation.Action]:
        """Array-native Algorithm-1 main loop.  ``incomplete_fn(job)``
        returns ``(task_ids, hosts)`` — plus each task's slot index into
        the job's M_T rows for ``trigger="per_task"``."""
        if len(job_ids) == 0:
            return []
        if self.trigger == "per_task":
            e_s, scores = self.predict_scores_batch(job_ids, m_t, q)
            return self.apply_per_task(job_ids, e_s, scores, deadline,
                                       incomplete_fn, host_load)
        e_s = self.predict_es_batch(job_ids, m_t, q)
        return self.apply_milestone(job_ids, e_s, open_counts, deadline,
                                    incomplete_fn, host_load)

    def apply_milestone(self, job_ids: np.ndarray, e_s: np.ndarray,
                        open_counts: np.ndarray, deadline: np.ndarray,
                        incomplete_fn,
                        host_load: np.ndarray | None = None
                        ) -> list[mitigation.Action]:
        """Milestone trigger over an (already sanitized) E_S batch."""
        n_mit = np.floor(e_s)
        trig = (n_mit >= 1.0) & (open_counts <= n_mit)
        actions: list[mitigation.Action] = []
        for idx in np.nonzero(trig)[0]:
            job = int(job_ids[idx])
            if job in self._mitigated:
                continue
            tids, hosts = incomplete_fn(job)[:2]
            actions.extend(mitigation.plan_mitigation(
                job, tids, hosts, bool(deadline[idx]), self.ma,
                load=host_load))
            self._mitigated.add(job)
        return actions

    def apply_per_task(self, job_ids: np.ndarray, e_s: np.ndarray,
                       scores: np.ndarray, deadline: np.ndarray,
                       incomplete_fn,
                       host_load: np.ndarray | None = None
                       ) -> list[mitigation.Action]:
        """Per-task trigger over an (already sanitized) prediction batch:
        each job's top-floor(E_S) incomplete tasks by score (at least
        ``score_on``) form the predicted set; a task fires after
        ``hysteresis`` consecutive intervals in it, then rests
        ``cooldown`` intervals; with ``host_load`` it fires only from an
        at-or-above-median-load host."""
        self._tick += 1
        actions: list[mitigation.Action] = []
        in_set: set[int] = set()
        load_med = (np.median(host_load) if host_load is not None
                    else None)
        for idx in range(len(job_ids)):
            n_pred = int(np.floor(e_s[idx]))
            if n_pred < 1:
                continue
            job = int(job_ids[idx])
            tids, hosts, slots = incomplete_fn(job)
            if len(tids) == 0:
                continue
            tids = np.asarray(tids, np.int64)
            s = scores[idx][np.asarray(slots, np.int64)]
            order = np.argsort(-s, kind="stable")[:n_pred]
            fire_t: list[int] = []
            fire_h: list[int] = []
            for i in order:
                if s[i] < self.score_on:
                    continue
                tid = int(tids[i])
                in_set.add(tid)
                streak = self._streak.get(tid, 0) + 1
                self._streak[tid] = streak
                if streak < self.hysteresis \
                        or self._cool.get(tid, 0) > self._tick:
                    continue
                src = int(hosts[i])
                if load_med is not None and src >= 0 \
                        and host_load[src] < load_med:
                    continue
                fire_t.append(tid)
                fire_h.append(src)
                self._cool[tid] = self._tick + self.cooldown
                self._streak[tid] = 0
            if fire_t:
                actions.extend(mitigation.plan_mitigation(
                    job, fire_t, fire_h, bool(deadline[idx]), self.ma,
                    load=host_load))
        # a task that dropped out of the predicted set loses its streak
        for tid in [t for t in self._streak if t not in in_set]:
            del self._streak[tid]
        return actions

    def forget_tasks(self, task_ids) -> None:
        """Drop per-task trigger state (streaks, cooldowns) for recycled
        task ids."""
        for t in task_ids:
            t = int(t)
            self._streak.pop(t, None)
            self._cool.pop(t, None)

    def decide(self, jobs: Sequence[JobView],
               host_load: np.ndarray | None = None
               ) -> list[mitigation.Action]:
        """Algorithm 1 main loop over JobViews (milestone trigger only: a
        JobView carries no slot mapping into its task matrix)."""
        if not jobs:
            return []
        e_s = self.predict_es(jobs)
        actions: list[mitigation.Action] = []
        for job, es in zip(jobs, e_s):
            n_mit = int(np.floor(es))
            if n_mit <= 0 or job.job_id in self._mitigated:
                continue  # normal job (J_n) or already handled
            if len(job.incomplete_task_ids) <= n_mit:
                actions.extend(mitigation.plan_mitigation(
                    job.job_id, job.incomplete_task_ids, job.task_hosts,
                    job.deadline_oriented, self.ma, load=host_load))
                self._mitigated.add(job.job_id)
        return actions
