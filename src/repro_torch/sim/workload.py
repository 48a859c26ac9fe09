"""Workload model (paper §4.2): PlanetLab-like traces + Poisson job arrivals.

The real PlanetLab CoMon traces are unavailable offline; we synthesize
per-task utilization series matching the dataset's published shape: 300 s
intervals, diurnal CPU pattern plus bursty noise, heavy-tailed task service
demand (so response times are Pareto-like, the paper's §3.1 premise).
Jobs have 2-10 tasks, 50% deadline-driven, Poisson(1.2) arrivals/interval.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.config import SimConfig


@dataclasses.dataclass
class JobBatch:
    """Tasks arriving this interval (struct-of-arrays)."""

    job_ids: np.ndarray      # (t,)
    req: np.ndarray          # (t, 4) resource fractions
    work: np.ndarray         # (t,) service demand (MI)
    deadline_rel: np.ndarray  # (t,) seconds from submission
    is_deadline: np.ndarray  # (t,) bool — deadline-driven job?
    sla_weight: np.ndarray   # (t,) weight w_i of each task's SLA (Eq. 13)


class WorkloadGenerator:
    def __init__(self, cfg: SimConfig, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng
        self._next_job = 0
        self._emitted = 0
        # diurnal load curve (PlanetLab CPU has day/night structure)
        t = np.arange(cfg.n_intervals)
        day = cfg.n_intervals / 2.0
        self.diurnal = 0.75 + 0.25 * np.sin(2 * np.pi * t / max(day, 1.0))

    def burst_factor(self, t: int) -> float:
        """Flash-crowd multiplier: burst_multiplier inside burst windows."""
        cfg = self.cfg
        if cfg.burst_period > 0 and (t % cfg.burst_period) < cfg.burst_width:
            return cfg.burst_multiplier
        return 1.0

    def sample_interval(self, t: int) -> JobBatch:
        cfg, rng = self.cfg, self.rng
        lam = (cfg.arrival_rate * self.diurnal[min(t, cfg.n_intervals - 1)]
               * self.burst_factor(t))
        n_jobs = rng.poisson(lam)
        ids, reqs, works, dls, isdl, w = [], [], [], [], [], []
        for _ in range(n_jobs):
            if (cfg.total_workloads is not None
                    and self._emitted >= cfg.total_workloads):
                break
            q = rng.integers(cfg.min_tasks, cfg.max_tasks + 1)
            jid = self._next_job
            self._next_job += 1
            self._emitted += q
            deadline_job = rng.random() < cfg.deadline_fraction
            # requirements: correlated within a job, bursty across tasks
            base = rng.uniform(0.05, 0.35, size=4)
            req = np.clip(base[None] * rng.lognormal(0, 0.4, (q, 4)),
                          0.02, 0.9)
            # service demand: normal body + Pareto tail mix (heavy tail)
            body = rng.normal(cfg.work_mean, cfg.work_std, q)
            tail = cfg.work_mean * (
                rng.pareto(cfg.work_pareto_tail, q) + 1.0)
            heavy = rng.random(q) < cfg.heavy_fraction
            work = np.clip(np.where(heavy, tail, body),
                           cfg.work_mean * 0.1, cfg.work_mean * 20)
            # seconds at fleet-average effective speed (~0.6 of nominal:
            # Table-3 mix is dominated by the slow core2duo class)
            expected = work / (cfg.host_ips_mean * 0.6)
            slack = rng.uniform(*cfg.deadline_slack, q)
            ids.append(np.full(q, jid))
            reqs.append(req)
            works.append(work)
            dls.append(expected * slack)
            isdl.append(np.full(q, deadline_job))
            w.append(rng.uniform(0.5, 1.0, q))
        if not ids:
            z = np.zeros(0)
            return JobBatch(z.astype(np.int64), np.zeros((0, 4)), z, z,
                            z.astype(bool), z)
        return JobBatch(
            job_ids=np.concatenate(ids).astype(np.int64),
            req=np.concatenate(reqs),
            work=np.concatenate(works),
            deadline_rel=np.concatenate(dls),
            is_deadline=np.concatenate(isdl),
            sla_weight=np.concatenate(w),
        )
