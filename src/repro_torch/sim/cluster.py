"""Heterogeneous host cluster (paper Table 3) with utilization accounting.

Hosts are a struct-of-arrays; utilization is recomputed each interval from
the placed tasks' requirement vectors. Overload (>100% of any resource)
produces both a contention penalty on progress and a contention metric
(Eq. 9).
"""
from __future__ import annotations

import numpy as np

from repro_torch.policy.telemetry import effective_speed as _effective_speed
from repro_torch.sim.config import HOST_TYPES, SimConfig

RES = ("cpu", "ram", "disk", "bw")
N_RES = 4


class Cluster:
    def __init__(self, cfg: SimConfig, rng: np.random.Generator):
        self.cfg = cfg
        n = cfg.n_hosts
        mix = np.concatenate([
            np.full(ht.weight, i) for i, ht in enumerate(HOST_TYPES)])
        type_idx = mix[rng.integers(0, len(mix), size=n)]
        self.type_idx = type_idx
        self.type_names = np.array([HOST_TYPES[i].name for i in type_idx])
        self.speed = np.array([HOST_TYPES[i].speed for i in type_idx])
        # capacity vectors (cpu normalized to cores*speed; others absolute)
        self.cap = np.stack([
            np.array([HOST_TYPES[i].cores * HOST_TYPES[i].speed
                      for i in type_idx]),
            np.array([HOST_TYPES[i].ram_gb for i in type_idx]),
            np.array([HOST_TYPES[i].disk_gb for i in type_idx]),
            np.array([HOST_TYPES[i].bw_kbps for i in type_idx]),
        ], axis=1)  # (n, 4)
        self.power_min = np.array([HOST_TYPES[i].power_min_w
                                   for i in type_idx])
        self.power_max = np.array([HOST_TYPES[i].power_max_w
                                   for i in type_idx])
        self.cost = np.array([HOST_TYPES[i].cost for i in type_idx])
        # dynamic state
        self.util = np.zeros((n, N_RES))         # fraction of capacity
        self.n_tasks = np.zeros(n, np.int64)
        self.downtime = np.zeros(n, np.int64)    # intervals remaining down
        self.reserved = np.full((n, N_RES), cfg.reserved_utilization)

    @property
    def n(self) -> int:
        return self.cfg.n_hosts

    def online(self) -> np.ndarray:
        return self.downtime == 0

    def begin_interval(self) -> None:
        self.downtime = np.maximum(self.downtime - 1, 0)

    def fail_host(self, h: int, downtime: int) -> None:
        self.downtime[h] = min(downtime, self.cfg.max_downtime)

    def recompute_utilization(self, task_req: np.ndarray,
                              task_host: np.ndarray,
                              active: np.ndarray) -> None:
        """util[h] = reserved + sum of active task reqs on h (fraction)."""
        self.util = self.reserved.copy()
        self.n_tasks[:] = 0
        if active.any():
            hosts = task_host[active]
            reqs = task_req[active]
            np.add.at(self.util, hosts, reqs)
            np.add.at(self.n_tasks, hosts, 1)

    def effective_speed(self) -> np.ndarray:
        """Per-host progress rate (the paper's 'resource contention is
        the main reason for stragglers').  The formula lives in
        ``repro_torch.policy.telemetry.effective_speed`` so policy-side host
        views compute the identical quantity."""
        return _effective_speed(self.util, self.speed, self.online())

    def overloaded(self) -> np.ndarray:
        """(n, N_RES) bool: any resource demanded above capacity."""
        return self.util > 1.0 + 1e-9

    def energy(self) -> float:
        """Eq. 7: sum_k U_k * (Emax - Emin) + Emin (per interval, in W)."""
        u = np.clip(self.util.mean(axis=1), 0.0, 1.0)
        return float(np.sum(u * (self.power_max - self.power_min)
                            + self.power_min))
