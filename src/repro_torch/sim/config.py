"""Simulation configuration (paper Tables 3-4, §4.2-4.3).

The paper simulates a CloudSim datacenter with 400 VMs built from three
physical-machine types, PlanetLab-derived workload traces (300 s scheduling
intervals, 2880-interval traces), Poisson(1.2) job arrivals of 2-10 task
jobs (50% deadline-driven), and Weibull(k=1.5, lambda=2) fault injection.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

INTERVAL_SECONDS = 300.0  # PlanetLab scheduling interval size (§4.2)


@dataclasses.dataclass(frozen=True)
class HostType:
    name: str
    speed: float        # relative CPU capacity (i5 = 1.0)
    cores: int
    ram_gb: float
    disk_gb: float
    bw_kbps: float
    power_min_w: float
    power_max_w: float
    cost: float         # C$ per interval (Table 4: workload cost 3-5)
    weight: int         # mix proportion (Table 3 'virtual nodes': 12/6/2)


# Table 3 physical machines; speeds scaled by core count x clock.
HOST_TYPES = (
    HostType("core2duo", speed=2 * 2.4 / (4 * 2.9), cores=2, ram_gb=6,
             disk_gb=320, bw_kbps=1.0, power_min_w=108, power_max_w=273,
             cost=3.0, weight=12),
    HostType("i5", speed=1.0, cores=4, ram_gb=4, disk_gb=160,
             bw_kbps=1.5, power_min_w=120, power_max_w=250, cost=4.0,
             weight=6),
    HostType("xeon", speed=4 * 2.2 / (4 * 2.9), cores=4, ram_gb=2,
             disk_gb=160, bw_kbps=2.0, power_min_w=130, power_max_w=240,
             cost=5.0, weight=2),
)


@dataclasses.dataclass
class SimConfig:
    n_hosts: int = 400               # Table 4: number of VMs
    n_intervals: int = 288           # 24 h of 300 s intervals (§5.1)
    arrival_rate: float = 1.2        # Poisson lambda, jobs/interval (§4.2)
    min_tasks: int = 2               # jobs have 2-10 tasks (§4.2)
    max_tasks: int = 10
    deadline_fraction: float = 0.5   # 50% deadline driven (§4.2)
    work_mean: float = 10000.0       # cloud workload size 10000 +- 3000 (T4)
    work_std: float = 3000.0
    work_pareto_tail: float = 2.2    # heavy-tail mix so times are Pareto-ish
    heavy_fraction: float = 0.15     # fraction of tasks drawn from the tail
    # flash-crowd bursts (scenario registry): while burst_period > 0 and
    # t mod burst_period < burst_width, arrivals are scaled by
    # burst_multiplier on top of the diurnal curve
    burst_period: int = 0
    burst_width: int = 0
    burst_multiplier: float = 1.0
    # Effective MI/s per unit host speed. Table 4 lists 2000 MIPS, which with
    # 10000-MI tasks gives sub-second tasks that could never straggle across
    # 300 s PlanetLab intervals; we rescale so the mean task spans ~4
    # intervals, as in the trace dataset (deviation noted in DESIGN.md).
    # A tuple means a heterogeneous fleet: values are tiled across hosts
    # (host h gets host_ips[h mod len]).
    host_ips: float | tuple = 8.33
    restart_overhead_s: float = 30.0  # R_i per restart (Eq. 8)
    deadline_slack: tuple = (1.6, 3.0)  # x expected time
    # faults (§4.3): Weibull(k=1.5, lambda=2) inter-failure, ephemeral
    fault_weibull_k: float = 1.5
    fault_weibull_lambda: float = 2.0
    fault_host_rate: float = 0.010   # per host per interval scale
    fault_task_rate: float = 0.008   # cloudlet faults
    fault_vm_creation_rate: float = 0.004
    max_downtime: int = 4            # ephemeral host faults (<= 4 intervals)
    # reserved utilization experiments block a fraction of every resource
    reserved_utilization: float = 0.0
    # straggler threshold multiple (paper k = 1.5)
    k: float = 1.5
    seed: int = 0
    total_workloads: int | None = None  # optional cap (Table 4: 5000)

    @property
    def interval_seconds(self) -> float:
        return INTERVAL_SECONDS

    @functools.cached_property
    def host_ips_mean(self) -> float:
        """Fleet-average MI/s per unit speed (scalar even when host_ips
        describes a heterogeneous fleet; averages the actual tiled
        fleet, which differs from mean(host_ips) when n_hosts is not a
        multiple of the tuple length). Cached: it sits in per-task hot
        loops, and configs are treated as immutable once a Simulation is
        built."""
        return float(self.host_ips_array().mean())

    def host_ips_array(self) -> np.ndarray:
        """(n_hosts,) per-host MI/s per unit speed."""
        return np.resize(np.asarray(self.host_ips, float).ravel(),
                         self.n_hosts)


def small(**kw) -> SimConfig:
    """Reduced config for tests/CI."""
    base = dict(n_hosts=20, n_intervals=60, arrival_rate=1.2, seed=0)
    base.update(kw)
    return SimConfig(**base)
