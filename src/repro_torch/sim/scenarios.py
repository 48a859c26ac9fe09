"""Scenario registry: named workload/fault regimes for the cloud simulator.

START's comparative claims (paper Figs. 6-10) are regime-sensitive: Wang et
al. show the best replication policy flips with the service-time tail, and
Aktas & Soljanin show it flips with load. The registry parameterizes
``SimConfig`` (and through it ``WorkloadGenerator``/``FaultInjector``/
``Cluster``) beyond the single PlanetLab-like default so sweeps can cover
those regimes explicitly:

  planetlab    the paper's default trace shape (diurnal + mild tail)
  flash-crowd  periodic arrival bursts (queueing spikes -> contention
               stragglers; stresses reactive speculation lag)
  heavy-tail   heavier Pareto service demand (stragglers from work skew,
               not placement; stresses prediction + cloning policies)
  hetero-fleet mixed per-host MI/s (slow-host stragglers; stresses
               placement-aware techniques vs progress-only ones)
  overload     high sustained load + reserved capacity (contention spiral;
               stresses mitigation that adds load, e.g. aggressive cloning)
  fault-storm  elevated host/cloudlet/VM-creation fault rates with longer
               downtimes (restart-dominated stragglers; stresses
               first-result-wins bookkeeping and restart overhead)

Each scenario is a set of absolute ``SimConfig`` overrides plus an
``arrival_scale`` multiplier applied to whatever base arrival rate the
caller picked (so scenarios compose with cluster-size scaling).
"""
from __future__ import annotations

import dataclasses

from repro_torch.sim.config import SimConfig


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    stresses: str
    overrides: tuple = ()        # ((field, value), ...) absolute overrides
    arrival_scale: float = 1.0   # multiplies the caller's base arrival_rate


REGISTRY: dict[str, Scenario] = {}


def _register(s: Scenario) -> Scenario:
    REGISTRY[s.name] = s
    return s


_register(Scenario(
    name="planetlab",
    description="Paper-default PlanetLab-like trace: diurnal arrivals, "
                "mild heavy-tail service demand, baseline fault rates.",
    stresses="the paper's reference regime (Figs. 6-10)",
))

_register(Scenario(
    name="flash-crowd",
    description="Periodic arrival bursts: every 24 intervals, 4 intervals "
                "of 6x arrivals on top of the diurnal curve.",
    stresses="queueing spikes and reactive-technique detection lag",
    overrides=(("burst_period", 24), ("burst_width", 4),
               ("burst_multiplier", 6.0)),
))

_register(Scenario(
    name="heavy-tail",
    description="Heavy-tail-dominated service demand: tail index 1.6 and "
                "35% of tasks drawn from the Pareto tail.",
    stresses="work-skew stragglers; prediction and cloning policies",
    overrides=(("work_pareto_tail", 1.6), ("heavy_fraction", 0.35)),
))

_register(Scenario(
    name="hetero-fleet",
    description="Heterogeneous fleet: per-host MI/s tiled from "
                "(0.5x, 1x, 2x) of the default, on top of the Table-3 "
                "speed mix.",
    stresses="slow-host stragglers; placement-aware vs progress-only "
             "techniques",
    overrides=(("host_ips", (4.17, 8.33, 16.66)),),
))

_register(Scenario(
    name="overload",
    description="Sustained high load: 2.5x arrivals with 40% of every "
                "resource reserved.",
    stresses="contention spirals; mitigation that adds load",
    overrides=(("reserved_utilization", 0.4),),
    arrival_scale=2.5,
))

_register(Scenario(
    name="fault-storm",
    description="Elevated fault regime: 8x host, 6x cloudlet and 5x "
                "VM-creation fault rates, downtimes up to 6 intervals.",
    stresses="restart-dominated stragglers; first-result-wins and "
             "restart-overhead accounting",
    overrides=(("fault_host_rate", 0.08), ("fault_task_rate", 0.05),
               ("fault_vm_creation_rate", 0.02), ("max_downtime", 6)),
))


def names() -> list[str]:
    return list(REGISTRY)


def get(name: str) -> Scenario:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; known: {names()}")


def make_config(scenario: str, seed: int = 0, *, n_hosts: int = 32,
                n_intervals: int = 72, arrival_rate: float = 0.6,
                **extra) -> SimConfig:
    """Build a SimConfig for a named scenario.

    Base sizing (hosts/intervals/arrival rate) comes from the caller so the
    same scenario runs at test, benchmark, or paper (Table 4) scale;
    ``extra`` overrides win over scenario overrides (sweep-level knobs).
    """
    s = get(scenario)
    kw: dict = dict(n_hosts=n_hosts, n_intervals=n_intervals,
                    arrival_rate=arrival_rate * s.arrival_scale, seed=seed)
    kw.update(dict(s.overrides))
    kw.update(extra)
    return SimConfig(**kw)
