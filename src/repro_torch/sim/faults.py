"""Fault Injection Module (paper §4.3): Weibull-distributed fault events.

Mirrors the paper's FaultInjector/FaultEvent/FaultHandlerDatacenter: three
fault classes — host faults (ephemeral downtime <= 4 intervals; all resident
tasks restart), cloudlet faults (task must re-run), VM-creation faults
(placement fails, task re-queued). Inter-arrival times follow
Weibull(k = 1.5, lambda = 2) scaled by per-class rates (Eq. 15, refs [44],
[45]).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.sim.config import SimConfig


class FaultKind(enum.Enum):
    HOST = "host_failure"
    CLOUDLET = "cloudlet_failure"
    VM_CREATION = "vm_creation_failure"


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: FaultKind
    host: int           # host affected (HOST / VM_CREATION)
    downtime: int       # intervals (HOST only)


class FaultInjector:
    def __init__(self, cfg: SimConfig, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng

    def _weibull_events(self, n_entities: int, rate: float) -> np.ndarray:
        """Entities whose Weibull clock fires this interval.

        We sample a Weibull(k, lambda) horizon per entity and fire when it is
        below the per-interval rate threshold — a discretized renewal process
        equivalent in rate to the paper's event-driven injector.
        """
        k = self.cfg.fault_weibull_k
        lam = self.cfg.fault_weibull_lambda
        draws = lam * self.rng.weibull(k, size=n_entities)
        # P(fire) calibrated so mean fire prob ~= rate
        thresh = lam * rate * 1.8  # E[Weibull(1.5,2)] ~= 1.8
        return draws < thresh

    def interval_events(self) -> list[FaultEvent]:
        cfg = self.cfg
        events: list[FaultEvent] = []
        host_fail = self._weibull_events(cfg.n_hosts, cfg.fault_host_rate)
        for h in np.nonzero(host_fail)[0]:
            dt = int(self.rng.integers(1, cfg.max_downtime + 1))
            events.append(FaultEvent(FaultKind.HOST, int(h), dt))
        vm_fail = self._weibull_events(cfg.n_hosts,
                                       cfg.fault_vm_creation_rate)
        for h in np.nonzero(vm_fail)[0]:
            events.append(FaultEvent(FaultKind.VM_CREATION, int(h), 0))
        return events

    def cloudlet_faults(self, n_active: int) -> np.ndarray:
        """Boolean mask over active tasks that suffer a cloudlet fault."""
        if n_active == 0:
            return np.zeros(0, bool)
        return self._weibull_events(n_active, self.cfg.fault_task_rate)
