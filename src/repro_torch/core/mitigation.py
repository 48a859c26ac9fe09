"""Straggler Mitigation (paper §3.3 + Algorithm 1).

Two strategies:
  * SPECULATE — run a copy of the task on a separate node, first result wins
    (for deadline-driven jobs).
  * RERUN — kill and restart the task on a new node (non-deadline jobs).

Target-node selection: "the new node that has the lowest moving average of
the number of straggler tasks for the current time-step" (§3.3). Cloning is
deliberately not implemented (paper: too much overhead at scale [40]).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Kind(enum.Enum):
    SPECULATE = "speculate"
    RERUN = "rerun"


@dataclasses.dataclass(frozen=True)
class Action:
    job_id: int
    task_id: int
    kind: Kind
    target_host: int
    source_host: int


class StragglerMovingAverage:
    """Per-host exponential moving average of observed straggler counts."""

    def __init__(self, n_hosts: int, decay: float = 0.8):
        self.ma = np.zeros(n_hosts, np.float64)
        self.decay = decay

    def update(self, counts: np.ndarray) -> None:
        self.ma = self.decay * self.ma + (1.0 - self.decay) * np.asarray(
            counts, np.float64)

    def pick_targets(self, n: int, exclude: set[int] | None = None,
                     load: np.ndarray | None = None) -> list[int]:
        """Lowest-MA hosts first; ties broken by current load then index."""
        exclude = exclude or set()
        order = sorted(
            (i for i in range(len(self.ma)) if i not in exclude),
            key=lambda i: (self.ma[i],
                           float(load[i]) if load is not None else 0.0, i))
        if not order:
            order = list(range(len(self.ma)))
        return [order[i % len(order)] for i in range(n)]


def plan_mitigation(job_id: int, task_ids: list[int], task_hosts: list[int],
                    deadline_oriented: bool, ma: StragglerMovingAverage,
                    load: np.ndarray | None = None) -> list[Action]:
    """Algorithm 1 lines 26-32: mitigate the remaining tasks of a job.

    Deadline-oriented jobs get SPECULATE; others RERUN. Each task goes to a
    distinct low-straggler host when possible, avoiding its current host.
    """
    kind = Kind.SPECULATE if deadline_oriented else Kind.RERUN
    actions = []
    targets = ma.pick_targets(len(task_ids), exclude=set(task_hosts),
                              load=load)
    for t, (tid, src) in enumerate(zip(task_ids, task_hosts)):
        actions.append(Action(job_id=job_id, task_id=tid, kind=kind,
                              target_host=targets[t], source_host=src))
    return actions
