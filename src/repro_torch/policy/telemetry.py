"""Frozen telemetry snapshots — the only cluster state policies may read
(a copy of the JAX package's).

A substrate (the cloud simulator, the training-pod runtime) publishes a
:class:`TelemetryView` at every decision point; policies consume the
view and emit
:class:`~repro_torch.policy.actions.Action`s.  Views
are built **zero-copy**: every array field is a read-only numpy view onto
the substrate's live buffers, so taking a snapshot costs a few dataclass
allocations, never an O(tasks) copy.  A view is therefore only valid for
the duration of the hook call it was passed to — policies that need
history must copy what they keep (`.copy()` re-enables writing).

Task-state constants live here (not in the engine) so policies can test
``view.tasks.state == RUNNING`` without importing simulator internals.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np

# task lifecycle states (shared by the engine's TaskTable and every view)
PENDING, RUNNING, DONE, CANCELLED = 0, 1, 2, 3

#: submit-time decision point (new tasks just arrived, none placed yet)
EVENT_SUBMIT = "submit"
#: interval decision point (faults applied, placements done, pre-progress)
EVENT_INTERVAL = "interval"


def readonly(a: np.ndarray) -> np.ndarray:
    """Read-only view of ``a`` (zero-copy; the base stays writable)."""
    v = a.view()
    v.flags.writeable = False
    return v


def effective_speed(util: np.ndarray, speed: np.ndarray,
                    online: np.ndarray) -> np.ndarray:
    """Per-host progress rate from utilization: base speed degraded by
    (a) CPU overload (processor sharing: capacity share = 1/overload) and
    (b) interference once any resource runs hot (>70% — cache/IO
    contention), zero while the host is down.  Shared by the simulator's
    ``Cluster`` and every :class:`HostTelemetry` so both substrates agree
    on what "effective speed" means."""
    over = np.maximum(util[:, 0], 1.0)
    hot = np.clip((util.max(axis=1) - 0.7) / 0.3, 0.0, 1.0)
    interference = 1.0 - 0.4 * hot
    return np.where(online, speed * interference / over, 0.0)


@dataclasses.dataclass(frozen=True)
class TaskTelemetry:
    """Struct-of-arrays snapshot of every task the substrate tracks.

    All arrays have length ``n`` and are read-only views; ``req`` is
    ``(n, 4)`` normalized resource requirements (cpu/ram/disk/bw).
    """

    n: int
    job_id: np.ndarray
    state: np.ndarray
    host: np.ndarray            # -1 while unplaced
    work: np.ndarray            # MI (sim) / normalized work units (pod)
    progress: np.ndarray
    submit_s: np.ndarray
    start_s: np.ndarray
    finish_s: np.ndarray        # -1 until done
    deadline_s: np.ndarray      # relative to submit
    is_deadline: np.ndarray
    sla_weight: np.ndarray
    restarts: np.ndarray
    is_copy: np.ndarray
    orig: np.ndarray            # original task id for copies, else -1
    delayed_until: np.ndarray   # interval index a DELAY holds until
    prev_host: np.ndarray       # host before the last restart/bounce, -1
    req: np.ndarray

    def active_mask(self) -> np.ndarray:
        return self.state == RUNNING

    def originals_mask(self) -> np.ndarray:
        return ~self.is_copy


@dataclasses.dataclass(frozen=True)
class HostTelemetry:
    """Per-host capacity and load counters (read-only views)."""

    util: np.ndarray            # (n_hosts, 4) fraction of capacity
    speed: np.ndarray           # relative CPU capacity
    cap: np.ndarray             # (n_hosts, 4) absolute capacities
    cost: np.ndarray
    power_max: np.ndarray
    power_min: np.ndarray
    n_tasks: np.ndarray
    downtime: np.ndarray        # intervals of outage remaining (0 = up)
    ips: np.ndarray             # MI/s per unit speed

    def online(self) -> np.ndarray:
        return self.downtime == 0

    def effective_speed(self) -> np.ndarray:
        return effective_speed(self.util, self.speed, self.online())


@dataclasses.dataclass(frozen=True)
class JobTelemetry:
    """CSR job -> task index plus per-job flags.

    Jobs are dense integer ids; job ``j``'s original tasks occupy the
    contiguous task-id range ``[start[j], start[j] + count[j])`` (the
    substrate appends whole jobs in submission order, and speculative
    copies are tracked separately).  Every field is an array indexed by
    job id, so ``active()`` and per-job lookups are O(1) array slices,
    never per-interval Python scans over a dict.
    """

    start: np.ndarray        # (n_jobs,) first original-task id
    count: np.ndarray        # (n_jobs,) original-task count (the paper's q)
    open_count: np.ndarray   # (n_jobs,) non-terminal original count
    done: np.ndarray         # (n_jobs,) bool: fully accounted
    deadline: np.ndarray     # (n_jobs,) bool: deadline-oriented?
    _state: np.ndarray       # task state array (shared with tasks)

    @property
    def n_jobs(self) -> int:
        return len(self.start)

    def task_ids(self, job: int) -> np.ndarray:
        """Original-task ids of ``job`` (contiguous CSR range)."""
        s = int(self.start[job])
        return np.arange(s, s + int(self.count[job]), dtype=np.int64)

    def active(self) -> np.ndarray:
        """Jobs with at least one non-terminal original task."""
        return np.nonzero((self.open_count > 0) & ~self.done)[0]

    def incomplete_tasks(self, job: int) -> np.ndarray:
        t = self.task_ids(job)
        # PENDING/RUNNING are the two non-terminal states (0 and 1)
        return t[self._state[t] <= RUNNING]


@dataclasses.dataclass(frozen=True)
class TelemetryView:
    """Everything a policy may observe, at one decision point.

    ``event`` distinguishes the simulator's two decision points
    (:data:`EVENT_SUBMIT` with ``new_tasks`` populated, and
    :data:`EVENT_INTERVAL`); the distributed runtime publishes one
    :data:`EVENT_INTERVAL` view per training step.  ``config`` is the
    substrate's (frozen-by-convention) configuration object —
    ``SimConfig`` for the simulator, ``RuntimeConfig`` for the pod.

    ``rng`` is the substrate's *live* generator: randomized policies draw
    from the same stream the engine uses, which is what keeps a sweep
    cell a pure function of its spec.

    ``extra`` carries substrate-specific telemetry (e.g. the pod
    runtime's raw per-step times); portable policies should not rely on
    its contents.
    """

    event: str
    t: int                         # interval / step index
    now_s: float
    interval_seconds: float
    config: Any
    tasks: TaskTelemetry
    hosts: HostTelemetry
    jobs: JobTelemetry
    new_tasks: np.ndarray          # task ids submitted this event
    straggler_ma: np.ndarray       # per-host straggler moving average
    completed_jobs: Sequence[Mapping]  # ground-truth job records
    util_history: Sequence[np.ndarray]
    rng: np.random.Generator | None = None
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    # convenience passthroughs (the fields policies reach for constantly)

    @property
    def n_hosts(self) -> int:
        return len(self.hosts.speed)

    @property
    def host_ips_mean(self) -> float:
        return float(self.config.host_ips_mean)


def make_task_telemetry(n: int, fields: Callable[[str], np.ndarray],
                        req: np.ndarray) -> TaskTelemetry:
    """Assemble a :class:`TaskTelemetry` from a field accessor (the
    engine passes its TaskTable's ``view``), wrapping each array
    read-only."""
    return TaskTelemetry(
        n=n, req=readonly(req),
        **{f: readonly(fields(f)) for f in (
            "job_id", "state", "host", "work", "progress", "submit_s",
            "start_s", "finish_s", "deadline_s", "is_deadline",
            "sla_weight", "restarts", "is_copy", "orig", "delayed_until",
            "prev_host")})
