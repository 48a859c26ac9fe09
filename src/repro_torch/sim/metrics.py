"""QoS metrics (paper §4.1, Eqs. 6-14), recorded per interval + summarized."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MetricsLog:
    energy_w: list = dataclasses.field(default_factory=list)
    contention: list = dataclasses.field(default_factory=list)
    util_cpu: list = dataclasses.field(default_factory=list)
    util_ram: list = dataclasses.field(default_factory=list)
    util_disk: list = dataclasses.field(default_factory=list)
    util_bw: list = dataclasses.field(default_factory=list)
    active_tasks: list = dataclasses.field(default_factory=list)
    predicted_stragglers: list = dataclasses.field(default_factory=list)
    overhead_s: list = dataclasses.field(default_factory=list)

    def record_interval(self, cluster, contention: float,
                        active: int, predicted: float | None,
                        overhead_s: float) -> None:
        self.energy_w.append(cluster.energy())
        self.contention.append(contention)
        u = cluster.util.mean(axis=0) * 100.0
        self.util_cpu.append(float(u[0]))
        self.util_ram.append(float(u[1]))
        self.util_disk.append(float(u[2]))
        self.util_bw.append(float(u[3]))
        self.active_tasks.append(active)
        self.predicted_stragglers.append(
            float(predicted) if predicted is not None else np.nan)
        self.overhead_s.append(overhead_s)


def contention_metric(cluster, task_req: np.ndarray, task_host: np.ndarray,
                      active: np.ndarray) -> float:
    """Eq. 9: sum over hosts/tasks of req * 1(resource overloaded)."""
    if not active.any():
        return 0.0
    over = cluster.overloaded()  # (n, 4)
    hosts = task_host[active]
    reqs = task_req[active]
    return float((reqs * over[hosts]).sum())


def summarize(log: MetricsLog, tasks: "object", interval_s: float,
              restart_overhead_s: float) -> dict:
    """Summary dict with the paper's headline QoS numbers.

    ``tasks`` is the engine's TaskTable (read-only access).
    """
    n = tasks.n
    state = tasks.view("state")
    is_copy = tasks.view("is_copy")
    finish_s = tasks.view("finish_s")
    submit_s = tasks.view("submit_s")
    deadline_s = tasks.view("deadline_s")
    restarts = tasks.view("restarts")
    sla_weight = tasks.view("sla_weight")
    done = state == 2
    orig = ~is_copy
    d = done & orig
    exec_t = np.where(finish_s > 0, finish_s - submit_s, np.nan)
    # Eq. 8: avg completion-submission + restart overheads
    avg_exec = float(np.nanmean(np.where(d, exec_t, np.nan))) if d.any() \
        else 0.0
    avg_restart = float(restarts[d].mean()
                        * restart_overhead_s) if d.any() else 0.0
    # Eq. 13: weighted SLA violation rate over originals (undone past-
    # deadline tasks count as violated)
    violated = np.zeros(n, bool)
    violated[d] = exec_t[d] > deadline_s[d]
    undone = orig & ~done
    violated[undone] = True
    wsum = sla_weight[orig].sum()
    sla = float((sla_weight[orig] * violated[orig]).sum()
                / max(wsum, 1e-9))
    energy_kwh = float(np.sum(log.energy_w) * interval_s / 3.6e6)
    del n
    return {
        "tasks_done": int(d.sum()),
        "tasks_total": int(orig.sum()),
        "avg_execution_time_s": avg_exec + avg_restart,
        "energy_kwh": energy_kwh,
        "resource_contention": float(np.mean(log.contention))
        if log.contention else 0.0,
        "sla_violation_rate": sla,
        "cpu_util_pct": float(np.mean(log.util_cpu)),
        "ram_util_pct": float(np.mean(log.util_ram)),
        "disk_util_pct": float(np.mean(log.util_disk)),
        "bw_util_pct": float(np.mean(log.util_bw)),
        "avg_overhead_s": float(np.mean(log.overhead_s))
        if log.overhead_s else 0.0,
    }


def mape(actual: np.ndarray, predicted: np.ndarray) -> float:
    """Eq. 14 over intervals with nonzero actuals."""
    actual = np.asarray(actual, float)
    predicted = np.asarray(predicted, float)
    ok = np.isfinite(predicted) & (actual > 0)
    if not ok.any():
        return float("nan")
    return float(100.0 * np.mean(
        np.abs((actual[ok] - predicted[ok]) / actual[ok])))
