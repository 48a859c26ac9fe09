"""Feature extractor (paper §3.2, Fig. 3): host matrix M_H, task matrix M_T.

Host features (m = 11 per host): utilization and capacity of CPU, RAM, disk
and network bandwidth, plus cost, (max) power and the number of tasks
currently allocated — exactly the set listed in the paper.

Task features (p = 5 per task): CPU, RAM, disk and bandwidth *requirements*
plus the host assigned in the previous interval (normalized index; -1 -> 0
for unassigned). Jobs with q < q' tasks are padded with zero rows (paper:
"if less than q' tasks then rest q'-q rows are 0").

The ``*_np`` functions build the matrices in numpy for the simulator (the same
float32 arithmetic as the torch twins); the torch functions keep the
device of their tensor inputs.
"""
from __future__ import annotations

import numpy as np
import torch

HOST_FEATURES = 11
TASK_FEATURES = 5


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def host_matrix(util, cap, cost, power_max, n_tasks) -> torch.Tensor:
    """Build M_H.

    Args:
        util: (n, 4) utilization in [0,1] for cpu/ram/disk/bw.
        cap:  (n, 4) capacities (absolute units).
        cost: (n,) price per interval.
        power_max: (n,) watts at full load.
        n_tasks: (n,) tasks currently placed on each host.

    Returns: (n, HOST_FEATURES) float32, capacities normalized per column.
    """
    cap = _f32(cap)
    cap_n = cap / torch.clamp_min(cap.amax(dim=0, keepdim=True), 1e-8)
    cost = _f32(cost)
    cost_n = cost / torch.clamp_min(cost.max(), 1e-8)
    p = _f32(power_max)
    p_n = p / torch.clamp_min(p.max(), 1e-8)
    nt = _f32(n_tasks)
    nt_n = nt / torch.clamp_min(nt.max(), 1.0)
    return torch.cat([_f32(util), cap_n, cost_n[:, None], p_n[:, None],
                      nt_n[:, None]], dim=-1)


def host_matrix_np(util: np.ndarray, cap: np.ndarray, cost: np.ndarray,
                   power_max: np.ndarray, n_tasks: np.ndarray) -> np.ndarray:
    """M_H in NumPy: the float32 arithmetic of
    :func:`host_matrix` (every op an exact IEEE elementwise op or
    reduction)."""
    util = np.asarray(util, np.float32)
    cap = np.asarray(cap, np.float32)
    cap_n = cap / np.maximum(cap.max(axis=0, keepdims=True),
                             np.float32(1e-8))
    cost = np.asarray(cost, np.float32)
    cost_n = cost / np.maximum(cost.max(), np.float32(1e-8))
    p = np.asarray(power_max, np.float32)
    p_n = p / np.maximum(p.max(), np.float32(1e-8))
    nt = np.asarray(n_tasks, np.float32)
    nt_n = nt / np.maximum(nt.max(), np.float32(1.0))
    return np.concatenate(
        [util, cap_n, cost_n[:, None], p_n[:, None], nt_n[:, None]],
        axis=-1)


def task_matrix_batch_np(req: np.ndarray, prev_host: np.ndarray,
                         rows: np.ndarray, cols: np.ndarray, n_jobs: int,
                         n_hosts: int, max_tasks: int) -> np.ndarray:
    """Batched NumPy :func:`task_matrix`: one scatter fills
    every job's (max_tasks, TASK_FEATURES) matrix.

    Args:
        req: (total_tasks, 4) requirement rows, all jobs concatenated.
        prev_host: (total_tasks,) previous-interval host per row, -1 none.
        rows: (total_tasks,) destination job index of each row.
        cols: (total_tasks,) destination row within the job (0..q-1).
        n_jobs: number of output matrices.
        n_hosts, max_tasks: normalization / padding as in `task_matrix`.
    """
    mt = np.zeros((n_jobs, max_tasks, TASK_FEATURES), np.float32)
    if len(rows):
        mt[rows, cols, :4] = np.asarray(req, np.float32)
        mt[rows, cols, 4] = ((np.asarray(prev_host, np.float32)
                              + np.float32(1.0)) / np.float32(n_hosts))
    return mt


def task_matrix(req, prev_host, n_hosts: int,
                max_tasks: int) -> torch.Tensor:
    """Build M_T for one job, padded to (max_tasks, TASK_FEATURES).

    Args:
        req: (q, 4) resource requirements (cpu/ram/disk/bw) in [0,1].
        prev_host: (q,) host index of the previous interval, -1 if none.
        n_hosts: for normalizing the host index.
        max_tasks: q' — pad rows beyond q with zeros.
    """
    req = _f32(req)
    q = req.shape[0]
    ph = (_f32(prev_host) + 1.0) / float(n_hosts)
    mt = torch.cat([req, ph[:, None]], dim=-1)
    pad = max(0, max_tasks - q)
    return torch.nn.functional.pad(mt, (0, 0, 0, pad))[:max_tasks]


def flatten_inputs(m_h: torch.Tensor, m_t: torch.Tensor) -> torch.Tensor:
    """Flatten + concatenate (M_H, M_T) into the encoder input vector.

    Supports leading batch/time dims on either matrix as long as they match.
    """
    lead_h = m_h.shape[:-2]
    lead_t = m_t.shape[:-2]
    if lead_h != lead_t:
        raise ValueError(f"leading dims differ: {lead_h} vs {lead_t}")
    return torch.cat([m_h.reshape(*lead_h, -1), m_t.reshape(*lead_t, -1)],
                     dim=-1)


def input_dim(n_hosts: int, max_tasks: int) -> int:
    return n_hosts * HOST_FEATURES + max_tasks * TASK_FEATURES
