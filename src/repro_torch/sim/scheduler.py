"""VM/task scheduling policies (paper §4.5).

The paper uses A3C-R2N2 (an RL policy) as the *common* scheduler beneath all
straggler techniques; since the scheduler is shared, any fixed policy
preserves the technique comparison. We provide a deterministic
utilization-aware scorer (stand-in, see DESIGN.md deviations) and the random
scheduler the paper uses to generate diverse training data (§4.4).

``place_batch`` is the engine's hot path: it places every ready task of an
interval in one call (including the down-host fallback the engine used to
apply per task) and must be *bitwise-equal* to calling ``place``
sequentially — the deterministic scorer vectorizes the loop, while the
base-class fallback preserves per-task RNG draw order for randomized
schedulers.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sim.cluster import Cluster


class Scheduler:
    name = "base"

    def place(self, cluster: Cluster, req: np.ndarray,
              rng: np.random.Generator,
              exclude: int | None = None) -> int:
        raise NotImplementedError

    def place_batch(self, cluster: Cluster, reqs: np.ndarray,
                    rng: np.random.Generator,
                    exclude: np.ndarray | None = None) -> np.ndarray:
        """Place ``reqs[i]`` for every i, in order.

        ``exclude`` is a per-task host id to avoid (-1 = none).  A task
        whose chosen host is down is immediately re-placed without the
        exclusion — the engine's historical per-task fallback — so RNG
        draw order matches the sequential loop exactly.
        """
        out = np.empty(len(reqs), np.int64)
        for i, req in enumerate(reqs):
            ex = (int(exclude[i])
                  if exclude is not None and exclude[i] >= 0 else None)
            host = self.place(cluster, req, rng, exclude=ex)
            if cluster.downtime[host] > 0:
                host = self.place(cluster, req, rng)
            out[i] = host
        return out


class UtilizationAwareScheduler(Scheduler):
    """Least projected-load placement with task-count tie-break."""

    name = "util-aware"

    def place(self, cluster, req, rng, exclude=None):
        online = cluster.online()
        if exclude is not None and online.sum() > 1:
            online = online.copy()
            online[exclude] = False
        proj = cluster.util + req[None, :]
        score = proj.max(axis=1) + 0.05 * cluster.n_tasks \
            - 0.1 * cluster.speed
        score = np.where(online, score, np.inf)
        best = int(np.argmin(score))
        return best

    def place_batch(self, cluster, reqs, rng, exclude=None):
        """Vectorized twin of the sequential loop (no RNG, no cross-task
        state): one (tasks, hosts) score matrix, per-task exclusion, and
        the down-host fallback applied as a masked second argmin."""
        if len(reqs) == 0:
            return np.zeros(0, np.int64)
        online = cluster.online()
        # identical float op order to ``place``: (max + a) - b per host
        proj = (cluster.util[None, :, :] + reqs[:, None, :]).max(axis=2)
        score = proj + 0.05 * cluster.n_tasks - 0.1 * cluster.speed
        score = np.where(online[None, :], score, np.inf)
        if exclude is not None and online.sum() > 1:
            excl_rows = np.nonzero(np.asarray(exclude) >= 0)[0]
            if excl_rows.size:
                sc = score.copy()
                sc[excl_rows, np.asarray(exclude)[excl_rows]] = np.inf
                best = np.argmin(sc, axis=1)
            else:
                best = np.argmin(score, axis=1)
        else:
            best = np.argmin(score, axis=1)
        down = cluster.downtime[best] > 0
        if down.any():  # down-host fallback: re-place without the exclusion
            best[down] = np.argmin(score[down], axis=1)
        return best.astype(np.int64)


class RandomScheduler(Scheduler):
    """Uniform-random placement over online hosts (training-data generator,
    paper §4.4: 'a scheduler that selects tasks at random and schedules them
    randomly to any host using a uniform distribution').

    Uses the base-class sequential ``place_batch``: each placement draws
    from the shared RNG stream, so batching must preserve call order.
    """

    name = "random"

    def place(self, cluster, req, rng, exclude=None):
        online = np.nonzero(cluster.online())[0]
        if exclude is not None and len(online) > 1:
            online = online[online != exclude]
        if len(online) == 0:
            return int(rng.integers(0, cluster.n))
        return int(rng.choice(online))
