"""RPPS [23]: ARIMA-style resource prediction and provisioning (used by the
paper only for the MAPE prediction-accuracy comparison, Fig. 9); a copy
of the JAX package's ``repro.sim.techniques.rpps``.

We implement the AR core of ARIMA: an online least-squares AR(p) model over
the per-interval observed straggler-completion counts, forecasting the next
interval's count. No mitigation (the original is a provisioning scheme)."""
from __future__ import annotations

import numpy as np

from repro_torch.policy import (Action, EVENT_INTERVAL, Policy, TelemetryView,
                          register)


@register("rpps", description="online AR(p) forecast of straggler counts; "
                              "prediction only, no mitigation [23]")
class RPPS(Policy):
    name = "rpps"

    def __init__(self, order: int = 3):
        self.order = order
        self.history: list[float] = []
        self._last_pred: float | None = None

    def _observed_straggler_count(self, view: TelemetryView) -> float:
        """Stragglers among jobs completed in the last interval (observable
        online, one interval late)."""
        cnt = 0.0
        for rec in view.completed_jobs:
            if rec["t"] == view.t:
                cnt += float(rec["straggler"].sum())
        return cnt

    def observe(self, view: TelemetryView) -> None:
        self.history.append(self._observed_straggler_count(view))

    def decide(self, view: TelemetryView) -> list[Action]:
        if view.event != EVENT_INTERVAL:
            return []
        h = np.array(self.history, float)
        p = self.order
        if len(h) <= p + 2:
            self._last_pred = float(h.mean()) if len(h) else 0.0
            return []
        X = np.stack([h[i:len(h) - p + i] for i in range(p)], 1)
        y = h[p:]
        A = np.concatenate([X, np.ones((len(X), 1))], 1)
        sol, *_ = np.linalg.lstsq(A, y, rcond=None)
        nxt = np.concatenate([h[-p:], [1.0]])
        self._last_pred = float(max(nxt @ sol, 0.0))
        return []

    def predicted_straggler_count(self):
        return self._last_pred
