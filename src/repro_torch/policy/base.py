"""Policy protocol: the decision-logic side of the seam (a copy of the
JAX package's).

A policy never touches a substrate's internals — it reads a
:class:`~repro_torch.policy.telemetry.TelemetryView` and returns
:class:`~repro_torch.policy.actions.Action`s; the port's substrate is its
cloud simulator (``repro_torch.sim``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Protocol, runtime_checkable

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.policy.actions import Action
    from repro_torch.policy.registry import PretrainContext
    from repro_torch.policy.telemetry import TelemetryView


class Policy:
    """Base class for straggler prediction/mitigation policies.

    Substrates call, per interval (simulator) or per step (pod runtime):

    * ``observe(view)`` — once, before any decision, with an
      ``EVENT_INTERVAL`` view: ingest telemetry, update internal models.
    * ``decide(view)`` — at every decision point (the simulator also
      publishes an ``EVENT_SUBMIT`` view right after arrivals): return
      mitigation actions.  Policies that only act at one decision point
      filter on ``view.event``.
    """

    name = "policy"

    #: Set False on policies that never act at submit time: the simulator
    #: then skips building the EVENT_SUBMIT view (and the decide call)
    #: entirely — the view is pure and an ignoring decide() is pure, so
    #: skipping is behavior-preserving and saves per-interval overhead.
    submit_hook = True

    def observe(self, view: "TelemetryView") -> None:
        """Ingest one interval/step of telemetry."""

    def decide(self, view: "TelemetryView") -> "list[Action]":
        """Return mitigation actions for this decision point."""
        return []

    def predicted_straggler_count(self) -> float | None:
        """Latest predicted straggler count, for MAPE accounting (Fig 9);
        ``None`` when the policy does not predict."""
        return None

    def forget_tasks(self, task_ids) -> None:
        """Substrate signal: these task ids no longer refer to the work
        previously observed — drop any per-task state (histories,
        once-only mitigation flags).  The simulator never reuses ids, so
        it never calls this; the pod runtime reuses one id per host each
        horizon window and calls it at every window boundary."""


@runtime_checkable
class Pretrainable(Protocol):
    """Optional protocol: policies that need offline pretraining.

    A class implementing ``pretrain`` (normally a classmethod) is picked
    up automatically by :func:`repro_torch.policy.registry.register`, and sweep
    runners call it through the registry entry — no per-name dispatch
    anywhere.
    """

    @classmethod
    def pretrain(cls, ctx: "PretrainContext") -> "Policy":
        """Build a trained policy instance for ``ctx.config``."""
        ...
