"""Prediction-as-a-service over the fused START decision step, on the
port's predictor (the JAX package's ``repro.service``).

A long-running daemon that answers telemetry snapshots with E_S
predictions, per-task straggler scores and mitigation actions, batching
many small tenant clusters into one device dispatch, with versioned
continuous retraining gated by shadow evaluation.  Its predictors live
on ``ServiceConfig.device``, the card unless the caller asks for the
CPU; the wire is the JAX service's, so clients of either package talk
to daemons of either.
"""
from repro_torch.service.core import (PredictionService, ServiceConfig,
                                      TenantState)
from repro_torch.service.daemon import (LocalClient, ServiceClient,
                                        ServiceDaemon)
from repro_torch.service.protocol import Profile
from repro_torch.service.sanitize import TelemetryError, sanitize_snapshot

__all__ = [
    "PredictionService", "ServiceConfig", "TenantState",
    "ServiceDaemon", "LocalClient", "ServiceClient",
    "Profile", "TelemetryError", "sanitize_snapshot",
]
