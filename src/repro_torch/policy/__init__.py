"""Unified policy API, copied from the JAX package's ``repro.policy``
(which the port does not import): one decision seam.

Straggler techniques are *policies*: they read a frozen
:class:`TelemetryView` snapshot (tasks, hosts, jobs, clocks — never
engine internals) and emit :class:`Action`s from one shared vocabulary.
Two substrates publish the views and execute the actions: the port's
cloud simulator (``repro_torch.sim``) and its training-pod runtime
(``repro_torch.distributed.straggler_runtime``).  A technique registers
with :func:`register`; policies that need offline training implement
the :class:`Pretrainable` protocol (a ``pretrain(ctx)`` classmethod that
forwards ``ctx.kwargs`` to the constructor), and the registry entry
carries it.

The simulator's techniques register when ``repro_torch.sim.techniques``
is imported, the pod runtime's four ``start-pod*`` policies when
``repro_torch.distributed.straggler_runtime`` is; as in the JAX package,
a name whose module was not imported is unknown.
"""
from repro_torch.policy.actions import (Action, ActionKind, HOST_KINDS,
                                        TASK_KINDS, host_action)
from repro_torch.policy.base import Policy, Pretrainable
from repro_torch.policy import registry
from repro_torch.policy.registry import (PolicyEntry, PretrainContext,
                                         PretrainSpec, UnknownPolicyError,
                                         get, make, names, register,
                                         unregister, validate)
from repro_torch.policy.telemetry import (CANCELLED, DONE, EVENT_INTERVAL,
                                          EVENT_SUBMIT, PENDING, RUNNING,
                                          HostTelemetry, JobTelemetry,
                                          TaskTelemetry, TelemetryView,
                                          effective_speed, readonly)

__all__ = [
    "Action", "ActionKind", "HOST_KINDS", "TASK_KINDS", "host_action",
    "Policy", "Pretrainable",
    "PolicyEntry", "PretrainContext", "PretrainSpec",
    "UnknownPolicyError", "get", "make", "names", "register",
    "unregister", "validate", "registry",
    "PENDING", "RUNNING", "DONE", "CANCELLED",
    "EVENT_SUBMIT", "EVENT_INTERVAL",
    "TaskTelemetry", "HostTelemetry", "JobTelemetry", "TelemetryView",
    "effective_speed", "readonly",
]
