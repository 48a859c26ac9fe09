"""Deterministic fault injection for the service's transport, copied from
the JAX package's ``repro.chaos`` (stdlib only; the port imports nothing
of ``repro``).

  * :class:`~repro_torch.chaos.proxy.ChaosProxy` — an in-process TCP proxy
    that sits between a client and an upstream server and injects
    drop / delay / duplicate / truncate / corrupt / reset-mid-frame
    faults per direction, driven by seeded per-stream RNGs (plus
    optional exact per-chunk scripts), recording the realized fault
    schedule as a JSON artifact for replay and bug reports;
  * :class:`~repro_torch.chaos.clock.SkewClock` — an injectable monotonic
    clock with controllable skew, for driving wall-clock retrain timers
    (``RetrainScheduler(clock=...)``) without real sleeps.

The drills in ``tests/test_torch_chaos.py`` use both to hold the
service's invariant: a tenant survives a daemon kill-and-restart and
reply corruption mid-stream with no snapshot applied twice.
"""
from repro_torch.chaos.clock import SkewClock
from repro_torch.chaos.proxy import ChaosProxy, FaultPlan

__all__ = ["ChaosProxy", "FaultPlan", "SkewClock"]
