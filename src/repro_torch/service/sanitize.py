"""Service-boundary telemetry sanitizer (a copy of the JAX package's
``repro.service.sanitize``, numpy only).

A multi-tenant daemon shares one batch (and one process) across tenants,
so one malformed snapshot must never poison another tenant's answers or
crash the tick loop.  This is the network-boundary mirror of the
controller-side ``STARTController._sanitize_es`` guard: that one
protects the trigger from a degenerate *prediction*; this one protects
the predictor from degenerate *telemetry*.

Two modes, chosen per server (``ServiceConfig.sanitize``):

  * ``"clamp"`` (default): non-finite features -> 0.0 and magnitudes
    clipped to ``FEATURE_CLIP``; non-positive / non-finite durations are
    dropped from ``done`` records.  The snapshot is answered normally
    and the response lists what was repaired under ``"sanitized"``.
  * ``"reject"``: the same conditions fail the snapshot with a
    :class:`TelemetryError` instead of repairing it.

Structural violations — wrong matrix shapes, q outside [1, max_tasks],
task slots outside the matrix, a non-monotonic interval stamp — are
rejected in BOTH modes: there is no meaningful repair, and silently
reordering a tenant's timeline would corrupt its server-side history.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core import features

#: clamp bound for repaired feature magnitudes (normalized features are
#: O(1); anything huge is garbage but must not overflow float32 math)
FEATURE_CLIP = 1e6


class TelemetryError(ValueError):
    """A snapshot the service refuses to process; ``code`` is the wire
    error code the tenant gets back."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


def _clean_block(arr, shape: tuple, what: str, mode: str,
                 issues: list[str]) -> np.ndarray:
    """Shape-check + finite-check one feature block."""
    a = np.asarray(arr, dtype=np.float32)
    if a.size != int(np.prod(shape)):
        raise TelemetryError(
            "bad-shape", f"{what}: expected {shape} "
            f"({int(np.prod(shape))} values), got {a.size}")
    a = a.reshape(shape)
    bad = ~np.isfinite(a)
    if bad.any():
        if mode == "reject":
            raise TelemetryError(
                "bad-telemetry", f"{what}: {int(bad.sum())} non-finite "
                f"feature(s)")
        a = np.where(bad, np.float32(0.0), a)
        issues.append(f"{what}: zeroed {int(bad.sum())} non-finite")
    big = np.abs(a) > FEATURE_CLIP
    if big.any():
        if mode == "reject":
            raise TelemetryError(
                "bad-telemetry", f"{what}: {int(big.sum())} feature(s) "
                f"beyond +-{FEATURE_CLIP:g}")
        a = np.clip(a, -FEATURE_CLIP, FEATURE_CLIP)
        issues.append(f"{what}: clipped {int(big.sum())} oversized")
    return a


def sanitize_snapshot(snap: dict, profile, last_seq: float,
                      mode: str = "clamp") -> dict:
    """Validate + repair one snapshot request against a tenant profile.

    Returns ``{"seq", "m_h", "jobs", "done", "issues"}`` with numpy
    feature blocks, or raises :class:`TelemetryError`.  ``jobs`` entries
    are ``{"id", "q", "m_t", "open", "deadline", "tasks"}`` with
    ``tasks`` as ``(tids, hosts, slots)`` int arrays.
    """
    issues: list[str] = []
    seq = snap.get("seq")
    if not isinstance(seq, (int, float)) or isinstance(seq, bool) \
            or not math.isfinite(seq):
        raise TelemetryError("bad-seq", f"non-numeric seq {seq!r}")
    if seq <= last_seq:
        raise TelemetryError(
            "out-of-order", f"seq {seq} <= last processed {last_seq}")
    m_h = _clean_block(snap.get("m_h", ()),
                       (profile.n_hosts, features.HOST_FEATURES),
                       "m_h", mode, issues)
    jobs = []
    for j in snap.get("jobs") or ():
        jid = j.get("id")
        if not isinstance(jid, int) or isinstance(jid, bool):
            raise TelemetryError("bad-job", f"non-integer job id {jid!r}")
        q = j.get("q")
        if not isinstance(q, (int, float)) or isinstance(q, bool) \
                or not math.isfinite(q) or not 1 <= q <= profile.max_tasks:
            raise TelemetryError(
                "bad-job", f"job {jid}: q={q!r} outside "
                f"[1, {profile.max_tasks}]")
        m_t = _clean_block(j.get("m_t", ()),
                           (profile.max_tasks, features.TASK_FEATURES),
                           f"job {jid} m_t", mode, issues)
        tids, hosts, slots = [], [], []
        for ent in j.get("tasks") or ():
            t, h, s = (int(ent[0]), int(ent[1]), int(ent[2]))
            if not 0 <= s < profile.max_tasks:
                raise TelemetryError(
                    "bad-job", f"job {jid}: task {t} slot {s} outside "
                    f"[0, {profile.max_tasks})")
            tids.append(t)
            hosts.append(h)
            slots.append(s)
        open_count = j.get("open", int(q))
        if not isinstance(open_count, int) or isinstance(open_count, bool):
            raise TelemetryError(
                "bad-job", f"job {jid}: non-integer open {open_count!r}")
        jobs.append({
            "id": int(jid), "q": float(q), "m_t": m_t,
            "open": max(0, open_count),
            "deadline": bool(j.get("deadline", False)),
            "tasks": (np.asarray(tids, np.int64),
                      np.asarray(hosts, np.int64),
                      np.asarray(slots, np.int64)),
        })
    done = []
    for d in snap.get("done") or ():
        did = d.get("id")
        if not isinstance(did, int) or isinstance(did, bool):
            raise TelemetryError("bad-done",
                                 f"non-integer done id {did!r}")
        times = np.asarray(d.get("times", ()), np.float32)
        bad = (~np.isfinite(times)) | (times <= 0.0)
        if bad.any():
            if mode == "reject":
                raise TelemetryError(
                    "bad-telemetry", f"done {did}: {int(bad.sum())} "
                    f"non-positive/non-finite duration(s)")
            issues.append(f"done {did}: dropped {int(bad.sum())} "
                          f"bad duration(s)")
            times = times[~bad]
        if times.size:
            done.append({"id": int(did), "times": times})
        elif mode == "clamp":
            issues.append(f"done {did}: dropped (no valid durations)")
    return {"seq": float(seq), "m_h": m_h, "jobs": jobs, "done": done,
            "issues": issues}
