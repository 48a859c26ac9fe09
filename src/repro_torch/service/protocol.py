"""Wire protocol for the prediction service (a copy of the JAX package's
``repro.service.protocol``; the two packages speak the same wire).

Transport is JSON-lines: one JSON object per ``\\n``-terminated line,
UTF-8, over TCP or any file-like pair.  This is deliberately stdlib-only
(``json`` + ``socket``) — the service must not pull in dependencies the
simulator does not already have.

Requests carry an ``op``:

  * ``hello``    — admission: tenant id + :class:`Profile`; the server
    accepts iff the profile is compatible with the one it serves.
  * ``snapshot`` — one telemetry interval (see
    :func:`repro_torch.policy.wire.snapshot_to_wire`); answered with E_S per
    job, per-task scores (eager profiles), mitigation actions, and the
    serving model version.
  * ``stats``    — server counters (tenants, ticks, sheds, retraces...).
  * ``retrain``  — force one retrain/shadow-eval/promote cycle now.
  * ``rollback`` — demote the current model version to its predecessor.
  * ``bye``      — drop the tenant's server-side state.

Responses are ``{"ok": true, ...}`` or
``{"ok": false, "error": code, "detail": msg}``.

``json.dumps`` keeps Python's ``allow_nan`` default on purpose: tenants
*can* transmit NaN/Infinity telemetry, and rejecting or repairing it is
the sanitizer's job on the server side, not the transport's.  Finite
float32 values survive the float64 JSON round trip losslessly, which is
what makes the single-tenant bitwise guarantee hold over TCP.
"""
from __future__ import annotations

import dataclasses
import json

#: profile fields that must match exactly between tenant and server —
#: they select the compiled program family and the Pareto constants.
_STRICT = ("n_hosts", "max_tasks", "horizon", "k", "beta_scale",
           "trigger", "score_on", "hysteresis", "cooldown")


@dataclasses.dataclass(frozen=True)
class Profile:
    """The model/controller shape a tenant expects the service to run.

    A service process serves exactly one profile (one compiled program
    family, one shared parameter pytree); admission control rejects a
    tenant whose profile disagrees, because batching its rows into the
    shared dispatch would silently answer with the wrong model.
    """

    n_hosts: int
    max_tasks: int
    horizon: int = 5
    k: float = 1.5
    beta_scale: float = 1.0
    trigger: str = "milestone"       # "milestone" | "per_task"
    score_on: float = 0.0            # per-task trigger knobs
    hysteresis: int = 2
    cooldown: int = 5

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, obj: dict) -> "Profile":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(obj) - known
        if extra:
            raise ValueError(f"unknown Profile fields {sorted(extra)}")
        return cls(**obj)

    def compatible(self, other: "Profile") -> bool:
        return all(getattr(self, f) == getattr(other, f)
                   for f in _STRICT)


def encode(obj: dict) -> bytes:
    """One wire frame: compact JSON + newline."""
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode()


def decode(line: bytes | str) -> dict:
    obj = json.loads(line)
    if not isinstance(obj, dict):
        raise ValueError("wire frame must be a JSON object")
    return obj


def error(code: str, detail: str) -> dict:
    return {"ok": False, "error": code, "detail": detail}


#: hard cap on one JSON line: a peer that never sends ``\n`` must not
#: grow the read buffer without bound (the JSON-lines mirror of the
#: fabric's ``MAX_FRAME`` discipline).  Generous for real snapshots —
#: a 64-host x 64-task per-task profile is well under 1 MiB.
MAX_LINE = 1 << 20


class _Oversize:
    """Sentinel yielded by :func:`recv_lines` for a line that exceeded
    ``MAX_LINE`` without a newline: the stream position is now
    mid-garbage, so the caller must answer with a protocol error and
    drop the connection (resynchronizing is impossible)."""

    def __repr__(self) -> str:            # pragma: no cover - debug aid
        return "<protocol.OVERSIZE>"


OVERSIZE = _Oversize()


def recv_lines(sock_file, max_line: int = MAX_LINE):
    """Yield decoded frames from a file-like until EOF.

    A syntactically bad frame yields ``None`` (the caller answers with
    a protocol error and keeps the connection); a line longer than
    ``max_line`` with no newline yields :data:`OVERSIZE` and stops —
    the caller must drop the connection after answering.
    """
    nl = None
    while True:
        raw = sock_file.readline(max_line + 1)
        if not raw:
            return
        if nl is None:
            nl = b"\n" if isinstance(raw, bytes) else "\n"
        if len(raw) > max_line and not raw.endswith(nl):
            yield OVERSIZE
            return
        if not raw.strip():
            continue
        try:
            yield decode(raw)
        except ValueError:
            yield None
