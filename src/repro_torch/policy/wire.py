"""Service-facing serialization of the policy vocabulary (a copy of the
JAX package's ``repro.policy.wire``, numpy only).

The prediction service (``repro_torch.service``) speaks JSON-lines over TCP;
its responses carry :class:`~repro_torch.policy.actions.Action`s and its
requests carry telemetry snapshots.  This module owns the mapping
between those dataclasses and plain JSON-safe dicts, so the wire format
lives next to the vocabulary it encodes (a new ``ActionKind`` is a
one-file change) and both substrates — the cloud simulator and the pod
runtime acting as a service client — serialize identically.
"""
from __future__ import annotations

import numpy as np

from repro_torch.policy.actions import Action, ActionKind

#: wire fields, in the order they are emitted (defaults omitted)
_ACTION_FIELDS = ("task", "target", "delay", "n_clones", "host")
_ACTION_DEFAULTS = {"task": -1, "target": None, "delay": 1,
                    "n_clones": 1, "host": -1}


def action_to_wire(action: Action) -> dict:
    """``Action`` -> JSON-safe dict; default-valued fields are omitted
    so the common speculate/rerun messages stay one-line small."""
    out: dict = {"kind": str(ActionKind(action.kind))}
    for f in _ACTION_FIELDS:
        v = getattr(action, f)
        if v != _ACTION_DEFAULTS[f]:
            out[f] = int(v) if v is not None else None
    return out


def action_from_wire(obj: dict) -> Action:
    """Inverse of :func:`action_to_wire`; unknown keys are rejected so a
    version-skewed peer fails loudly instead of silently dropping
    semantics."""
    extra = set(obj) - {"kind", *_ACTION_FIELDS}
    if extra:
        raise ValueError(f"unknown Action wire fields {sorted(extra)}")
    kw = {f: obj.get(f, _ACTION_DEFAULTS[f]) for f in _ACTION_FIELDS}
    return Action(kind=ActionKind(obj["kind"]), **kw)


def job_to_wire(job_id: int, q: int, m_t: np.ndarray,
                open_count: int | None = None, deadline: bool = False,
                tasks: list[tuple[int, int, int]] | None = None) -> dict:
    """One job entry of a telemetry snapshot.

    Args:
        job_id: tenant-scoped job identifier.
        q: true task count (1..max_tasks).
        m_t: (max_tasks, TASK_FEATURES) task matrix (padded rows zero).
        open_count: incomplete original tasks (defaults to ``q``).
        tasks: per open task ``(task_id, host, slot)`` — ``slot`` is the
            task's row in ``m_t``; required for the service to emit
            mitigation actions, optional for predict-only use.
    """
    out = {
        "id": int(job_id), "q": int(q),
        "m_t": np.asarray(m_t, np.float32).reshape(-1).tolist(),
        "open": int(q if open_count is None else open_count),
        "deadline": bool(deadline),
    }
    if tasks is not None:
        out["tasks"] = [[int(t), int(h), int(s)] for t, h, s in tasks]
    return out


def snapshot_to_wire(tenant: str, seq: int, m_h: np.ndarray,
                     jobs: list[dict] | None = None,
                     done: list[dict] | None = None) -> dict:
    """One per-interval telemetry snapshot request.

    Args:
        m_h: (n_hosts, HOST_FEATURES) current host matrix.
        jobs: entries from :func:`job_to_wire`.
        done: completed-job records ``{"id": job_id, "times": [...]}``
            feeding the service's continuous-retraining buffer.
    """
    return {
        "op": "snapshot", "tenant": str(tenant), "seq": int(seq),
        "m_h": np.asarray(m_h, np.float32).reshape(-1).tolist(),
        "jobs": list(jobs or ()),
        "done": [{"id": int(d["id"]),
                  "times": [float(x) for x in d["times"]]}
                 for d in (done or ())],
    }
