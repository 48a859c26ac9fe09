"""Unified mitigation-action vocabulary (one grammar, two substrates; a
copy of the JAX package's, whose pod runtime the port has not yet).

The cloud simulator historically spoke ``SimAction`` (speculate / rerun /
clone / delay on *tasks*) and the distributed training runtime spoke
``HostAction`` (backup-shard / evict on *hosts*).  ``Action`` merges both:
a policy emits one vocabulary and each substrate executes the kinds it
understands (the pod runtime additionally *translates* task kinds — a
speculate on host h's shard becomes a backup shard, a rerun becomes an
eviction).

``ActionKind`` is a str-enum so existing code comparing ``act.kind`` to
plain strings ("speculate", "rerun", ...) keeps working unchanged.
"""
from __future__ import annotations

import dataclasses
import enum


class ActionKind(str, enum.Enum):
    """Every mitigation verb either substrate can execute."""

    # task-level verbs (cloud simulator semantics)
    SPECULATE = "speculate"      # run a copy, first result wins
    RERUN = "rerun"              # kill and restart on a new node
    CLONE = "clone"              # proactive upfront copies
    DELAY = "delay"              # hold a pending task back
    # host-level verbs (distributed training-pod semantics)
    BACKUP_SHARD = "backup_shard"  # a healthy host also computes the shard
    EVICT = "evict"                # drop the host and remesh

    def __str__(self) -> str:  # log-friendly ("speculate", not the repr)
        return self.value


#: kinds the cloud simulator executes directly
TASK_KINDS = frozenset((ActionKind.SPECULATE, ActionKind.RERUN,
                        ActionKind.CLONE, ActionKind.DELAY))
#: kinds the distributed runtime executes directly
HOST_KINDS = frozenset((ActionKind.BACKUP_SHARD, ActionKind.EVICT))


@dataclasses.dataclass(frozen=True)
class Action:
    """One mitigation decision.

    ``task``/``target``/``delay``/``n_clones`` carry the task-level verbs;
    ``host`` (with ``target`` as the backup host) carries the host-level
    verbs.  ``kind`` may be an :class:`ActionKind` or its string value.
    """

    kind: ActionKind | str
    task: int = -1               # task id (simulator vocabulary)
    target: int | None = None    # target / backup host
    delay: int = 1               # intervals to hold a DELAY'd task
    n_clones: int = 1            # copies for CLONE
    host: int = -1               # host id (distributed vocabulary)

    @property
    def backup(self) -> int | None:
        """Distributed-runtime spelling of ``target``."""
        return self.target


def host_action(kind: ActionKind, host: int,
                backup: int | None = None) -> Action:
    """Build a host-level action (the old ``HostAction`` constructor)."""
    return Action(kind=kind, host=host, target=backup)
