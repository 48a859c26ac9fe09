"""Self-describing policy registry (a copy of the JAX package's).

Each entry carries everything a runner needs to *use* the policy — the
factory, which substrates it supports, and (when applicable) how to
pretrain it.  Registering a policy is one decorator::

    from repro_torch import policy

    @policy.register("my-tech", description="...")
    class MyTech(policy.Policy):
        def decide(self, view):
            ...

A class that implements the :class:`~repro_torch.policy.base.Pretrainable`
protocol (a ``pretrain(ctx)`` classmethod) gets a :class:`PretrainSpec`
attached automatically; ``epochs_knob`` names the runner attribute that
feeds ``ctx.epochs``.

A name the JAX package registers that the port does not have yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` item
(:data:`NOT_PORTED`), not :class:`UnknownPolicyError`.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

from repro_torch.policy.base import Policy


@dataclasses.dataclass
class PretrainContext:
    """Environment handed to ``Policy.pretrain``.

    ``config`` is the substrate configuration to train for (a
    ``SimConfig`` for simulator sweeps).  ``warmup`` lazily yields a
    finished warmup run as a ``TelemetryView`` (runners cache it so
    several policies can share one warmup).  ``epochs`` is the value of
    the entry's ``epochs_knob`` (``None`` when the entry declares no
    knob — the policy falls back to its own default).  ``kwargs`` are
    constructor keywords the runner wants the trained instance built
    with (``SweepSpec.technique_kwargs``): pretrain classmethods forward
    them — ``cls(..., **ctx.kwargs)`` — so a policy's knobs stay
    sweepable even on the pretrained path.
    """

    config: Any
    epochs: int | None = None
    warmup: Callable[[], Any] | None = None
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class PretrainSpec:
    """How to build a trained instance of a registered policy."""

    fn: Callable[[PretrainContext], Policy]
    epochs_knob: str | None = None   # runner attribute feeding ctx.epochs


@dataclasses.dataclass(frozen=True)
class PolicyEntry:
    name: str
    factory: Callable[..., Policy]
    pretrain: PretrainSpec | None = None
    substrates: tuple = ("sim",)     # which runtimes can execute it
    description: str = ""


_REGISTRY: dict[str, PolicyEntry] = {}

_POD = "ROADMAP.md Queue 1 item 4.3 (the pod runtime)"
#: names the JAX package registers that the port does not have yet, and
#: the ROADMAP item that ports each
NOT_PORTED = dict.fromkeys(("start-pod", "start-eager-pod",
                            "start-pod-online", "start-pod-service"), _POD)


class UnknownPolicyError(ValueError):
    """Raised for a name no policy was registered under."""

    def __init__(self, name: str, substrate: str | None = None):
        known = sorted(n for n, e in _REGISTRY.items()
                       if substrate is None or substrate in e.substrates)
        what = f"for substrate {substrate!r} " if substrate else ""
        super().__init__(
            f"unknown technique {name!r} {what}— registered techniques: "
            f"{', '.join(known) or '(none)'}")
        self.name = name


def register(name: str, *, substrates: tuple = ("sim",),
             description: str = "",
             pretrain: Callable[[PretrainContext], Policy] | None = None,
             epochs_knob: str | None = None) -> Callable[[type], type]:
    """Class decorator: add a policy to the registry under ``name``.

    The decorated class's ``pretrain`` classmethod (the ``Pretrainable``
    protocol) is used when no explicit ``pretrain`` callable is given.
    Re-registering a name replaces the entry (latest wins), so plugins
    and tests can shadow built-ins.
    """

    def deco(cls: type) -> type:
        fn = pretrain
        if fn is None:
            fn = inspect.getattr_static(cls, "pretrain", None)
            if fn is not None:
                fn = getattr(cls, "pretrain")  # bound classmethod
        spec = (PretrainSpec(fn=fn, epochs_knob=epochs_knob)
                if fn is not None else None)
        cls.name = name
        _REGISTRY[name] = PolicyEntry(
            name=name, factory=cls, pretrain=spec,
            substrates=tuple(substrates), description=description)
        return cls

    return deco


def unregister(name: str) -> None:
    """Remove an entry (primarily for tests/plugins shadowing names)."""
    _REGISTRY.pop(name, None)


def names(substrate: str | None = None) -> list[str]:
    """Registered names, optionally filtered to one substrate."""
    return sorted(n for n, e in _REGISTRY.items()
                  if substrate is None or substrate in e.substrates)


def get(name: str) -> PolicyEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"technique {name!r} is not ported to repro_torch yet: "
                f"{NOT_PORTED[name]}") from None
        raise UnknownPolicyError(name) from None


def make(name: str, **kw: Any) -> Policy:
    """Instantiate a registered policy (untrained)."""
    return get(name).factory(**kw)


def validate(names_: Any, substrate: str | None = None) -> None:
    """Raise :class:`UnknownPolicyError` for the first unknown name —
    called by runners up front so a grid fails before spawning workers."""
    for n in names_:
        entry = _REGISTRY.get(n)
        if entry is None or (substrate is not None
                             and substrate not in entry.substrates):
            raise UnknownPolicyError(n, substrate)
