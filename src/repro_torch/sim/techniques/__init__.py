"""Straggler techniques of the port: START + the paper's six baselines
(+ RPPS), plus the replication-timing (Wang et al.) and redundancy-level
(Aktas & Soljanin) families, as in the JAX package's
``repro.sim.techniques``.

Every technique is a :class:`repro_torch.policy.Policy` registered with
the decorator-based registry (``repro_torch.policy.register``);
importing this package is what populates the registry with them.
``REGISTRY`` and ``make`` are kept as thin compatibility shims over the
registry — ``make`` raises a ``ValueError`` listing the registered
names for unknown techniques.  START, START-eager and IGRU-SD run their
networks on ``device`` (default ``"cuda"``); the others are numpy.
"""
from repro_torch import policy
from repro_torch.sim.engine import NoMitigation
from repro_torch.sim.techniques.baselines import (GRASS, SGC, Dolly, IGRUSD,
                                                  NearestFit, Wrangler)
from repro_torch.sim.techniques.replication import (AdaptiveRedundancy,
                                                    FixedRedundancy,
                                                    ForkRelaunch, SingleFork)
from repro_torch.sim.techniques.rpps import RPPS
from repro_torch.sim.techniques.start_tech import START, STARTEager

policy.register("none", description="no straggler mitigation "
                                    "(control)")(NoMitigation)

#: legacy name -> class mapping (the registry is the source of truth)
REGISTRY = {name: policy.registry.get(name).factory
            for name in policy.names("sim")}

BASELINES = ["nearestfit", "dolly", "grass", "sgc", "wrangler", "igru-sd"]

#: the replication-literature field (both substrates)
REPLICATION = ["single-fork", "fork-relaunch", "redundancy-fixed",
               "redundancy-adaptive"]

#: the full shipped simulator technique field, in canonical order
FIELD = ("none", "start", "start-eager", "igru-sd", "sgc", "dolly",
         "grass", "nearestfit", "wrangler", "rpps", *REPLICATION)


def make(name: str, **kw):
    """Instantiate a registered technique; unknown names raise a
    ``ValueError`` naming every registered technique."""
    return policy.make(name, **kw)


__all__ = ["REGISTRY", "BASELINES", "REPLICATION", "FIELD", "make", "START",
           "STARTEager", "IGRUSD", "SGC", "Dolly", "GRASS", "NearestFit",
           "Wrangler", "RPPS", "NoMitigation", "SingleFork", "ForkRelaunch",
           "FixedRedundancy", "AdaptiveRedundancy"]
