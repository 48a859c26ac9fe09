"""Straggler techniques of the port: ``none``, START and START-eager.

Every technique is a :class:`repro_torch.policy.Policy` registered with
the decorator-based registry (``repro_torch.policy.register``); importing
this package is what populates the registry with them.  The JAX
package's other techniques (the paper's baselines, RPPS, the replication
family) are not ported yet: ``repro_torch.policy.make`` of one raises
``NotImplementedError`` naming its ``ROADMAP.md`` item.
"""
from repro_torch import policy
from repro_torch.sim.engine import NoMitigation
from repro_torch.sim.techniques.start_tech import START, STARTEager

policy.register("none", description="no straggler mitigation "
                                    "(control)")(NoMitigation)

__all__ = ["START", "STARTEager", "NoMitigation"]
