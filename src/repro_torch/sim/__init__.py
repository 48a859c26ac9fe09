"""CloudSim-analogue simulator: the paper's evaluation substrate, in
numpy (copies of the JAX package's ``repro.sim`` modules, drawing the
same numbers from the same seeds), and the grid runner ``sweep``."""
from repro_torch.sim.config import SimConfig, small
from repro_torch.sim.engine import (NoMitigation, SimAction, Simulation,
                                    Technique)

__all__ = ["SimConfig", "small", "Simulation", "Technique", "SimAction",
           "NoMitigation", "scenarios"]

from repro_torch.sim import scenarios  # noqa: E402  (scenario registry)
