"""Simulation driver: config, single runs."""

from nbody_torch.driver.config import OutputConfig, SimulationConfig
from nbody_torch.driver.simulate import (
    SimulationResult,
    realize_ics,
    run_simulation,
)

__all__ = [
    "OutputConfig",
    "SimulationConfig",
    "SimulationResult",
    "realize_ics",
    "run_simulation",
]
