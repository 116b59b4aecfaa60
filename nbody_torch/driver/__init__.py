"""Simulation driver: config, single runs, seeded ensembles."""

from nbody_torch.driver.config import OutputConfig, SimulationConfig
from nbody_torch.driver.simulate import (
    SimulationResult,
    build_cosmo_force,
    realize_ics,
    run_simulation,
)
from nbody_torch.driver.ensemble import (
    EnsembleResult,
    find_missing_jobs,
    make_seeds,
    run_ensemble,
)

__all__ = [
    "OutputConfig",
    "SimulationConfig",
    "SimulationResult",
    "build_cosmo_force",
    "realize_ics",
    "run_simulation",
    "EnsembleResult",
    "find_missing_jobs",
    "make_seeds",
    "run_ensemble",
]
