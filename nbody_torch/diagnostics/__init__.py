"""Diagnostics: energies and momenta, profiling, the Layzer-Irvine
budget (counterpart of :mod:`nbody.diagnostics`)."""

from nbody_torch.diagnostics.energy import (
    angular_momentum,
    center_of_mass,
    energy_drift,
    kinetic_energy,
    momentum,
    potential_energy,
    total_energy,
    virial_ratio,
)

__all__ = [
    "kinetic_energy",
    "potential_energy",
    "total_energy",
    "momentum",
    "angular_momentum",
    "center_of_mass",
    "energy_drift",
    "virial_ratio",
]

from nbody_torch.diagnostics.profiling import (
    StepReport,
    StepTimer,
    benchmark_fn,
    pairwise_interactions,
    sync,
    trace,
)

__all__ += ["StepReport", "StepTimer", "benchmark_fn",
            "pairwise_interactions", "sync", "trace"]

from nbody_torch.diagnostics.layzer_irvine import (
    layzer_irvine_residual,
    peculiar_energies,
)

__all__ += ["layzer_irvine_residual", "peculiar_energies"]
