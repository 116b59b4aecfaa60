"""Conservation diagnostics.

Counterpart of :mod:`nbody.diagnostics.energy`: every quantity is one
reduction on the state's device.  E_pot uses the same Plummer pair kernel
as the force (-G m_i m_j / sqrt(r^2 + eps^2)), so the conserved
Hamiltonian is the one the KDK integrator preserves.
"""

from __future__ import annotations

import torch

from nbody_torch.core.types import ParticleState
from nbody_torch.forces.allpairs import direct_acc_chunked, direct_potential


def kinetic_energy(state: ParticleState):
    return 0.5 * torch.sum(state.mass * torch.sum(state.vel**2, dim=-1))


def potential_energy(state: ParticleState, eps: float = 0.0, G: float = 1.0):
    """Dense O(N^2) potential (oracle), chunked above 4,096 particles.
    For large N use the phi returned by the force kernels:
    E_pot = 0.5 * sum(mass * phi)."""
    if state.n <= 4096:
        return direct_potential(state.pos, state.mass, eps=eps, G=G)
    _, epot = direct_acc_chunked(state.pos, state.mass, eps=eps, G=G)
    return epot


def total_energy(state: ParticleState, eps: float = 0.0, G: float = 1.0):
    return kinetic_energy(state) + potential_energy(state, eps=eps, G=G)


def momentum(state: ParticleState):
    return torch.sum(state.mass[:, None] * state.vel, dim=0)


def angular_momentum(state: ParticleState):
    return torch.sum(
        state.mass[:, None] * torch.linalg.cross(state.pos, state.vel), dim=0
    )


def center_of_mass(state: ParticleState):
    return (torch.sum(state.mass[:, None] * state.pos, dim=0)
            / torch.sum(state.mass))


def energy_drift(e_series):
    """max |E(t) - E(0)| / |E(0)| over a series of total energies."""
    e_series = torch.as_tensor(e_series)
    e0 = e_series[0]
    return torch.max(torch.abs(e_series - e0) / torch.abs(e0))


def virial_ratio(state: ParticleState, eps: float = 0.0, G: float = 1.0):
    """-2 E_kin / E_pot; 1 for a system in virial equilibrium."""
    ek = kinetic_energy(state)
    ep = potential_energy(state, eps=eps, G=G)
    return -2.0 * ek / ep
