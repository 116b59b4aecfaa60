"""Layzer-Irvine cosmic energy diagnostics.

Counterpart of the single-device part of
:mod:`nbody.diagnostics.layzer_irvine`.  For comoving integrations
d(T + W)/dt = -H (2T + W), so C(a) = T + W + int (2T + W) dln a is
conserved; |C(a) - C(a0)| / max|W| is the cosmological analogue of |dE/E|.
W is the PM potential energy with the offset-dependent PM self-energy
subtracted per particle from a table (see the JAX package for the
measured caveats).  :func:`peculiar_energies_exact` is the exact
(Ewald) functional of the PP solver, for validation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nbody_torch.core.cosmology import Cosmology
from nbody_torch.core.types import ParticleState
from nbody_torch.forces.pm import pm_potential_k
from nbody_torch.mesh.cic import cic_gather


@functools.lru_cache(maxsize=8)
def _self_potential_table(box: float, nmesh: int, res: int = 6,
                          device=None) -> torch.Tensor:
    """Unit self-potential vs sub-cell offset, (res, res, res) float64,
    from the PM round trip (deposit -> deconvolve -> gather) of one
    particle onto itself, computed once per geometry on ``device``."""
    cell = box / nmesh
    one = torch.ones(1, device=device, dtype=torch.float64)
    vals = torch.zeros((res, res, res), device=device, dtype=torch.float64)
    for i in range(res):
        for j in range(res):
            for k in range(res):
                f = torch.tensor([i, j, k], dtype=torch.float64) / res
                x0 = (f * cell + 5 * cell)[None, :].to(device)
                phi = torch.fft.irfftn(pm_potential_k(x0, one, box, nmesh),
                                       s=(nmesh,) * 3)
                vals[i, j, k] = cic_gather(phi, x0, box)[0] / nmesh**3
    return vals


def _self_potential_per_particle(pos, box: float, nmesh: int, res: int = 6):
    """Periodic trilinear lookup of the offset-dependent unit self term."""
    tab = _self_potential_table(box, nmesh, res, pos.device).to(pos.dtype)
    frac = torch.remainder(pos * (nmesh / box), 1.0) * res
    i0 = torch.floor(frac)
    f = frac - i0
    i0 = i0.to(torch.int64)
    out = torch.zeros(pos.shape[:1], device=pos.device, dtype=pos.dtype)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                ix = torch.remainder(i0[:, 0] + dx, res)
                iy = torch.remainder(i0[:, 1] + dy, res)
                iz = torch.remainder(i0[:, 2] + dz, res)
                out = out + w * tab[ix, iy, iz]
    return out


def peculiar_energies(state: ParticleState, cosmo: Cosmology, box: float,
                      nmesh: int, subtract_self: bool = True,
                      deconvolve_p: int = 2):
    """(T, W) of a comoving state (vel = canonical momentum a^2 dx/dt),
    as 0-d tensors.

    T = 1/2 sum m (vel / a)^2;  W = 1/2 sum m phi(x) with the PM potential
    at the state's scale factor, self-energy subtracted unless
    ``subtract_self=False`` (the raw functional 1/2 sum_G rho_G phi_G)."""
    a = state.time.to(state.pos.dtype)
    v_pec = state.vel / a
    T = 0.5 * torch.sum(state.mass * torch.sum(v_pec * v_pec, dim=-1))
    amp = 1.5 * cosmo.Omega_m * cosmo.H0**2 / a
    phi_k = pm_potential_k(state.pos, state.mass, box, nmesh,
                           deconvolve_p=deconvolve_p) * amp
    phi = torch.fft.irfftn(phi_k, s=(nmesh,) * 3)
    W_raw = 0.5 * torch.sum(state.mass * cic_gather(phi, state.pos, box))
    if not subtract_self:
        return T, W_raw
    u = _self_potential_per_particle(torch.remainder(state.pos, box), box,
                                     nmesh)
    W_self = (0.5 * amp * nmesh**3 / torch.sum(state.mass)
              * torch.sum(state.mass**2 * u))
    return T, W_raw - W_self


def peculiar_energies_domain(shards: list, cosmo: Cosmology, box: float,
                             nmesh: int, group, deconvolve_p: int = 2):
    """:func:`peculiar_energies` of a slab-resident state (empty slots have
    mass 0): T and W are partial sums added over the shards, and the
    potential comes from the slab deposit, the distributed FFT and the
    slab read-back, so nothing larger than nmesh^3 / D lives on a shard.
    Counterpart of the JAX package's ``peculiar_energies_domain``."""
    from nbody_torch.distributed.domain import slab_deposit, slab_gather3
    from nbody_torch.distributed.fft import (
        kvecs_slab,
        slab_irfftn,
        slab_rfftn,
    )

    D = group.size
    a = float(shards[0].time)
    amp = 1.5 * float(cosmo.Omega_m) * float(cosmo.H0) ** 2 / a
    pos = [s.pos for s in shards]
    mass = [s.mass for s in shards]
    T = 0.5 * group.psum([torch.sum(s.mass * torch.sum(s.vel * s.vel, dim=-1))
                          / (a * a) for s in shards])[0]
    M = group.psum([torch.sum(m) for m in mass])
    grids = slab_deposit(pos, mass, box=box, nmesh=nmesh, group=group)
    phi_k = []
    for d, x in enumerate(slab_rfftn(grids, group)):
        dtype, dev = pos[d].dtype, pos[d].device
        delta_k = x / (M[d] / nmesh**3)
        kx, ky, kz = kvecs_slab(nmesh, box, d, D, dtype, dev)
        if deconvolve_p:
            h = box / nmesh

            def sinc(k):
                return torch.sinc(k * (h / (2.0 * np.pi)))

            W_k = (sinc(kx) * sinc(ky) * sinc(kz)) ** deconvolve_p
            delta_k = delta_k / torch.clamp_min(W_k, 1e-8)
        k2 = kx**2 + ky**2 + kz**2
        inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                             torch.zeros_like(k2))
        phi_k.append(-amp * delta_k * inv_k2)
    phi = slab_irfftn(phi_k, nmesh, group)
    phi_at = slab_gather3([p[None] for p in phi], pos, box=box, group=group)
    W_raw = 0.5 * group.psum([torch.sum(m * f[:, 0])
                              for m, f in zip(mass, phi_at)])[0]
    self_terms = []
    for p, m in zip(pos, mass):
        u = _self_potential_per_particle(torch.remainder(p, box), box, nmesh)
        self_terms.append(torch.sum(torch.where(m > 0, m**2 * u,
                                                torch.zeros_like(u))))
    W_self = 0.5 * amp * nmesh**3 / M[0] * group.psum(self_terms)[0]
    return T, W_raw - W_self


def peculiar_energies_exact(state: ParticleState, cosmo: Cosmology,
                            box: float, r_s: float | None = None,
                            n_max: int = 10):
    """(T, W) with W the exact periodic (Ewald) potential energy of the
    comoving Poisson source lap(phi) = (3/2) Om H0^2 delta / a: the
    force-consistent functional for
    :func:`nbody_torch.forces.ewald.ewald_pp_acc` with eps = 0.  Dense
    O(N^2); validation only, not on the run path."""
    from nbody_torch.core import units
    from nbody_torch.forces.ewald import ewald_potential_energy

    a = state.time.to(state.pos.dtype)
    v_pec = state.vel / a
    T = 0.5 * torch.sum(state.mass * torch.sum(v_pec * v_pec, dim=-1))
    W = ewald_potential_energy(
        state.pos, state.mass, box, G=units.COSMO.G, r_s=r_s, n_max=n_max
    ) / a
    return T, W


def layzer_irvine_residual(a, T, W) -> float:
    """Max |C(a) - C(a_0)| / max|W| over a sampled trajectory (a
    ascending); the integral term is a trapezoid in ln a."""
    a = np.asarray(a, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64)
    W = np.asarray(W, dtype=np.float64)
    lna = np.log(a)
    integrand = 2.0 * T + W
    integral = np.concatenate(
        [[0.0], np.cumsum(0.5 * (integrand[1:] + integrand[:-1]) * np.diff(lna))]
    )
    C = T + W + integral
    return float(np.max(np.abs(C - C[0])) / np.max(np.abs(W)))
