"""1LPT (Zel'dovich) and 2LPT initial conditions.

Counterpart of :mod:`nbody.ic.zeldovich`: psi_k = i k / k^2 delta_k with
the Nyquist planes zeroed, three inverse FFTs, particles born on the
lattice nodes so the displacement is read straight off the grid.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from nbody_torch.core import units
from nbody_torch.core.cosmology import Cosmology
from nbody_torch.core.types import ParticleState
from nbody_torch.ic.gaussian import GRFSpec, gaussian_delta_k
from nbody_torch.mesh.grids import kvecs, lattice


def _inv_k2_kvecs(delta_k, nmesh: int, box: float):
    dtype = delta_k.real.dtype
    kx, ky, kz = kvecs(nmesh, box, rfft=True, device=delta_k.device,
                       dtype=dtype, zero_nyquist=True)
    k2 = kx**2 + ky**2 + kz**2
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    return (kx, ky, kz), inv_k2


def _displacement_from_delta_k(delta_k, nmesh: int, box: float):
    """psi_k = i k / k^2 delta_k -> (N^3, 3) real displacements."""
    ks, inv_k2 = _inv_k2_kvecs(delta_k, nmesh, box)
    shape = (nmesh,) * 3
    psi = [torch.fft.irfftn(1j * kj * inv_k2 * delta_k, s=shape) for kj in ks]
    return torch.stack([p.reshape(-1) for p in psi], dim=-1)


def _second_order_source_k(delta_k, nmesh: int, box: float):
    """rfftn of S = sum_{i<j} [phi,ii phi,jj - phi,ij^2], phi_k = -delta_k/k^2."""
    ks, inv_k2 = _inv_k2_kvecs(delta_k, nmesh, box)
    shape = (nmesh,) * 3

    def dij(i, j):
        return torch.fft.irfftn(ks[i] * ks[j] * inv_k2 * delta_k, s=shape)

    dxx, dyy, dzz = dij(0, 0), dij(1, 1), dij(2, 2)
    dxy, dxz, dyz = dij(0, 1), dij(0, 2), dij(1, 2)
    src = dxx * dyy + dxx * dzz + dyy * dzz - dxy**2 - dxz**2 - dyz**2
    return torch.fft.rfftn(src)


def lpt_ic(
    spec: GRFSpec,
    power: Callable,
    cosmo: Cosmology,
    a_init: float,
    order: int = 1,
    particle_mass: float | None = None,
    amplitude: float = 1.0,
    generator: torch.Generator | None = None,
    *,
    noise=None,
    device="cuda",
    dtype=torch.float32,
) -> ParticleState:
    """Cosmological ICs: lattice + LPT displacement at scale factor a_init,
    on ``device`` (the card unless the caller asks for the CPU).

    ``power``: linear P(k) at a = 1 (host numpy callable), scaled here by
    D(a_init).  ``order``: 1 (Zel'dovich) or 2 (2LPT).  The white noise
    comes from ``generator`` or is given as ``noise`` (real, (nmesh,)*3).
    ``particle_mass`` defaults to rho_crit Omega_m V / N (1e10 Msun).

    Returns comoving positions, canonical momentum p = a^2 H f D psi per
    growing mode, time = a_init."""
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    nmesh, box = spec.nmesh, spec.box
    delta1_k = gaussian_delta_k(spec, power, amplitude, generator,
                                noise=noise, device=device, dtype=dtype)
    D1 = float(cosmo.growth_D(a_init))
    f1 = float(cosmo.growth_f(a_init))
    H = float(cosmo.H(a_init))
    a = float(a_init)

    psi1 = _displacement_from_delta_k(delta1_k, nmesh, box)
    q = lattice(nmesh, box, device=psi1.device, dtype=psi1.dtype)
    disp = D1 * psi1
    mom = (a**2 * H * f1 * D1) * psi1
    if order == 2:
        src2_k = _second_order_source_k(D1 * delta1_k, nmesh, box)
        psi2 = _displacement_from_delta_k(src2_k, nmesh, box)
        ratio2 = float(cosmo.growth_D2(a_init)) / (D1 * D1)
        f2 = 2.0 * f1  # dlnD2/dlna ~ 2 f1 (exact in EdS)
        disp = disp + ratio2 * psi2
        mom = mom + (a**2 * H * f2 * ratio2) * psi2
    pos = torch.remainder(q + disp, box)

    if particle_mass is None:
        rho_crit = 3.0 * cosmo.H0**2 / (8.0 * math.pi * units.COSMO.G)
        particle_mass = float(rho_crit * cosmo.Omega_m * box**3 / nmesh**3)
    mass = torch.full((nmesh**3,), particle_mass, device=pos.device,
                      dtype=pos.dtype)
    return ParticleState(pos=pos, vel=mom, mass=mass,
                         time=torch.tensor(a, device=pos.device,
                                           dtype=pos.dtype))
