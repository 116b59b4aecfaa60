"""Slab-resident LPT initial conditions.

Counterpart of :mod:`nbody.distributed.ic`.  Every stage stays on the
shards: each shard draws the white noise of its own x-slab, the forward
and inverse transforms ride the transpose-decomposed FFT
(:mod:`nbody_torch.distributed.fft`), the displacement grids come back as
x-slabs, and one :func:`~nbody_torch.distributed.domain.slab_exchange`
re-homes the born particles, so a shard never holds more than about N / D
of anything.

Seeding: shard d draws from a ``torch.Generator`` seeded from (seed, d),
so the domain realization of a seed is a different (equally valid)
sample of the same Gaussian ensemble than the single-device draw of
:func:`nbody_torch.driver.simulate.realize_ics`, as in the JAX package
(whose threefry draws Philox cannot reproduce).  ``noise`` hands in the
shards' draws instead, e.g. the JAX package's own.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from nbody_torch.core import units
from nbody_torch.core.cosmology import Cosmology
from nbody_torch.core.types import ParticleState
from nbody_torch.distributed.collectives import ShardGroup
from nbody_torch.distributed.domain import slab_exchange
from nbody_torch.distributed.fft import kvecs_slab, slab_irfftn, slab_rfftn
from nbody_torch.ic.gaussian import GRFSpec


def slab_seed(seed: int, d: int) -> int:
    """The seed of shard d's generator for the domain draw of ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(d)]).generate_state(
        1, np.uint64)[0])


def slab_noise(seed: int, nmesh: int, group: ShardGroup, *, noise=None,
               dtype=torch.float32) -> list:
    """Each shard's (nmesh / D, nmesh, nmesh) slab of unit real white
    noise, on its device: float32 normal draws from the shard's own
    generator (:func:`slab_seed`), or ``noise``, a list of D such real
    arrays."""
    D = group.size
    if nmesh % D:
        raise ValueError(f"nmesh={nmesh} not divisible by {D} devices")
    shape = (nmesh // D, nmesh, nmesh)
    if noise is None:
        return [torch.randn(shape, generator=torch.Generator().manual_seed(
            slab_seed(seed, d)), dtype=torch.float32).to(dev, dtype)
            for d, dev in enumerate(group.devices)]
    if len(noise) != D:
        raise ValueError(f"noise has {len(noise)} slabs, the group {D}")
    out = []
    for w, dev in zip(noise, group.devices):
        w = torch.as_tensor(np.array(w), dtype=dtype, device=dev)
        if tuple(w.shape) != shape:
            raise ValueError(f"noise slab shape {tuple(w.shape)} != {shape}")
        out.append(w)
    return out


def slab_delta1_k(seed: int, spec: GRFSpec, power: Callable,
                  group: ShardGroup, *, noise=None, amplitude: float = 1.0,
                  dtype=torch.float32) -> list:
    """The shards' transposed-layout blocks of delta(k) at a = 1 of the
    domain draw (:func:`slab_noise`): the noise's slab rfftn scaled by
    sqrt(amplitude P(k) N^3 / V) (times 2 pi with the 'fac' convention),
    the DC mode zeroed.  ``power`` is a host numpy callable; ``amplitude``
    the A_s ratio of an ensemble member to its base."""
    nmesh, box = spec.nmesh, spec.box
    D = group.size
    wk = slab_rfftn(slab_noise(seed, nmesh, group, noise=noise, dtype=dtype),
                    group)
    out = []
    for d, (w, dev) in enumerate(zip(wk, group.devices)):
        kx, ky, kz = kvecs_slab(nmesh, box, d, D, torch.float64)
        km = torch.sqrt(kx**2 + ky**2 + kz**2).numpy()
        with np.errstate(divide="ignore", invalid="ignore"):  # k = 0
            amp2 = amplitude * np.asarray(power(km)) * (nmesh**3 / box**3)
        if spec.convention == "fac":
            amp2 = amp2 * (2.0 * np.pi)
        amp = np.where(km > 0, np.sqrt(np.maximum(amp2, 0.0)), 0.0)
        out.append(w * torch.as_tensor(amp, dtype=dtype, device=dev))
    return out


def _slab_ks(nmesh: int, box: float, d: int, D: int, dtype, device):
    """Shard d's wavevectors with the Nyquist planes zeroed, and 1 / k^2
    (0 at k = 0)."""
    kx, ky, kz = kvecs_slab(nmesh, box, d, D, dtype, device)
    k2 = kx**2 + ky**2 + kz**2
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                         torch.zeros_like(k2))
    k_ny = math.pi * nmesh / box * (1.0 - 1e-6)
    ks = [torch.where(torch.abs(k) > k_ny, torch.zeros_like(k), k)
          for k in (kx, ky, kz)]
    return ks, inv_k2


def _grad_psi_slab(delta_k: list, nmesh: int, box: float,
                   group: ShardGroup) -> list:
    """psi_j = irfftn(i k_j / k^2 delta_k), Nyquist planes zeroed (cf.
    :func:`nbody_torch.ic.zeldovich._displacement_from_delta_k`): the
    shards' (nmesh / D, nmesh, nmesh, 3) slabs."""
    D = group.size
    ctx = [_slab_ks(nmesh, box, d, D, dk.real.dtype, dk.device)
           for d, dk in enumerate(delta_k)]
    comps = [slab_irfftn([1j * ks[j] * inv_k2 * dk
                          for dk, (ks, inv_k2) in zip(delta_k, ctx)],
                         nmesh, group)
             for j in range(3)]
    return [torch.stack([comps[j][d] for j in range(3)], dim=-1)
            for d in range(D)]


def _second_order_source_k_slab(delta_k: list, nmesh: int, box: float,
                                group: ShardGroup) -> list:
    """Slab form of :func:`nbody_torch.ic.zeldovich._second_order_source_k`:
    S = sum_{i<j} [phi,ii phi,jj - phi,ij^2] with phi_k = -delta_k / k^2,
    the six products slab-local; returns the blocks of its rfftn."""
    D = group.size
    ctx = [_slab_ks(nmesh, box, d, D, dk.real.dtype, dk.device)
           for d, dk in enumerate(delta_k)]

    def dij(i, j):
        return slab_irfftn([ks[i] * ks[j] * inv_k2 * dk
                            for dk, (ks, inv_k2) in zip(delta_k, ctx)],
                           nmesh, group)

    dxx, dyy, dzz = dij(0, 0), dij(1, 1), dij(2, 2)
    dxy, dxz, dyz = dij(0, 1), dij(0, 2), dij(1, 2)
    src = [dxx[d] * dyy[d] + dxx[d] * dzz[d] + dyy[d] * dzz[d]
           - dxy[d]**2 - dxz[d]**2 - dyz[d]**2 for d in range(D)]
    return slab_rfftn(src, group)


def ic_capacities(nmesh: int, D: int) -> tuple[int, int]:
    """(C, E) of the domain ICs: C = 1.3 x the particles born on a slab
    + 8, rounded up to 8; E the exchange capacity, min(C, 1.25 nmesh^2 +
    64 rounded up to 8), since every particle of a slab's lowest lattice
    plane sits on the slab boundary and may move left."""
    C_born = (nmesh // D) * nmesh * nmesh
    C = -(-int(1.3 * C_born + 8) // 8) * 8
    E = min(C, -(-int(1.25 * nmesh * nmesh + 64) // 8) * 8)
    return C, E


def lpt_ic_domain(seed: int, spec: GRFSpec, power: Callable, cosmo: Cosmology,
                  a_init: float, group: ShardGroup, *, order: int = 1,
                  ncell: int | None = None, noise=None,
                  amplitude: float = 1.0,
                  dtype=torch.float32) -> tuple[list, int]:
    """Slab-resident LPT ICs on the shards of ``group``.

    The physics of :func:`nbody_torch.ic.zeldovich.lpt_ic` (lattice plus
    1LPT or 2LPT displacement, canonical momentum a^2 H f D psi), computed
    slab by slab from the domain draw of ``seed`` (or ``noise``, a list of
    D real (nmesh / D, nmesh, nmesh) slabs).  The particle mass is the
    mean matter density's share, and P(k) enters times ``amplitude``
    (:func:`slab_delta1_k`; an ensemble member's A_s ratio to its base).

    Returns (shards, exchange_overflow): D :class:`ParticleState` of C
    rows each (:func:`ic_capacities`; empty rows have mass 0 and are
    parked at the slab centre, the layout of
    :func:`~nbody_torch.distributed.domain.domain_decompose`), re-homed by
    one exchange on a chaining grid of ``ncell`` x-layers: D by default,
    as in the JAX package; the domain driver passes its run's own grid
    (:func:`~nbody_torch.distributed.domain.slab_grid`), whose float32
    cuts decide which shard owns a particle within an ulp of a slab
    boundary.  The overflow counts the particles the exchange could not
    place (0 for any sane spec)."""
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    nmesh, box = spec.nmesh, spec.box
    D = group.size
    nxl = nmesh // D
    C_born = nxl * nmesh * nmesh
    C, E = ic_capacities(nmesh, D)
    rho_crit = 3.0 * cosmo.H0**2 / (8.0 * math.pi * units.COSMO.G)
    particle_mass = float(rho_crit * cosmo.Omega_m * box**3 / nmesh**3)
    D1 = float(cosmo.growth_D(a_init))
    f1 = float(cosmo.growth_f(a_init))
    H = float(cosmo.H(a_init))
    a = float(a_init)
    mom1 = a**2 * H * f1 * D1

    delta1_k = slab_delta1_k(seed, spec, power, group, noise=noise,
                             amplitude=amplitude, dtype=dtype)
    psi1 = _grad_psi_slab(delta1_k, nmesh, box, group)
    disp = [D1 * p for p in psi1]
    mom = [mom1 * p for p in psi1]
    if order == 2:
        ratio2 = float(cosmo.growth_D2(a_init)) / (D1 * D1)
        mom2 = a**2 * H * (2.0 * f1) * ratio2
        psi2 = _grad_psi_slab(_second_order_source_k_slab(
            [D1 * x for x in delta1_k], nmesh, box, group), nmesh, box, group)
        disp = [x + ratio2 * p for x, p in zip(disp, psi2)]
        mom = [x + mom2 * p for x, p in zip(mom, psi2)]

    h = box / nmesh
    pos, vel, mass = [], [], []
    for d, dev in enumerate(group.devices):
        xs = (d * nxl + torch.arange(nxl, dtype=dtype, device=dev)) * h
        yz = torch.arange(nmesh, dtype=dtype, device=dev) * h
        q = torch.stack(torch.meshgrid(xs, yz, yz, indexing="ij"), dim=-1)
        park = torch.tensor([(d + 0.5) * (box / D), 0.5 * box, 0.5 * box],
                            dtype=dtype, device=dev)
        pad = C - C_born
        pos.append(torch.cat([
            torch.remainder((q + disp[d]).reshape(C_born, 3), box),
            park.expand(pad, 3)]))
        vel.append(torch.cat([mom[d].reshape(C_born, 3),
                              torch.zeros((pad, 3), dtype=dtype, device=dev)]))
        mass.append(torch.cat([
            torch.full((C_born,), particle_mass, dtype=dtype, device=dev),
            torch.zeros((pad,), dtype=dtype, device=dev)]))
    pos, vel, mass, ov = slab_exchange(pos, vel, mass, box=box,
                                       ncell=ncell or D, group=group,
                                       exchange_capacity=E)
    shards = [ParticleState(pos=p, vel=v, mass=m,
                            time=torch.tensor(a, dtype=dtype, device=p.device))
              for p, v, m in zip(pos, vel, mass)]
    return shards, int(group.psum([o.to(torch.int64) for o in ov])[0])
