"""Analytic initial conditions: the Newtonian validation systems.

Counterpart of :mod:`nbody.ic.systems`: two-body Kepler orbit, solar
system, Plummer sphere, cold collapse and a two-galaxy merger.  Each
samples with numpy's ``default_rng`` exactly as the JAX functions do, so a
seed gives the same state in both packages (bit for bit after the cast to
``dtype``).  The states are built on ``device`` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_torch.core import units
from nbody_torch.core.types import ParticleState

# Planet data: (name, mass [Msun], semi-major axis [AU], eccentricity)
_SOLAR_BODIES = [
    ("mercury", 1.6601e-7, 0.3871, 0.2056),
    ("venus", 2.4478e-6, 0.7233, 0.0068),
    ("earth", 3.0035e-6, 1.0000, 0.0167),
    ("mars", 3.2271e-7, 1.5237, 0.0934),
    ("jupiter", 9.5479e-4, 5.2026, 0.0484),
    ("saturn", 2.8586e-4, 9.5549, 0.0539),
    ("uranus", 4.3662e-5, 19.2184, 0.0473),
    ("neptune", 5.1514e-5, 30.1104, 0.0086),
    ("pluto", 6.58e-9, 39.445, 0.2488),
]


def two_body(
    m1: float = 1.0,
    m2: float = 3.0035e-6,
    a: float = 1.0,
    e: float = 0.0167,
    G: float = units.SOLAR.G,
    dtype=torch.float64,
    device="cuda",
) -> ParticleState:
    """Two-body Kepler problem at perihelion, COM frame.

    Defaults: Sun-Earth in AU/yr/Msun units (orbital period ~1 yr).
    """
    mt = m1 + m2
    r_p = a * (1.0 - e)
    v_p = np.sqrt(G * mt * (1.0 + e) / r_p)  # relative speed at perihelion
    # place bodies about the COM along x, relative velocity along y
    pos = np.array(
        [[-m2 / mt * r_p, 0.0, 0.0], [m1 / mt * r_p, 0.0, 0.0]]
    )
    vel = np.array(
        [[0.0, -m2 / mt * v_p, 0.0], [0.0, m1 / mt * v_p, 0.0]]
    )
    return ParticleState.create(pos, vel, np.array([m1, m2]), dtype=dtype,
                                device=device)


def kepler_period(a: float, m_total: float = 1.0, G: float = units.SOLAR.G) -> float:
    return 2.0 * np.pi * np.sqrt(a**3 / (G * m_total))


def solar_system(seed: int = 0, dtype=torch.float64,
                 device="cuda") -> ParticleState:
    """Sun + 9 bodies (N=10), coplanar orbits at perihelion with
    deterministic pseudo-random phases; AU/yr/Msun units."""
    rng = np.random.default_rng(seed)
    G = units.SOLAR.G
    pos = [np.zeros(3)]
    vel = [np.zeros(3)]
    mass = [1.0]
    for _, m, a, e in _SOLAR_BODIES:
        theta = rng.uniform(0, 2 * np.pi)
        r_p = a * (1 - e)
        v_p = np.sqrt(G * (1.0 + m) * (1 + e) / r_p)
        c, s = np.cos(theta), np.sin(theta)
        pos.append(np.array([r_p * c, r_p * s, 0.0]))
        vel.append(np.array([-v_p * s, v_p * c, 0.0]))
        mass.append(m)
    pos, vel, mass = np.array(pos), np.array(vel), np.array(mass)
    # shift to COM frame so momentum is exactly zero
    mt = mass.sum()
    pos -= (mass[:, None] * pos).sum(0) / mt
    vel -= (mass[:, None] * vel).sum(0) / mt
    return ParticleState.create(pos, vel, mass, dtype=dtype, device=device)


def plummer(
    n: int,
    seed: int = 0,
    total_mass: float = 1.0,
    scale_radius: float | None = None,
    G: float = 1.0,
    dtype=torch.float32,
    device="cuda",
) -> ParticleState:
    """Plummer sphere in virial equilibrium (Aarseth/Henon sampling).

    Default scale radius is the Henon choice 3*pi/16 so that E = -1/4 with
    G = M = 1 (standard N-body units).
    """
    if scale_radius is None:
        scale_radius = 3.0 * np.pi / 16.0
    rng = np.random.default_rng(seed)
    # radius from inverse CDF of M(r)
    u = rng.uniform(1e-10, 1.0 - 1e-10, n)
    r = scale_radius / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * _random_unit_vectors(rng, n)
    # velocity: rejection-sample q = v/v_esc from g(q) = q^2 (1-q^2)^{7/2}
    q = np.zeros(n)
    todo = np.ones(n, dtype=bool)
    while todo.any():
        k = int(todo.sum())
        x = rng.uniform(0, 1, k)
        y = rng.uniform(0, 0.1, k)
        ok = y < x**2 * (1 - x**2) ** 3.5
        idx = np.flatnonzero(todo)[ok]
        q[idx] = x[ok]
        todo[idx] = False
    v_esc = np.sqrt(2.0 * G * total_mass) * (r**2 + scale_radius**2) ** -0.25
    vel = (q * v_esc)[:, None] * _random_unit_vectors(rng, n)
    # zero net momentum / COM
    pos -= pos.mean(0)
    vel -= vel.mean(0)
    mass = np.full(n, total_mass / n)
    return ParticleState.create(pos, vel, mass, dtype=dtype, device=device)


def cold_collapse(
    n: int, seed: int = 0, radius: float = 1.0, total_mass: float = 1.0,
    virial_ratio: float = 0.0, G: float = 1.0, dtype=torch.float32,
    device="cuda",
) -> ParticleState:
    """Cold uniform sphere (optionally with a small velocity dispersion)."""
    rng = np.random.default_rng(seed)
    r = radius * rng.uniform(0, 1, n) ** (1.0 / 3.0)
    pos = r[:, None] * _random_unit_vectors(rng, n)
    vel = np.zeros((n, 3))
    if virial_ratio > 0:
        # |E_pot| of uniform sphere = 3 G M^2 / (5 R)
        sigma = np.sqrt(virial_ratio * 2.0 * G * total_mass / (5.0 * radius))
        vel = rng.normal(0, sigma, (n, 3))
        vel -= vel.mean(0)
    pos -= pos.mean(0)
    mass = np.full(n, total_mass / n)
    return ParticleState.create(pos, vel, mass, dtype=dtype, device=device)


def two_galaxy_merger(
    n: int,
    seed: int = 0,
    separation: float = 10.0,
    impact_parameter: float = 1.0,
    relative_speed: float = 0.5,
    mass_ratio: float = 1.0,
    G: float = 1.0,
    dtype=torch.float32,
    device="cuda",
) -> ParticleState:
    """Two Plummer spheres on an approach orbit (the N=1M headline config,
    BASELINE.json configs[4])."""
    n1 = n // 2
    n2 = n - n1
    m2 = 1.0 / (1.0 + mass_ratio)
    m1 = 1.0 - m2
    g1 = plummer(n1, seed=seed, total_mass=m1, G=G, dtype=dtype, device=device)
    g2 = plummer(n2, seed=seed + 1, total_mass=m2, G=G, dtype=dtype,
                 device=device)
    # the offsets are float64 and applied in float64 before the cast, as
    # the JAX function's numpy offsets promote its arrays
    off = torch.tensor([separation / 2, impact_parameter / 2, 0.0],
                       dtype=torch.float64, device=g1.pos.device)
    dv = torch.tensor([relative_speed / 2, 0.0, 0.0], dtype=torch.float64,
                      device=g1.pos.device)
    pos = torch.cat([g1.pos.double() - off, g2.pos.double() + off])
    vel = torch.cat([g1.vel.double() + dv, g2.vel.double() - dv])
    mass = torch.cat([g1.mass, g2.mass])
    return ParticleState.create(pos, vel, mass, dtype=dtype)


def _random_unit_vectors(rng, n):
    costh = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    sinth = np.sqrt(1 - costh**2)
    return np.stack(
        [sinth * np.cos(phi), sinth * np.sin(phi), costh], axis=1
    )
