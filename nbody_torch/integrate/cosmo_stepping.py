"""Comoving-coordinate KDK stepping in the scale factor a.

Counterpart of the fixed-step part of :mod:`nbody.integrate.cosmo_stepping`.
The exact kick/drift factors are pre-integrated on the host (the same
numpy) and the steps run as a Python loop in place of ``lax.scan``, with
the same KDK order and ``mod(box)`` wrap.

Conventions: x comoving, p = a^2 dx/dt,
  dx/da = p / (a^3 H(a)),   dp/da = g(x, a) / (a H(a)),
and a KDK step over [a0, a1] with geometric midpoint am uses
  K1 = int_{a0}^{am} da/(a H),  Dr = int_{a0}^{a1} da/(a^3 H),
  K2 = int_{am}^{a1} da/(a H).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nbody_torch.core.cosmology import Cosmology
from nbody_torch.core.types import ParticleState

CosmoForceFn = Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]


def cosmo_kick_drift_factors(cosmo: Cosmology, a_grid: np.ndarray):
    """Host-side exact kick/drift factors for each step of ``a_grid``:
    (K1, Dr, K2, a_mid), numpy arrays of length len(a_grid) - 1, by
    trapezoid in log a."""
    a_grid = np.asarray(a_grid, dtype=np.float64)
    H0 = float(cosmo.H0)
    Om, OL = float(cosmo.Omega_m), float(cosmo.Omega_L)

    def H(a):
        return H0 * np.sqrt(Om / a**3 + OL)

    def integrate(f, lo, hi, n=256):
        lna = np.linspace(np.log(lo), np.log(hi), n)
        a = np.exp(lna)
        return np.trapezoid(f(a) * a, lna)

    a0s, a1s = a_grid[:-1], a_grid[1:]
    ams = np.sqrt(a0s * a1s)
    K1 = np.array([integrate(lambda a: 1 / (a * H(a)), lo, m) for lo, m in zip(a0s, ams)])
    K2 = np.array([integrate(lambda a: 1 / (a * H(a)), m, hi) for m, hi in zip(ams, a1s)])
    Dr = np.array([integrate(lambda a: 1 / (a**3 * H(a)), lo, hi) for lo, hi in zip(a0s, a1s)])
    return K1, Dr, K2, ams


def log_a_steps(a_begin: float, a_end: float, n_steps: int) -> np.ndarray:
    """Log-uniform scale-factor grid of n_steps steps."""
    return np.geomspace(a_begin, a_end, n_steps + 1)


def _max_overflow(acc, ov):
    """Running max of the overflow words: a device tensor stays on the
    device (no sync per step); a plain 0 from a tier that drops nothing
    leaves it as it is."""
    if isinstance(ov, torch.Tensor):
        return ov if acc is None else torch.maximum(acc, ov)
    if ov:
        raise ValueError(f"a host overflow word must be 0, got {ov}")
    return acc


def kdk_steps(state: ParticleState, cosmo: Cosmology, a_grid, acc_fn,
              box: float, g=None):
    """KDK over ``a_grid`` for a checked ``acc_fn(pos, mass, a) ->
    (g, overflow)``.

    ``g``: the force at ``state`` if the caller already has it (the last
    force of the previous call, at the same positions and a), so a run
    cut into several calls evaluates the force once per step plus once at
    the start.  Returns (state, g, overflow): the overflow words are
    reduced with max on the device and read on the host once, at the end."""
    a_grid = np.asarray(a_grid, dtype=np.float64)
    K1, Dr, K2, _ = cosmo_kick_drift_factors(cosmo, a_grid)
    pos, vel, mass = state.pos, state.vel, state.mass
    overflow = None
    if g is None:
        g, ov = acc_fn(pos, mass, float(state.time))
        overflow = _max_overflow(overflow, ov)
    for a1, k1, dr, k2 in zip(a_grid[1:], K1, Dr, K2):
        p_half = vel + g * float(k1)
        pos = torch.remainder(pos + p_half * float(dr), box)
        g, ov = acc_fn(pos, mass, float(a1))
        overflow = _max_overflow(overflow, ov)
        vel = p_half + g * float(k2)
    time = torch.as_tensor(float(a_grid[-1]), device=pos.device,
                           dtype=pos.dtype)
    return (state.replace(pos=pos, vel=vel, time=time), g,
            0 if overflow is None else int(overflow))


def run_cosmological_checked(state: ParticleState, cosmo: Cosmology, a_grid,
                             acc_fn, box: float):
    """Integrate comoving KDK from a_grid[0] to a_grid[-1] with a checked
    ``acc_fn(pos, mass, a) -> (g, overflow)``; returns
    (final_state, max overflow over every force evaluation)."""
    final, _, overflow = kdk_steps(state, cosmo, a_grid, acc_fn, box)
    return final, overflow


def run_cosmological(state: ParticleState, cosmo: Cosmology, a_grid,
                     acc_fn: CosmoForceFn, box: float) -> ParticleState:
    """Integrate comoving KDK from a_grid[0] to a_grid[-1];
    ``acc_fn(pos, mass, a) -> g`` is the canonical-momentum force and
    ``state.vel`` holds p = a^2 dx/dt."""
    final, _, _ = kdk_steps(state, cosmo, a_grid,
                            lambda p, m, a: (acc_fn(p, m, a), 0), box)
    return final
