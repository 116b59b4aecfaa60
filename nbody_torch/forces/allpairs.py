"""Direct-summation O(N^2) gravity: the dense oracles.

Counterpart of :mod:`nbody.forces.allpairs`.  Dense tensor code with exact
self-interaction handling, float64 on the CPU in the tests.  The force
path is :mod:`nbody_torch.forces.pallas_pp` (K7), whose plain version is
built from :func:`_pair_terms`.

Force law (Plummer softening): a_i = G sum_j m_j (x_j - x_i) / (r^2 + eps^2)^{3/2}
Potential (consistent pair kernel): phi_ij = -G m_i m_j / sqrt(r^2 + eps^2)
"""

from __future__ import annotations

import torch

from nbody_torch.forces.p3m import _min_image


def _pair_terms(pos_i, pos_j, mass_j, eps2, box: float = 0.0):
    """Per-target accelerations and potentials from a block of sources.

    pos_i: (Ni, 3); pos_j: (Nj, 3); mass_j: (Nj,).  ``box > 0`` takes the
    minimum image of each separation (``torch.round`` rounds half to even,
    as ``jnp.round`` in the TPU kernel does).
    Returns acc (Ni, 3) [without G], pot (Ni,) [without -G, per unit mass_i].
    Self-pairs (identical positions) contribute zero force but DO contribute
    m / eps to the potential; callers mask or subtract them.
    """
    d = pos_j[None, :, :] - pos_i[:, None, :]          # (Ni, Nj, 3)
    if box > 0.0:
        d = _min_image(d, box)
    r2 = torch.sum(d * d, dim=-1) + eps2               # (Ni, Nj)
    inv_r = torch.rsqrt(r2)
    inv_r3 = inv_r / r2
    w = mass_j[None, :] * inv_r3                       # (Ni, Nj)
    acc = torch.einsum("ij,ijk->ik", w, d)
    pot = torch.sum(mass_j[None, :] * inv_r, dim=1)
    return acc, pot


def _dense_inv(r2, power: float):
    """r2 ** power off the diagonal, 0 on it (the self pairs)."""
    n = r2.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=r2.device)
    r2 = torch.where(eye, torch.ones_like(r2), r2)   # avoid 0^(-3/2) at eps=0
    return torch.where(eye, torch.zeros_like(r2), r2 ** power)


def direct_acc(pos, mass, eps: float = 0.0, G: float = 1.0):
    """Dense all-pairs acceleration, exact self-masking. O(N^2) memory."""
    d = pos[None, :, :] - pos[:, None, :]
    r2 = torch.sum(d * d, dim=-1) + eps**2
    w = mass[None, :] * _dense_inv(r2, -1.5)
    return G * torch.einsum("ij,ijk->ik", w, d)


def direct_potential(pos, mass, eps: float = 0.0, G: float = 1.0):
    """Total potential energy E_pot = -G sum_{i<j} m_i m_j / sqrt(r^2+eps^2)."""
    d = pos[None, :, :] - pos[:, None, :]
    r2 = torch.sum(d * d, dim=-1) + eps**2
    pair = mass[:, None] * mass[None, :] * _dense_inv(r2, -0.5)
    return -0.5 * G * torch.sum(pair)


def direct_acc_chunked(pos, mass, eps: float = 0.0, G: float = 1.0,
                       chunk: int = 1024):
    """All-pairs acceleration + E_pot with O(chunk * N) memory: a loop over
    blocks of ``chunk`` targets.

    Oracle for N too large for the dense (N,N,3) tensor.  For eps > 0 the
    self-pair adds zero force and a known m_i/eps potential term that is
    subtracted; for eps == 0 zero-distance pairs are masked.
    """
    n = pos.shape[0]
    acc = torch.empty_like(pos)
    pot = torch.empty_like(mass)
    for i0 in range(0, n, chunk):
        pos_i = pos[i0:i0 + chunk]
        if eps > 0:
            a, p = _pair_terms(pos_i, pos, mass, eps**2)
        else:
            d = pos[None, :, :] - pos_i[:, None, :]
            r2 = torch.sum(d * d, dim=-1)
            pos_r2 = r2 > 0
            inv_r = torch.where(
                pos_r2, torch.rsqrt(torch.where(pos_r2, r2, torch.ones_like(r2))),
                torch.zeros_like(r2))
            w = mass[None, :] * inv_r**3
            a = torch.einsum("ij,ijk->ik", w, d)
            p = torch.sum(mass[None, :] * inv_r, dim=1)
        acc[i0:i0 + chunk] = a
        pot[i0:i0 + chunk] = p
    if eps > 0:
        pot = pot - mass / eps  # strip self-term
    pot = -G * mass * pot
    return acc * G, 0.5 * torch.sum(pot)


def direct_acc_periodic(pos, mass, box: float, eps: float = 0.0,
                        G: float = 1.0):
    """Dense all-pairs acceleration with periodic minimum-image separations.

    Nearest image only (no Ewald sum): the oracle for the periodic K7
    (``allpairs_pallas(..., box=L)``).  O(N^2) memory.
    """
    d = pos[None, :, :] - pos[:, None, :]
    d = d - box * torch.round(d / box)
    r2 = torch.sum(d * d, dim=-1) + eps**2
    w = mass[None, :] * _dense_inv(r2, -1.5)
    return G * torch.einsum("ij,ijk->ik", w, d)
