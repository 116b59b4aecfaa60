"""Exact periodic PP gravity via Ewald summation.

Counterpart of :mod:`nbody.forces.ewald`:

  * real-space part: the erfc-split short-range pair force
    C(r) = erfc(r/2r_s) + (r/r_s)/sqrt(pi) exp(-r^2/4r_s^2), summed over
    minimum images by K1 (:func:`nbody_torch.forces.p3m.p3m_short_acc`
    with the Gaussian split) with r_s = box/16: at r = box/2 the tail is
    < 1e-6, so one image suffices;
  * k-space part: the Gaussian-filtered long-range force evaluated
    exactly per particle from the structure factor,

      F(x_i) = -(4 pi G / V) sum_k (k/k^2) e^{-k^2 r_s^2}
               [sin(k.x_i) C_k - cos(k.x_i) S_k],
      C_k = sum_j m_j cos(k.x_j),  S_k = sum_j m_j sin(k.x_j),

    plain tensor code: a (N, 3) x (3, K) phase product, cos/sin and
    products with the (K, 3) weights, streamed over chunks of modes so
    the (N, K) phase matrix never materializes whole.  The JAX package
    computes this half outside any Pallas kernel too.  B members take it
    member by member: the same products over a member axis (one (B N, 3)
    x (3, K) product, batched block sums and (N, K) x (K, 3) products)
    rounded a member otherwise than its own call on the H100
    (``tests/test_torch_cuda.py::test_ewald_batched_equals_single_calls``),
    where each member's own products give it its own bits.

The k-space products run in full float32 on the card whatever the
process's TF32 setting: TF32 keeps ~3 decimal digits, an error of ~0.03
rad on phases of up to ~100 rad.  The structure factors C_k, S_k are
sums over all particles that cancel to ~1e-4 of their terms in a
near-uniform state, so they are taken in float32 over blocks of
:data:`_BLOCK` particles and the blocks added in float64 (one float32
sum over 32,768 particles of the default 32^3 ICs errs by ~2e-4 of the
k-space force; the blocked sum by ~2e-5).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _half_space_modes(n_max: int) -> np.ndarray:
    """Integer mode vectors n with |n| <= n_max, one of each +/-k pair
    (k-space sum contributions are even under k -> -k, so the half space
    counts double)."""
    r = np.arange(-n_max, n_max + 1)
    n = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    n2 = (n**2).sum(axis=1)
    half = (
        (n[:, 2] > 0)
        | ((n[:, 2] == 0) & (n[:, 1] > 0))
        | ((n[:, 2] == 0) & (n[:, 1] == 0) & (n[:, 0] > 0))
    )
    keep = half & (n2 > 0) & (n2 <= n_max**2)
    return n[keep]


#: particles per float32 partial sum of the structure factors
_BLOCK = 256


def _structure_sum(mass, trig, dtype=None):
    """sum_j mass_j trig_j for each mode: (chunk,) from (N,), (N, chunk),
    N a multiple of _BLOCK; float32 partial sums over blocks of particles,
    added in float64, returned in ``dtype`` (default ``trig``'s)."""
    nb = mass.shape[0] // _BLOCK
    parts = torch.bmm(mass.view(nb, 1, _BLOCK),
                      trig.view(nb, _BLOCK, trig.shape[1]))
    return parts.sum(dim=(0, 1), dtype=torch.float64).to(dtype or trig.dtype)


@contextlib.contextmanager
def _full_precision_matmul():
    """float32 matrix products in full float32 (no TF32) inside."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def ewald_kspace_acc(
    pos,
    mass,
    box: float,
    G: float = 1.0,
    r_s: float | None = None,
    n_max: int = 10,
    chunk: int = 512,
):
    """The k-space (long-range) half of the Ewald force: (N, 3) for
    ``pos`` (N, 3); B members' ``pos`` (B, N, 3) and ``mass`` (B, N) give
    (B, N, 3), each member's structure sums and products its own (the
    bits of its own call)."""
    if pos.ndim == 3:
        return torch.stack([ewald_kspace_acc(p, m, box, G=G, r_s=r_s,
                                             n_max=n_max, chunk=chunk)
                            for p, m in zip(pos, mass)])
    if r_s is None:
        r_s = box / 16.0
    dtype, dev = pos.dtype, pos.device
    mass = mass.to(dtype)
    n = _half_space_modes(n_max)
    K = n.shape[0]
    pad = -(-K // chunk) * chunk
    kv = np.zeros((pad, 3))
    kv[:K] = n * (2.0 * np.pi / box)
    k2 = (kv**2).sum(axis=1)
    w = np.zeros(pad)
    w[:K] = np.exp(-k2[:K] * float(r_s) ** 2) / k2[:K]
    kvecs = torch.as_tensor(kv, dtype=dtype, device=dev)
    wk = torch.as_tensor(w, dtype=dtype, device=dev)

    # zero-mass padding particles (at the origin) fill the last block
    npart = pos.shape[0]
    nblk = -(-npart // _BLOCK) * _BLOCK
    pos_p = torch.nn.functional.pad(pos, (0, 0, 0, nblk - npart))
    mass_p = torch.nn.functional.pad(mass, (0, nblk - npart))
    acc = torch.zeros_like(pos_p)
    with _full_precision_matmul():
        for c0 in range(0, pad, chunk):
            kc, wc = kvecs[c0:c0 + chunk], wk[c0:c0 + chunk]
            phase = pos_p @ kc.T  # (N, chunk)
            c = torch.cos(phase)
            s = torch.sin(phase)
            Ck = _structure_sum(mass_p, c)  # (chunk,)
            Sk = _structure_sum(mass_p, s)
            kw = kc * wc[:, None]  # (chunk, 3)
            acc = acc + s @ (kw * Ck[:, None]) - c @ (kw * Sk[:, None])
    # x2 for the mirrored -k half space
    return acc[:npart] * (-2.0 * 4.0 * np.pi * G / box**3)


def ewald_pp_acc(
    pos,
    mass,
    box: float,
    eps: float = 0.0,
    G: float = 1.0,
    r_s: float | None = None,
    n_max: int = 10,
    softening: str = "plummer",
):
    """Exact periodic direct-summation force (Ewald), softened.

    Real-space erfc part over minimum images (K1, r_cut = 0.4999 box) plus
    the exact k-space structure-factor sum.  With the defaults (r_s =
    box/16, n_max = 10) both truncations are below 1e-5 relative.  The
    softening applies to the short-range Newton term exactly as in the
    non-periodic solver.  B members, ``pos`` (B, N, 3) and ``mass``
    (B, N), make one K1 launch (its batched site) and each member's
    k-space sums: (B, N, 3), each member the bits of its own call.
    """
    from nbody_torch.forces.p3m import p3m_short_acc

    mass = mass.to(pos.dtype)
    if r_s is None:
        r_s = box / 16.0
    acc_sr = p3m_short_acc(
        pos, mass, box, float(eps), float(r_s), 0.4999 * box, G=G,
        split="gaussian", softening=softening,
    )
    acc_lr = ewald_kspace_acc(pos, mass, box, G=G, r_s=float(r_s),
                              n_max=n_max)
    return acc_sr + acc_lr


def ewald_potential_energy(
    pos,
    mass,
    box: float,
    G: float = 1.0,
    r_s: float | None = None,
    n_max: int = 10,
):
    """Exact periodic potential energy W = 1/2 sum_i m_i phi(x_i) with
    lap(phi) = 4 pi G (rho - rho_mean): the Ewald energy matching
    :func:`ewald_pp_acc` with eps = 0 (dense; diagnostics and tests).

    Standard Ewald energy (alpha = 1/(2 r_s)), gravity signs:

      U = -G [ U_real + U_k + U_self + U_bg ],
      U_real = 1/2 sum_{i!=j} m_i m_j erfc(alpha r_ij)/r_ij   (min image)
      U_k    = (2 pi / V) sum_{k!=0} e^{-k^2/4a^2}/k^2 |S(k)|^2
      U_self = -(alpha/sqrt(pi)) sum m_i^2
      U_bg   = -(pi / (2 V alpha^2)) (sum m_i)^2
    """
    if r_s is None:
        r_s = box / 16.0
    dtype, dev = pos.dtype, pos.device
    mass = mass.to(dtype)
    alpha = 1.0 / (2.0 * float(r_s))
    n = pos.shape[0]
    d = pos[None, :, :] - pos[:, None, :]
    d = d - box * torch.round(d / box)
    r = torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=-1), 1e-300))
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    pair = mass[:, None] * mass[None, :] * torch.special.erfc(alpha * r) / r
    U_real = 0.5 * torch.sum(torch.where(off, pair, torch.zeros_like(pair)))

    modes = _half_space_modes(n_max)
    kv = torch.as_tensor(modes * (2.0 * np.pi / box), dtype=dtype, device=dev)
    k2 = torch.sum(kv**2, dim=1)
    w = torch.exp(-k2 * float(r_s) ** 2) / k2
    with _full_precision_matmul():
        phase = pos @ kv.T  # (N, K)
        Ck = mass @ torch.cos(phase)
        Sk = mass @ torch.sin(phase)
    # x2: half space counts both +k and -k (|S(k)|^2 even)
    U_k = (2.0 * np.pi / box**3) * 2.0 * torch.sum(w * (Ck**2 + Sk**2))

    U_self = -(alpha / np.sqrt(np.pi)) * torch.sum(mass**2)
    U_bg = -(np.pi / (2.0 * box**3 * alpha**2)) * torch.sum(mass) ** 2
    return -G * (U_real + U_k + U_self + U_bg)
