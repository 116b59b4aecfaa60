"""Particle-Mesh (PM) gravity: CIC deposit -> FFT Poisson -> gradient ->
CIC gather.

Counterpart of :mod:`nbody.forces.pm`.  :class:`PMForce` holds
everything that depends only on the geometry as buffers built once on the
device: the k-space Green's function (with the deposit deconvolution and
the Gaussian or spline long-range filter folded in), the spectral
gradient kernels and the interlacing phases.  A force evaluation is then
deposit, one rfftn, one multiply, the inverse transform(s) and the gather.
No hand-written kernel is involved: the FFTs are cuFFT through
``torch.fft`` (:func:`~nbody_torch.mesh.grids.rfft3`, whose bits do not
depend on a leading member axis) and the scatter is the fixed-point,
deterministic :func:`~nbody_torch.mesh.cic.scatter_sum`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from nbody_torch.core.cosmology import Cosmology
from nbody_torch.mesh.cic import (
    cic_deposit,
    cic_deposit_interlaced_k,
    cic_gather_vec,
    cic_window,
    interlace_phase,
)
from nbody_torch.mesh.grids import irfft3, kvecs, rfft3

GRAD_ORDERS = ("spectral", "fd2", "fd4")


def pm_potential_k(pos, mass, box: float, nmesh: int, deconvolve_p: int = 2,
                   interlace: bool = False, grid_shift: float = 0.0):
    """-delta_k / k^2 on the rfft grid (unit source strength) from the CIC
    deposit of the particles; DC mode zero.  ``grid_shift`` (cells)
    offsets the deposit grid (0.5 = cell-centred)."""
    if interlace:
        rho_k = cic_deposit_interlaced_k(pos, box, nmesh, weights=mass,
                                         base_shift=grid_shift)
    else:
        rho_k = torch.fft.rfftn(
            cic_deposit(pos, box, nmesh, weights=mass, shift=grid_shift)
        )
    delta_k = rho_k / (torch.sum(mass) / nmesh**3)
    if deconvolve_p:
        W = cic_window(nmesh, box, p=deconvolve_p, device=pos.device,
                       dtype=pos.dtype)
        delta_k = delta_k / torch.clamp_min(W, 1e-8)
    kx, ky, kz = kvecs(nmesh, box, rfft=True, device=pos.device,
                       dtype=pos.dtype)
    k2 = kx**2 + ky**2 + kz**2
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    return -delta_k * inv_k2


def gradient_kernel(nmesh: int, box: float, order: str, *, device=None,
                    dtype=torch.float32):
    """k-space differentiation kernels replacing (kx, ky, kz):
    'spectral' i k (Nyquist zeroed), 'fd2' sin(kh)/h, 'fd4'
    (8 sin(kh) - sin(2kh)) / (6h)."""
    if order not in GRAD_ORDERS:
        raise ValueError(f"unknown gradient kernel {order!r}")
    h = box / nmesh
    ks = kvecs(nmesh, box, rfft=True, device=device, dtype=dtype,
               zero_nyquist=(order == "spectral"))
    if order == "spectral":
        return ks
    if order == "fd2":
        return tuple(torch.sin(k * h) / h for k in ks)
    return tuple(
        (8.0 * torch.sin(k * h) - torch.sin(2.0 * k * h)) / (6.0 * h)
        for k in ks
    )


@functools.lru_cache(maxsize=32)
def _spline_filter_radial(r_cut: float, k_max: float, n_tab: int = 4096):
    """Radial table of the spline-split long-range Green's function,
    psi_l_hat(k) / (4 pi) = 1/k^2 + I(k)/k with
    I(k) = r_cut int_0^1 (u q(u) - 1) sin(k r_cut u) du and
    q(u) = (35 - 35u^2 + 21u^4 - 5u^6)/16 (host numpy)."""
    u = np.linspace(0.0, 1.0, 8192)
    q = (35.0 - 35.0 * u**2 + 21.0 * u**4 - 5.0 * u**6) / 16.0
    g = u * q - 1.0
    ks = np.linspace(0.0, k_max, n_tab)
    I = r_cut * np.trapezoid(g[None, :] * np.sin(np.outer(ks, u) * r_cut), u,
                             axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        F = np.where(ks > 0, 1.0 / np.maximum(ks, 1e-30) ** 2
                     + I / np.maximum(ks, 1e-30), 0.0)
    F[0] = 0.0
    return ks, F


def _spline_longrange_filter_np(nmesh: int, box: float, r_cut: float):
    two_pi = 2.0 * np.pi
    k1 = np.fft.fftfreq(nmesh, d=box / nmesh) * two_pi
    kz = np.fft.rfftfreq(nmesh, d=box / nmesh) * two_pi
    km = np.sqrt(k1[:, None, None] ** 2 + k1[None, :, None] ** 2
                 + kz[None, None, :] ** 2)
    k_max = float(3.0**0.5 * np.pi * nmesh / box) * 1.0001
    ks, F = _spline_filter_radial(float(r_cut), k_max)
    return np.interp(km, ks, F)


def spline_longrange_filter(nmesh: int, box: float, r_cut: float, *,
                            device=None, dtype=torch.float32):
    """3D rfft-layout multiplier replacing 1/k^2 for the polynomial-spline
    force split (complement of the spline short-range weight)."""
    return torch.as_tensor(_spline_longrange_filter_np(nmesh, box, r_cut),
                           device=device, dtype=dtype)


def _fd_gradient_grids(phi, box: float, order: str):
    """Real-space centred-difference force grids (..., 3, N, N, N) of a
    potential (..., N, N, N), exactly the k-space sin kernels of
    :func:`gradient_kernel`."""
    h = box / phi.shape[-1]
    grids = []
    for ax in (-3, -2, -1):
        p1 = torch.roll(phi, -1, ax)
        m1 = torch.roll(phi, 1, ax)
        if order == "fd2":
            g = (p1 - m1) * (0.5 / h)
        else:
            p2 = torch.roll(phi, -2, ax)
            m2 = torch.roll(phi, 2, ax)
            g = (8.0 * (p1 - m1) - (p2 - m2)) * (1.0 / (12.0 * h))
        grids.append(-g)  # force = -grad phi
    return torch.stack(grids, dim=-4)


class PMForce(nn.Module):
    """Periodic PM acceleration acc = -grad phi, lap phi = amp * delta.

    Buffers, built once on the module's device: ``green`` (the rfft-layout
    factor taking delta_k to phi_k at unit amplitude: -1/k^2 with the
    deconvolution and the optional split filter folded in), ``grad``
    (3, ...) spectral kernels for ``grad_order='spectral'``, and the
    interlacing phases.  ``forward(pos, mass, amp)``.
    """

    def __init__(self, box: float, nmesh: int, *, deconvolve_p: int = 2,
                 interlace: bool = False, longrange_split: float = 0.0,
                 spline_split: float = 0.0, grad_order: str = "fd4",
                 grid_shift: float = 0.0, device=None, dtype=torch.float32):
        super().__init__()
        if grad_order not in GRAD_ORDERS:
            raise ValueError(f"unknown gradient kernel {grad_order!r}")
        self.box, self.nmesh = float(box), int(nmesh)
        self.interlace = bool(interlace)
        self.grad_order = grad_order
        self.grid_shift = float(grid_shift)
        kw = dict(device=device, dtype=torch.float64)
        kx, ky, kz = kvecs(nmesh, box, rfft=True, **kw)
        k2 = kx**2 + ky**2 + kz**2
        if spline_split > 0.0:
            green = -spline_longrange_filter(nmesh, box, spline_split, **kw)
        else:
            green = -torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                                 0.0)
            if longrange_split > 0.0:
                green = green * torch.exp(-k2 * longrange_split**2)
        if deconvolve_p:
            W = cic_window(nmesh, box, p=deconvolve_p, **kw)
            green = green / torch.clamp_min(W, 1e-8)
        self.register_buffer("green", green.to(dtype))
        if grad_order == "spectral":
            self.register_buffer(
                "grad", torch.stack(torch.broadcast_tensors(
                    *gradient_kernel(nmesh, box, "spectral", **kw))).to(dtype))
        if interlace:
            ctype = (torch.complex64 if dtype == torch.float32
                     else torch.complex128)
            self.register_buffer(
                "phase_read", interlace_phase(nmesh, box, 1.0, **kw).to(ctype))

    def force_grids_from_rho(self, rho, amp, mass_sum, rho1=None):
        """The mesh half of the solve with the deposit factored out: (3,
        N, N, N) force grids from a deposited mass grid ``rho`` (the
        supercell tier deposits with its own kernel).  With ``rho1``, the
        deposit at the half-cell shift, the two are alias-cancelled in k
        and both readback grid sets come back stacked (6, N, N, N): rows
        0-2 unshifted, rows 3-5 for the half-cell-shifted gather.  ``amp``
        multiplies the overdensity Poisson source; ``mass_sum`` is the
        total mass that ``rho`` holds at its mean.  B members' grids (B,
        N, N, N), with ``amp`` and ``mass_sum`` numbers or (B,), give (B,
        3 or 6, N, N, N) from batched FFTs (one grid is a batch of one)."""
        if rho1 is not None and not self.interlace:
            raise ValueError("a second deposit needs an interlaced PMForce")
        if self.grid_shift != 0.0:
            raise ValueError("force_grids_from_rho: grid_shift must be 0")
        if rho.ndim == 3:
            return self.force_grids_from_rho(
                rho[None], amp, mass_sum,
                None if rho1 is None else rho1[None])[0]
        rho_k = rfft3(rho)
        if rho1 is not None:
            # e^{-i k.d/2} aligns the shifted deposit
            rho_k = 0.5 * (rho_k + rfft3(rho1) * self.phase_read.conj())
        factor = torch.as_tensor(amp * self.nmesh**3 / mass_sum,
                                 dtype=self.green.dtype, device=rho.device)
        phi_k = rho_k * (self.green * factor.reshape(-1, 1, 1, 1))
        grids = self._force_grids(phi_k)
        if rho1 is None:
            return grids
        return torch.cat([grids, self._force_grids(phi_k * self.phase_read)],
                         dim=-4)

    def _force_grids(self, phi_k):
        if self.grad_order == "spectral":
            return torch.stack([irfft3(-1j * g * phi_k, self.nmesh)
                                for g in self.grad], dim=-4)
        phi = irfft3(phi_k, self.nmesh)
        return _fd_gradient_grids(phi, self.box, self.grad_order)

    def forward(self, pos, mass, amp):
        """The acceleration (n, 3) of particles ``pos`` (n, 3), ``mass``
        (n,); or of B members at once, ``pos`` (B, n, 3), ``mass`` (B, n)
        and ``amp`` a number or (B,), with one deposit over the members
        (:func:`~nbody_torch.mesh.cic.cic_deposit`) and batched FFTs over
        the last three dimensions (one set of particles is a batch of
        one)."""
        if pos.ndim == 2:
            return self(pos[None], mass[None], amp)[0]
        box, nmesh, shift = self.box, self.nmesh, self.grid_shift
        if self.interlace:
            rho_k = cic_deposit_interlaced_k(pos, box, nmesh, weights=mass,
                                             base_shift=shift)
        else:
            rho_k = rfft3(cic_deposit(pos, box, nmesh, weights=mass,
                                      shift=shift))
        factor = amp * nmesh**3 / torch.sum(mass, dim=-1)
        phi_k = rho_k * (self.green * factor[:, None, None, None])
        grids = self._force_grids(phi_k)
        if not self.interlace:
            return cic_gather_vec(grids, pos, box, shift=shift)
        # two-pass gather: the alias-cancelled potential read back from
        # the unshifted and the half-cell-shifted grid, averaged
        grids1 = self._force_grids(phi_k * self.phase_read)
        return 0.5 * (cic_gather_vec(grids, pos, box, shift=shift)
                      + cic_gather_vec(grids1, pos, box, shift=shift + 0.5))


@functools.lru_cache(maxsize=32)
def pm_module(box: float, nmesh: int, deconvolve_p: int = 2,
              interlace: bool = False, longrange_split: float = 0.0,
              spline_split: float = 0.0, grad_order: str = "fd4",
              grid_shift: float = 0.0, device="cuda",
              dtype=torch.float32) -> PMForce:
    """One :class:`PMForce` per geometry, device and dtype in a process,
    so the functional entry points build their buffers once; on the card
    unless ``device`` says otherwise."""
    return PMForce(box, nmesh, deconvolve_p=deconvolve_p,
                   interlace=interlace, longrange_split=longrange_split,
                   spline_split=spline_split, grad_order=grad_order,
                   grid_shift=grid_shift, device=device, dtype=dtype)


def pm_acc(pos, mass, box: float, nmesh: int, G: float = 1.0,
           deconvolve_p: int = 2, interlace: bool = False,
           longrange_split: float = 0.0, spline_split: float = 0.0,
           grad_order: str = "fd4", cell_centered: bool = False):
    """Newtonian periodic PM acceleration, lap phi = 4 pi G (rho - rho_mean).

    ``longrange_split`` > 0 applies the Gaussian filter exp(-k^2 r_s^2);
    ``spline_split`` > 0 (an r_cut) swaps 1/k^2 for the spline long-range
    filter.  ``cell_centered`` offsets the deposit/gather grid by half a
    cell."""
    pm = pm_module(float(box), int(nmesh), int(deconvolve_p), bool(interlace),
                   float(longrange_split), float(spline_split), grad_order,
                   0.5 if cell_centered else 0.0, pos.device, pos.dtype)
    return pm(pos, mass,
              4.0 * math.pi * G * torch.sum(mass, dim=-1) / box**3)


def make_pm_cosmo_force(cosmo: Cosmology, box: float, nmesh: int,
                        deconvolve_p: int = 2, interlace: bool = False,
                        grad_order: str = "fd4", cell_centered: bool = False,
                        *, device="cuda", dtype=torch.float32):
    """Comoving canonical-momentum force g(pos, mass, a) = -grad phi with
    lap phi = (3/2) Omega_m H0^2 delta / a, its buffers on ``device`` (the
    card unless the caller asks for the CPU)."""
    base = 1.5 * cosmo.Omega_m * cosmo.H0**2
    pm = pm_module(float(box), int(nmesh), int(deconvolve_p), bool(interlace),
                   0.0, 0.0, grad_order, 0.5 if cell_centered else 0.0,
                   torch.device(device), dtype)

    def acc_fn(pos, mass, a):
        return pm(pos, mass, base / a)

    return acc_fn
