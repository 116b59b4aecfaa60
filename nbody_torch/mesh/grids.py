"""Fourier-grid and lattice helpers shared by mesh ops, ICs and PM.

Counterpart of :mod:`nbody.mesh.grids`; every function builds on the host
in float64 and returns tensors on the requested device and dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def _kvecs_np(nmesh: int, box: float, rfft: bool = True,
              zero_nyquist: bool = False):
    two_pi = 2.0 * np.pi
    k1 = np.fft.fftfreq(nmesh, d=box / nmesh) * two_pi
    kzl = np.fft.rfftfreq(nmesh, d=box / nmesh) * two_pi if rfft else k1.copy()
    if zero_nyquist and nmesh % 2 == 0:
        k1 = k1.copy()
        k1[nmesh // 2] = 0.0
        kzl[-1 if rfft else nmesh // 2] = 0.0
    return k1[:, None, None], k1[None, :, None], kzl[None, None, :]


def kvecs(nmesh: int, box: float, rfft: bool = True, *, device=None,
          dtype=torch.float32, zero_nyquist: bool = False):
    """Angular wavevector components k_i = 2 pi n_i / box, broadcastable
    to the (r)fft grid shape.  ``zero_nyquist=True`` zeros the Nyquist
    plane (needed for spectral i k_j differentiation)."""
    return tuple(
        torch.as_tensor(k, device=device, dtype=dtype)
        for k in _kvecs_np(nmesh, box, rfft, zero_nyquist)
    )


def kmag(nmesh: int, box: float, rfft: bool = True, *, device=None,
         dtype=torch.float32):
    kx, ky, kz = kvecs(nmesh, box, rfft=rfft, device=device, dtype=dtype)
    return torch.sqrt(kx**2 + ky**2 + kz**2)


def rfft_mode_weights(nmesh: int, *, device=None, dtype=torch.float32):
    """Multiplicity of each rfft-layout mode in the full fftn grid
    (1 on the kz=0 and kz=Nyquist planes, else 2)."""
    w = np.full(nmesh // 2 + 1, 2.0)
    w[0] = 1.0
    if nmesh % 2 == 0:
        w[-1] = 1.0
    return torch.as_tensor(w, device=device, dtype=dtype)[None, None, :]


def lattice(nmesh: int, box: float, *, device=None, dtype=torch.float32):
    """(nmesh^3, 3) particle lattice on grid nodes, x-major like
    ``nbody.mesh.grids.lattice``."""
    x = torch.as_tensor(np.arange(nmesh) * (box / nmesh), device=device,
                        dtype=dtype)
    X, Y, Z = torch.meshgrid(x, x, x, indexing="ij")
    return torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)


def rfft3(x):
    """The rfftn of the last three dimensions of ``x``, taken as a batch
    of grids (one grid is a batch of one).  cuFFT's 3-D real-to-complex
    plan for a grid with no batch axis rounds differently from its plan
    for a batch, while the batched plans of 1, 2, 4 and 8 grids of 32^3,
    64^3 and 128^3 give the same bits for every grid
    (``chip_smoke.py`` [24] holds the members of a batch equal to their
    own runs), so a member of a batch gets the bits of its own run."""
    n = x.shape[-3:]
    return torch.fft.rfftn(x.reshape((-1,) + tuple(n)),
                           dim=(-3, -2, -1)).reshape(
        x.shape[:-1] + (n[-1] // 2 + 1,))


def irfft3(k, n: int):
    """The inverse of :func:`rfft3` to real grids of side ``n``, likewise
    taken as a batch of grids."""
    shape = k.shape[:-3] + (n, n, n)
    return torch.fft.irfftn(k.reshape((-1,) + tuple(k.shape[-3:])),
                            s=(n, n, n), dim=(-3, -2, -1)).reshape(shape)
