"""Transpose-decomposed 3-D FFT of an x-slab-sharded grid.

Counterpart of :mod:`nbody.distributed.fft`.  The real grid lives in
x-slabs, one a shard, and the 3-D transform is a local rfft over z, a
local fft over y, one ``all_to_all`` (y scatters, x gathers) and a local
fft over x.  The k-space result is y-sharded ("transposed order");
:func:`kvecs_slab` gives each shard's wavevectors in that layout, and the
inverse runs the conjugate path back to x-slabs.  The 1-D transforms are
``torch.fft`` (cuFFT on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_torch.distributed.collectives import ShardGroup


def slab_rfftn(grids: list, group: ShardGroup) -> list:
    """Forward rfftn of the shards' (X/D, Y, Z) real slabs -> their
    (X, Y/D, Z//2 + 1) complex blocks of the global rfftn."""
    h = [torch.fft.fft(torch.fft.rfft(g, dim=2), dim=1) for g in grids]
    h = group.all_to_all(h, split_dim=1, concat_dim=0)
    return [torch.fft.fft(x, dim=0) for x in h]


def slab_irfftn(hks: list, nmesh: int, group: ShardGroup) -> list:
    """Inverse of :func:`slab_rfftn`: (X, Y/D, Z//2 + 1) blocks -> the
    shards' (X/D, Y, Z) real slabs."""
    h = [torch.fft.ifft(x, dim=0) for x in hks]
    h = group.all_to_all(h, split_dim=0, concat_dim=1)
    return [torch.fft.irfft(torch.fft.ifft(x, dim=1), n=nmesh, dim=2)
            for x in h]


def kvecs_slab(nmesh: int, box: float, d: int, n_dev: int,
               dtype=torch.float32, device=None):
    """Shard d's wavevectors in the transposed layout: (kx (X, 1, 1),
    ky (1, Y/D, 1), kz (1, 1, Z//2 + 1)), ky its slice of the fftfreq
    row."""
    two_pi = 2.0 * np.pi
    k1 = np.fft.fftfreq(nmesh, d=box / nmesh) * two_pi
    kz = np.fft.rfftfreq(nmesh, d=box / nmesh) * two_pi
    nyl = nmesh // n_dev
    ky = k1[d * nyl:(d + 1) * nyl]

    def t(a, shape):
        return torch.as_tensor(a, dtype=dtype, device=device).reshape(shape)

    return t(k1, (-1, 1, 1)), t(ky, (1, -1, 1)), t(kz, (1, 1, -1))


def slab_filter(radial_fn, nmesh: int, box: float, d: int, n_dev: int,
                dtype=torch.float32, device=None):
    """An isotropic k-space multiplier ``radial_fn(k^2)`` on shard d's
    transposed layout."""
    kx, ky, kz = kvecs_slab(nmesh, box, d, n_dev, dtype, device)
    return radial_fn(kx**2 + ky**2 + kz**2)
