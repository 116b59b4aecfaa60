"""Sharded power spectrum of a slab-resident state, and of the domain
ICs' own realization.

Counterpart of :func:`nbody.distributed.measure.measure_powerspec_domain`
and :func:`~nbody.distributed.measure.realized_spectrum_domain`: each
shard deposits its particles onto its mesh slab (or draws its slab of the
ICs' white noise), the distributed FFT gives its y-slab of k space, it
bins its own |delta_k|^2 into (modes, power, k) tables, and one psum adds
the tables.  Nothing larger than nmesh^3 / D lives on a shard.
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_torch.distributed.collectives import ShardGroup
from nbody_torch.distributed.domain import slab_bspline_deposit
from nbody_torch.distributed.fft import kvecs_slab, slab_rfftn
from nbody_torch.distributed.ic import slab_delta1_k
from nbody_torch.mesh.cic import scatter_sum
from nbody_torch.mesh.spectrum import PowerSpectrumResult


def _rfft_z_weights(nmesh: int) -> np.ndarray:
    """Each rfft z-plane's count in the full grid: 1, 2, ..., 2, 1 (the
    last 1 for even nmesh)."""
    wz = np.full(nmesh // 2 + 1, 2.0)
    wz[0] = 1.0
    if nmesh % 2 == 0:
        wz[-1] = 1.0
    return wz


def _bin_index(km, edges, n_bins: int):
    """Each mode's bin on ``edges`` (n_bins for a mode outside them)."""
    e = torch.as_tensor(edges, dtype=km.dtype, device=km.device)
    idx = torch.clamp(torch.searchsorted(e, km.reshape(-1).contiguous(),
                                         right=True) - 1, -1, n_bins)
    return torch.where(idx < 0, n_bins, idx)


def measure_powerspec_domain(shards: list, group: ShardGroup, *, box: float,
                             nmesh: int, n_global: int, edges,
                             deconvolve_p: int = 1, window_order: int = 2,
                             interlace: bool = False,
                             convention: str = "grid"):
    """(raw, corrected) :class:`PowerSpectrumResult` of the shards'
    particles on the bins of ``edges`` (CIC, TSC or PCS by
    ``window_order``; ``deconvolve_p`` assignments divided out of the
    corrected power; ``interlace`` adds the half-cell-shifted deposit;
    ``convention`` "grid" (V / N^6) or "fac" (/ 2 pi)).  The tables are on
    shard 0's device."""
    D = group.size
    if nmesh % D:
        raise ValueError(f"nmesh={nmesh} not divisible by {D} devices")
    edges = np.asarray(edges, np.float64)
    n_bins = len(edges) - 1
    V = float(box) ** 3
    if convention == "grid":
        norm = V / float(nmesh) ** 6
    elif convention == "fac":
        norm = V / float(nmesh) ** 6 / (2.0 * np.pi)
    else:
        raise ValueError(f"unknown convention {convention!r}")
    mean_cell = n_global / float(nmesh) ** 3
    h_cell = box / nmesh
    pos = [s.pos for s in shards]
    counts = [(s.mass > 0).to(s.pos.dtype) for s in shards]
    kw = dict(box=box, nmesh=nmesh, group=group, order=window_order)
    k0 = slab_rfftn([g / mean_cell - 1.0 for g in
                     slab_bspline_deposit(pos, counts, **kw)], group)
    if interlace:
        k1 = slab_rfftn([g / mean_cell - 1.0 for g in
                         slab_bspline_deposit(pos, counts, shift=0.5, **kw)],
                        group)
    wz = _rfft_z_weights(nmesh)
    tables = []
    for d in range(D):
        dtype, dev = pos[d].dtype, pos[d].device
        kx, ky, kz = kvecs_slab(nmesh, box, d, D, dtype, dev)
        delta_k = k0[d]
        if interlace:
            ph = torch.exp(-1j * ((kx + ky + kz) * (h_cell / 2.0)))
            delta_k = 0.5 * (k0[d] + k1[d] * ph)
        pk3 = torch.abs(delta_k) ** 2 * norm

        def sinc(k):
            return torch.sinc(k * (h_cell / (2.0 * np.pi)))

        W = (sinc(kx) * sinc(ky) * sinc(kz)) ** (
            2 * window_order * deconvolve_p)
        pk3_c = pk3 / torch.clamp_min(W, 1e-12)
        km = torch.sqrt(kx**2 + ky**2 + kz**2).expand(delta_k.shape)
        mult = torch.as_tensor(wz, dtype=dtype, device=dev).expand(
            delta_k.shape).reshape(-1)
        idx = _bin_index(km, edges, n_bins)

        def binned(w):
            return scatter_sum(n_bins + 1, idx, w)[:n_bins]

        tables.append(torch.stack([
            binned(mult), binned(mult * pk3.reshape(-1)),
            binned(mult * pk3_c.reshape(-1)), binned(mult * km.reshape(-1))]))
    cnts, psum_r, psum_c, ksum = group.psum(tables)[0]
    return _results_from_bins(cnts, psum_r, psum_c, ksum, edges)


def _results_from_bins(cnts, psum_r, psum_c, ksum, edges):
    safe = torch.clamp_min(cnts, 1.0)
    geo = torch.as_tensor(np.sqrt(edges[:-1] * edges[1:]), dtype=cnts.dtype,
                          device=cnts.device)
    k_centers = torch.where(cnts > 0, ksum / safe, geo)
    zero = torch.zeros_like(cnts)
    raw = PowerSpectrumResult(k=k_centers,
                              power=torch.where(cnts > 0, psum_r / safe, zero),
                              n_modes=cnts)
    corr = PowerSpectrumResult(k=k_centers,
                               power=torch.where(cnts > 0, psum_c / safe,
                                                 zero),
                               n_modes=cnts)
    return raw, corr


def realized_spectrum_domain(seed: int, spec, power, group: ShardGroup,
                             edges, *, noise=None, dtype=torch.float32):
    """The binned spectrum of the domain ICs' own linear realization at
    a = 1, slab by slab: the draw of
    :func:`nbody_torch.distributed.ic.lpt_ic_domain` for ``seed`` (or the
    same ``noise``), with its amplitudes, binned on ``edges`` with the
    rfft z-planes counted once or twice.  Dividing the corrected P(k)
    column by P_theory / P_realized cancels the domain run's own sample
    variance bin by bin.  Returns a :class:`PowerSpectrumResult` on shard
    0's device."""
    nmesh, box = spec.nmesh, spec.box
    D = group.size
    edges = np.asarray(edges, np.float64)
    n_bins = len(edges) - 1
    norm = float(box) ** 3 / float(nmesh) ** 6
    wz = _rfft_z_weights(nmesh)
    tables = []
    for d, dk in enumerate(slab_delta1_k(seed, spec, power, group,
                                         noise=noise, dtype=dtype)):
        kx, ky, kz = kvecs_slab(nmesh, box, d, D, dtype, dk.device)
        km = torch.sqrt(kx**2 + ky**2 + kz**2).expand(dk.shape)
        pk3 = (torch.abs(dk) ** 2 * norm).reshape(-1)
        mult = torch.as_tensor(wz, dtype=dtype, device=dk.device).expand(
            dk.shape).reshape(-1)
        idx = _bin_index(km, edges, n_bins)

        def binned(w):
            return scatter_sum(n_bins + 1, idx, w)[:n_bins]

        tables.append(torch.stack([binned(mult), binned(mult * pk3),
                                   binned(mult * km.reshape(-1))]))
    cnts, ps, ks = group.psum(tables)[0]
    return _results_from_bins(cnts, ps, ps, ks, edges)[0]
