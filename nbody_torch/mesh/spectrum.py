"""Matter power-spectrum estimation.

Counterpart of :mod:`nbody.mesh.spectrum`: rfftn, mode-multiplicity
weights for the Hermitian half-space and a weighted bincount over
spherical k bins.  Conventions "grid" (P = |delta_k|^2 V / N^6) and "fac"
(that over 2 pi) as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nbody_torch.mesh.cic import cic_window, scatter_sum
from nbody_torch.mesh.grids import kmag, rfft_mode_weights


class PowerSpectrumResult(NamedTuple):
    k: torch.Tensor        # bin-averaged |k| (geometric centre if empty)
    power: torch.Tensor    # bin-averaged P(k); 0 in empty bins
    n_modes: torch.Tensor  # modes per bin


def concept_bin_edges(
    box: float,
    nmesh: int,
    bins_per_decade=((4.0, 4.0), (100.0, 40.0)),
    k_max: str | float = "nyquist",
) -> np.ndarray:
    """CONCEPT-style variable-density k-bin edges: the local bins per
    decade is interpolated in log10 k between anchors given in units of
    the fundamental mode; edges walk k -> k 10^(1/bpd(k)) up to
    ``k_max`` ('nyquist', 'corner' or a value)."""
    k_min = 2.0 * np.pi / box
    if k_max == "nyquist":
        k_hi = np.pi * nmesh / box
    elif k_max == "corner":
        k_hi = k_min * nmesh * np.sqrt(3.0) / 2.0
    else:
        k_hi = float(k_max)
    k_hi = k_hi * 1.0000001
    anchors = sorted((float(m), float(b)) for m, b in bins_per_decade)
    log_ks = np.log10([k_min * m for m, _ in anchors])
    bpds = np.array([b for _, b in anchors])
    edges = [k_min * 0.999]
    k = k_min
    while k < k_hi:
        bpd = float(np.interp(np.log10(k), log_ks, bpds))
        k = k * 10.0 ** (1.0 / bpd)
        edges.append(min(k, k_hi))
    return np.asarray(edges)


def power_spectrum(
    delta,
    box: float,
    n_bins: int = 64,
    deconvolve_p: int = 0,
    convention: str = "grid",
    is_fourier: bool = False,
    edges=None,
    window_order: int = 2,
) -> PowerSpectrumResult:
    """Spherically averaged P(k) of a real overdensity grid (or of its
    rfftn with ``is_fourier=True``).  ``deconvolve_p`` assignments are
    divided out at amplitude level (P / prod sinc^(2 order p)); ``edges``
    overrides the default ``n_bins`` log bins from the fundamental to the
    corner mode."""
    delta_k = delta if is_fourier else torch.fft.rfftn(delta)
    nmesh = delta.shape[0]
    dtype, device = delta_k.real.dtype, delta_k.device
    if convention == "grid":
        norm = box**3 / float(nmesh) ** 6
    elif convention == "fac":
        norm = box**3 / float(nmesh) ** 6 / (2.0 * np.pi)
    else:
        raise ValueError(f"unknown convention {convention!r}")

    pk3 = torch.abs(delta_k) ** 2 * norm
    if deconvolve_p:
        W = cic_window(nmesh, box, p=2 * window_order * deconvolve_p,
                       device=device, dtype=dtype)
        pk3 = pk3 / torch.clamp_min(W, 1e-12)

    km = kmag(nmesh, box, rfft=True, device=device, dtype=dtype)
    mult = rfft_mode_weights(nmesh, device=device, dtype=dtype).expand(km.shape)
    if edges is None:
        k_fund = 2.0 * np.pi / box
        k_max = k_fund * nmesh * np.sqrt(3.0) / 2.0 * 1.0000001
        edges = np.geomspace(k_fund * 0.999, k_max, n_bins + 1)
    else:
        n_bins = len(edges) - 1
    edges_t = torch.as_tensor(np.asarray(edges), device=device, dtype=dtype)
    kr = km.reshape(-1)
    idx = torch.searchsorted(edges_t, kr, right=True) - 1
    # modes below the first edge (the DC mode) and past the last go to
    # the overflow bin n_bins, which is dropped
    idx = torch.where((idx < 0) | (idx > n_bins), n_bins, idx)

    w = mult.reshape(-1)

    def binsum(v):
        return scatter_sum(n_bins + 1, idx, v.to(dtype))[:n_bins]

    counts = binsum(w)
    psum = binsum(w * pk3.reshape(-1))
    ksum = binsum(w * kr)
    safe = torch.clamp_min(counts, 1.0)
    k_centers = torch.where(counts > 0, ksum / safe,
                            torch.sqrt(edges_t[:-1] * edges_t[1:]))
    power = torch.where(counts > 0, psum / safe, torch.zeros_like(psum))
    return PowerSpectrumResult(k=k_centers, power=power, n_modes=counts)
