"""Gaussian random field realization.

Counterpart of :mod:`nbody.ic.gaussian`: unit real white noise, FFT'd, so
the Hermitian symmetry of delta(k) is structural, scaled by
sqrt(P(k) N^3 / V).  The noise comes from an explicit ``torch.Generator``
or is handed in (a test feeds the JAX package's own noise, since JAX's
threefry and torch's Philox give different numbers for one seed).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from nbody_torch.mesh.grids import irfft3, kmag, rfft3


@dataclasses.dataclass(frozen=True)
class GRFSpec:
    """Specification of a Gaussian random field realization."""

    nmesh: int
    box: float
    convention: str = "grid"   # or "fac" (reference parity)


def white_noise_k(nmesh: int, generator: torch.Generator | None = None, *,
                  noise=None, device="cuda", dtype=torch.float32):
    """rfftn of unit real white noise: Hermitian, <|w_k|^2> = N^3, on
    ``device`` (the card unless the caller asks for the CPU).

    The noise is drawn in float64 on the generator's device and cast, so
    one seed gives the same field (to the dtype's rounding) for every
    ``device`` and ``dtype``; or it is ``noise``, a real (nmesh,)*3
    array."""
    if noise is None:
        gen_device = generator.device if generator is not None else "cpu"
        w = torch.randn((nmesh,) * 3, generator=generator, device=gen_device,
                        dtype=torch.float64).to(device=device, dtype=dtype)
    else:
        w = torch.as_tensor(np.array(noise), device=device, dtype=dtype)
        if w.shape != (nmesh,) * 3:
            raise ValueError(f"noise shape {tuple(w.shape)} != {(nmesh,) * 3}")
    return torch.fft.rfftn(w)


def gaussian_delta_k(spec: GRFSpec, power: Callable, amplitude: float = 1.0,
                     generator: torch.Generator | None = None, *, noise=None,
                     device="cuda", dtype=torch.float32):
    """delta(k) on the rfft grid for the isotropic spectrum ``power(k)``
    (host numpy callable, k in 1/length -> P in length^3), in the 'grid'
    measurement convention (or 'fac'), on ``device``.  ``amplitude``
    multiplies P(k)."""
    nmesh, box = spec.nmesh, spec.box
    wk = white_noise_k(nmesh, generator, noise=noise, device=device,
                       dtype=dtype)
    km = kmag(nmesh, box, rfft=True, dtype=torch.float64).numpy()
    with np.errstate(divide="ignore", invalid="ignore"):  # k = 0, zeroed below
        amp2 = amplitude * np.asarray(power(km)) * (nmesh**3 / box**3)
    if spec.convention == "fac":
        amp2 = amp2 * (2.0 * np.pi)
    amp = np.sqrt(np.maximum(amp2, 0.0))
    amp[0, 0, 0] = 0.0  # zero the DC mode (mean overdensity 0)
    return wk * torch.as_tensor(amp, device=wk.device, dtype=dtype)


def member_generator(master_seed: int, i: int) -> torch.Generator:
    """Volume i's own CPU generator for the draws of ``master_seed``, so
    a volume's field does not depend on the others drawn with it."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence(
        [int(master_seed), int(i)]).generate_state(1, np.uint64)[0]))


def gaussian_field(spec: GRFSpec, power: Callable, amplitudes,
                   generators=None, *, noise=None, device="cuda",
                   dtype=torch.float32):
    """B real-space delta(x) realizations, (B, nmesh, nmesh, nmesh) on
    ``device``: volume b at P(k) x ``amplitudes[b]``, its unit white
    noise drawn in float64 from ``generators[b]`` (cast to ``dtype``) or
    ``noise[b]`` (noise (B, nmesh, nmesh, nmesh)); one batched rfft and
    irfft over the B volumes."""
    nmesh, box = spec.nmesh, spec.box
    amplitudes = np.asarray(amplitudes, dtype=np.float64).reshape(-1)
    B = len(amplitudes)
    if noise is None:
        if generators is None or len(generators) != B:
            raise ValueError(f"need {B} generators or the noise")
        w = torch.stack([torch.randn((nmesh,) * 3, generator=g,
                                     device=g.device, dtype=torch.float64)
                         .to(device) for g in generators]).to(dtype)
    else:
        w = torch.as_tensor(np.array(noise), device=device, dtype=dtype)
        if w.shape != (B,) + (nmesh,) * 3:
            raise ValueError(f"noise shape {tuple(w.shape)} != "
                             f"{(B,) + (nmesh,) * 3}")
    km = kmag(nmesh, box, rfft=True, dtype=torch.float64).numpy()
    with np.errstate(divide="ignore", invalid="ignore"):  # k = 0, zeroed below
        amp2 = (amplitudes[:, None, None, None] * np.asarray(power(km))[None]
                * (nmesh**3 / box**3))
    if spec.convention == "fac":
        amp2 = amp2 * (2.0 * np.pi)
    amp = np.sqrt(np.maximum(amp2, 0.0))
    amp[:, 0, 0, 0] = 0.0  # zero the DC mode (mean overdensity 0)
    return irfft3(rfft3(w) * torch.as_tensor(amp, device=w.device,
                                             dtype=dtype), nmesh)
