"""P3M gravity: PM far field + short-range particle-particle correction.

Counterpart of :mod:`nbody.forces.p3m`.  :func:`p3m_acc` resolves the
short-range tier by the JAX package's rule (:func:`resolve_shortrange`):
the dense "allpairs" tier for N <= 65,536, whose pair sum is K1 (a CUDA
kernel, ``forces/csrc/p3m_short.cu``, on a CUDA tensor, its plain PyTorch
version on a CPU tensor); above that the supercell tier
(:mod:`nbody_torch.forces.pm_supercell`, K2 + K3) where the mesh tiles a
chaining grid, and the columns tier (:mod:`nbody_torch.forces.
p3m_columns`, K4) where it does not.  The cell tier ('cells', K6) is not
ported yet: asking for it raises ``NotImplementedError``.

The weight functions below are the physics and keep the JAX package's
algebra and constants exactly.
"""

from __future__ import annotations

import functools
import math

import torch

from nbody_torch.forces.pm import pm_acc

_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)

#: particle count above which the JAX package's 'auto' picks the
#: supercell/columns tiers (p3m.py:334)
ALLPAIRS_MAX_N = 65536

_CHAINED_TIERS = ("cells", "columns", "supercell")
_TIERS = ("auto", "allpairs", *_CHAINED_TIERS)


def _erfc_pos(x, expmx2):
    """erfc(x) for x >= 0 via Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7),
    reusing the exp(-x^2) the weight already needs."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
    return poly * expmx2


def _soft_newton(r2, eps2: float):
    """Plummer-softened Newton weight 1/(r^2 + eps^2)^(3/2); ``r2``
    excludes eps^2."""
    inv_r = torch.rsqrt(torch.clamp_min(r2 + eps2, 1e-30))
    return inv_r * inv_r * inv_r


def _soft_newton_spline(r2, eps2: float):
    """Cubic-spline softened Newton weight (CONCEPT's default kernel):
    support h = 2.8 eps, exactly Newtonian for r >= h (Monaghan-Lattanzio
    force factors in Horner form)."""
    h = 2.8 * math.sqrt(eps2) if eps2 > 0 else 0.0
    r2 = torch.clamp_min(r2, 1e-30)
    inv_r = torch.rsqrt(r2)
    newton = inv_r * inv_r * inv_r
    if h == 0.0:
        return newton
    h3_inv = 1.0 / h**3
    u = r2 * inv_r * (1.0 / h)  # r/h
    fac_lo = h3_inv * (32.0 / 3.0 + u * u * (32.0 * u - 38.4))
    fac_hi = h3_inv * (
        64.0 / 3.0 + u * (-48.0 + u * (38.4 - (32.0 / 3.0) * u))
    ) - (1.0 / 15.0) * newton
    return torch.where(u < 0.5, fac_lo, torch.where(u < 1.0, fac_hi, newton))


def _newton_fn(softening: str):
    if softening == "plummer":
        return _soft_newton
    if softening == "spline":
        return _soft_newton_spline
    raise ValueError(f"unknown softening kernel {softening!r}")


def _short_weight(r2, eps2: float, r_s: float, r_cut: float,
                  softening: str = "plummer"):
    """Gaussian-split short-range weight C(r) * soft_newton(r), masked
    beyond r_cut; C(r) = erfc(r/2r_s) + r/(r_s sqrt(pi)) exp(-r^2/4r_s^2)."""
    r2f = torch.clamp_min(r2, 1e-30)
    inv_r = torch.rsqrt(r2f)
    r = r2f * inv_r
    x = r / (2.0 * r_s)
    expmx2 = torch.exp(-x * x)
    corr = _erfc_pos(x, expmx2) + (r / r_s) * _INV_SQRT_PI * expmx2
    w = corr * _newton_fn(softening)(r2, eps2)
    return torch.where(r2f < r_cut * r_cut, w, torch.zeros_like(w))


def _spline_short_weight(r2, eps2: float, r_s: float, r_cut: float,
                         softening: str = "plummer"):
    """Polynomial-spline split short-range weight (r_s unused):
    soft_newton(r) + g(u^2)/r_cut^3, g = (-70 + 84u^2 - 30u^4)/16,
    u = r/r_cut, masked beyond r_cut."""
    r2f = torch.clamp_min(r2, 1e-30)
    u2 = r2f * (1.0 / (r_cut * r_cut))
    g = (-70.0 + u2 * (84.0 - u2 * 30.0)) * (1.0 / 16.0)
    w = _newton_fn(softening)(r2, eps2) + g * (1.0 / r_cut**3)
    return torch.where(r2f < r_cut * r_cut, w, torch.zeros_like(w))


_SPLITS = {"gaussian": 0, "spline": 1}
_SOFTENINGS = {"plummer": 0, "spline": 1}


def _weight_fn(split: str, softening: str = "plummer"):
    if softening not in _SOFTENINGS:
        raise ValueError(f"unknown softening kernel {softening!r}")
    if split == "gaussian":
        return functools.partial(_short_weight, softening=softening)
    if split == "spline":
        return functools.partial(_spline_short_weight, softening=softening)
    raise ValueError(f"unknown split {split!r}")


def _min_image(d, box: float):
    return d - box * torch.round(d * (1.0 / box))


def p3m_short_plain(pos, mass, box: float, eps: float, r_s: float,
                    r_cut: float, G: float = 1.0, split: str = "gaussian",
                    softening: str = "plummer", chunk_pairs: int = 1 << 24):
    """Plain PyTorch version of K1: the same sum, chunked over targets so
    no more than ``chunk_pairs`` pairs are materialized at once.  Like the
    kernel it has no self-pair mask (d = 0 contributes nothing)."""
    weight = _weight_fn(split, softening)
    posw = torch.remainder(pos, box)
    n = pos.shape[0]
    out = torch.empty_like(pos)
    step = max(1, chunk_pairs // max(n, 1))
    for i0 in range(0, n, step):
        d = _min_image(posw[None, :, :] - posw[i0:i0 + step, None, :], box)
        r2 = torch.sum(d * d, dim=-1)
        w = mass[None, :] * weight(r2, eps * eps, r_s, r_cut)
        out[i0:i0 + step] = torch.einsum("ij,ijk->ik", w, d)
    return out * G


def p3m_short_acc(pos, mass, box: float, eps: float, r_s: float,
                  r_cut: float, G: float = 1.0, split: str = "gaussian",
                  softening: str = "plummer"):
    """Short-range P3M correction force, minimum-image periodic (valid for
    r_cut < box/2), summed over all pairs with the cutoff as a mask.

    A CUDA tensor launches K1 (float32, contiguous (N, 3) positions and
    (N,) masses on one device) or raises; a CPU tensor takes
    :func:`p3m_short_plain`.  ``p3m_short_acc.launches`` counts kernel
    launches."""
    if split not in _SPLITS:
        raise ValueError(f"unknown split {split!r}")
    if softening not in _SOFTENINGS:
        raise ValueError(f"unknown softening kernel {softening!r}")
    if pos.device.type == "cpu":
        return p3m_short_plain(pos, mass, box, eps, r_s, r_cut, G=G,
                               split=split, softening=softening)
    if pos.device.type != "cuda":
        raise ValueError(f"p3m_short_acc: no kernel for device {pos.device}")
    n = pos.shape[0]
    if pos.dtype != torch.float32 or mass.dtype != torch.float32:
        raise TypeError(
            f"p3m_short_acc: the CUDA kernel takes float32, got "
            f"{pos.dtype}/{mass.dtype}"
        )
    if pos.ndim != 2 or pos.shape[1] != 3 or mass.shape != (n,):
        raise ValueError(
            f"p3m_short_acc: shapes pos {tuple(pos.shape)} / mass "
            f"{tuple(mass.shape)}, expected (N, 3) / (N,)"
        )
    if mass.device != pos.device:
        raise ValueError("p3m_short_acc: pos and mass on different devices")
    if not (pos.is_contiguous() and mass.is_contiguous()):
        raise ValueError("p3m_short_acc: pos and mass must be contiguous")
    from nbody_torch._kernels import load_library

    lib = load_library()
    tile = lib.p3m_short_tile()
    npad = max(tile, -(-n // tile) * tile)
    # SoA [x; y; z; m] with positions wrapped into [0, box); padding
    # columns are zero-mass sources
    packed = torch.zeros((4, npad), device=pos.device, dtype=torch.float32)
    packed[:3, :n] = torch.remainder(pos, box).T
    packed[3, :n] = mass
    out = torch.empty((n, 3), device=pos.device, dtype=torch.float32)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.p3m_short_acc_f32(
            packed.data_ptr(), n, npad, float(box), float(eps), float(r_s),
            float(r_cut), float(G), _SPLITS[split], _SOFTENINGS[softening],
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"p3m_short_acc: CUDA launch failed (error {err})")
    p3m_short_acc.launches += 1
    return out


p3m_short_acc.launches = 0


def p3m_short_direct(pos, mass, box: float, eps: float, r_s: float,
                     r_cut: float, G: float = 1.0, split: str = "gaussian",
                     softening: str = "plummer"):
    """Dense N x N oracle for the short-range sum, self pairs masked
    (tests)."""
    d = _min_image(pos[None, :, :] - pos[:, None, :], box)
    r2 = torch.sum(d * d, dim=-1)
    w = mass[None, :] * _weight_fn(split, softening)(r2, eps**2, r_s, r_cut)
    n = pos.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    w = torch.where(eye, torch.zeros_like(w), w)
    return G * torch.einsum("ij,ijk->ik", w, d)


def cell_capacity(n: int, ncell: int, headroom: float = 1.0,
                  minimum: int = 8) -> int:
    """Static cell-list capacity: mean occupancy + 5 sigma Poisson tail,
    rounded up to a multiple of 8 (``nbody.mesh.cells.cell_capacity``)."""
    mean = n / ncell**3
    cap = max(minimum, int(headroom * (mean + 5.0 * mean**0.5) + 2))
    return -(-cap // 8) * 8


def p3m_short_params(box: float, nmesh: int, n: int):
    """Default (r_s, r_cut, ncell, capacity) for a box/mesh/particle count:
    r_s = 1.25 mesh cells, r_cut = 4.5 r_s, cells of side >= r_cut."""
    cell = box / nmesh
    r_s = 1.25 * cell
    r_cut = 4.5 * r_s
    ncell = max(3, int(box / r_cut))
    return r_s, r_cut, ncell, cell_capacity(n, ncell)


def supercell_ncell(box: float, nmesh: int, r_cut: float) -> int | None:
    """Chaining-grid side for the supercell tier: the largest divisor of
    nmesh with column side box/ncell >= r_cut, nmesh/ncell <= 13 (the
    haloed CIC node grid of a column packs into 16 x 16 rows) and
    ncell >= 3 (xy ghost ring); None when the mesh admits no such tiling
    (the columns tier carries the force then)."""
    for c in range(int(box / float(r_cut)), 2, -1):
        if nmesh % c == 0 and nmesh // c <= 13:
            return c
    return None


def auto_column_capacity(n: int, ncell: int) -> int:
    """Column capacity for n particles over ncell^2 columns: the mean
    column + 6 sigma Poisson tail + 8, rounded up to 128."""
    mean_col = n / ncell**2
    return -(-int(mean_col + 6.0 * mean_col**0.5 + 8) // 128) * 128


def resolve_shortrange(shortrange: str, n: int, box: float, r_cut: float,
                       nmesh: int, capacity: int | None = None) -> str:
    """The tier :func:`p3m_acc` runs for ``part='both'``, by the JAX
    package's rule: 'auto' picks supercell (the mesh tiles a chaining
    grid) or columns above ALLPAIRS_MAX_N particles and allpairs below; a
    box under 3 r_cut runs allpairs for every tier; supercell falls back
    to columns when no grid tiles the mesh or the capacity's stride is
    over budget.  'cells' (K6) raises ``NotImplementedError``."""
    if shortrange not in _TIERS:
        raise ValueError(f"unknown shortrange tier {shortrange!r}")
    if shortrange == "auto":
        if n > ALLPAIRS_MAX_N:
            shortrange = ("supercell" if supercell_ncell(box, nmesh, r_cut)
                          else "columns")
        else:
            shortrange = "allpairs"
    if shortrange in _CHAINED_TIERS and box / float(r_cut) < 3.0:
        # a box too small for a 3^3 chaining grid: the dense tier is
        # exact there
        return "allpairs"
    if shortrange == "supercell":
        from nbody_torch.forces.pm_supercell import supercell_stride_ok

        sc = supercell_ncell(box, nmesh, r_cut)
        if sc is None or not supercell_stride_ok(
                box, r_cut, capacity if capacity is not None
                else auto_column_capacity(n, sc)):
            shortrange = "columns"
    if shortrange == "cells":
        raise NotImplementedError(
            "shortrange='cells' (the cell-plane tier, K6) is not ported yet")
    return shortrange


def p3m_acc(
    pos,
    mass,
    box: float,
    nmesh: int,
    G: float = 1.0,
    eps: float = 0.0,
    r_s: float | None = None,
    r_cut: float | None = None,
    deconvolve_p: int = 2,
    interlace: bool = False,
    shortrange: str = "auto",
    split: str = "gaussian",
    softening: str = "plummer",
    capacity: int | None = None,
    window: int | None = None,
    with_overflow: bool = False,
    part: str = "both",
    grad_order: str = "fd4",
):
    """Full P3M acceleration: filtered PM far field + short-range pair
    correction.

    ``part``: 'both' | 'long' (mesh only) | 'short' (pairs only) | 'split'
    (returns (acc_long, acc_short, overflow) from one evaluation).
    Defaults r_s = 1.25 cells, r_cut = 4.5 r_s.  ``shortrange`` picks the
    tier (:func:`resolve_shortrange`): 'allpairs' (K1), 'columns' (K4),
    'supercell' (K2 + K3; its 'short' part runs K4 on the same chaining
    geometry) or 'auto'.  ``capacity``/``window`` set the column tiers'
    bucket capacity and z-window (None: auto).  ``with_overflow=True``
    returns (acc, overflow): 0 iff no force was dropped (the column tiers'
    field-encoded word, a 0-d tensor; the dense tier returns 0)."""
    if part not in ("both", "long", "short", "split"):
        raise ValueError(f"unknown part {part!r}")
    cell = box / nmesh
    if r_s is None:
        r_s = 1.25 * cell
    if r_cut is None:
        r_cut = 4.5 * r_s

    def _pm_long():
        return pm_acc(
            pos, mass, box, nmesh, G=G, deconvolve_p=deconvolve_p,
            interlace=interlace,
            longrange_split=float(r_s) if split == "gaussian" else 0.0,
            spline_split=float(r_cut) if split == "spline" else 0.0,
            grad_order=grad_order,
        )

    if part == "long":
        return _pm_long()
    n = pos.shape[0]
    tier = resolve_shortrange(shortrange, n, box, float(r_cut), nmesh,
                              capacity)
    ckw = dict(G=G, split=split, softening=softening)
    if tier == "supercell":
        from nbody_torch.forces.p3m_columns import (
            column_window,
            p3m_short_columns,
        )
        from nbody_torch.forces.pm_supercell import p3m_supercell_acc

        sc_ncell = supercell_ncell(box, nmesh, float(r_cut))
        ck = capacity if capacity is not None else auto_column_capacity(
            n, sc_ncell)
        w = window if window else column_window(box, float(r_cut), ck)
        if part in ("both", "split"):
            out = p3m_supercell_acc(
                pos, mass, box, nmesh, G=G, eps=float(eps), r_s=float(r_s),
                r_cut=float(r_cut), deconvolve_p=deconvolve_p, split=split,
                softening=softening, ncell=sc_ncell, col_capacity=ck,
                window=w, grad_order=grad_order,
                part_split=(part == "split"), interlace=interlace,
            )
            if part == "split":
                return out
            return out if with_overflow else out[0]
        # the short part on the same chaining geometry, so the capacity
        # knobs mean the same across parts
        acc_short, overflow = p3m_short_columns(
            pos, mass, box, float(eps), float(r_s), float(r_cut),
            ncell=sc_ncell, col_capacity=ck, window=w, **ckw)
    elif tier == "columns":
        from nbody_torch.forces.p3m_columns import (
            column_params,
            column_window,
            columns_stride_ok,
            p3m_short_columns,
        )

        _, _, ncell_c, auto_ck, _ = column_params(box, nmesh, n)
        ck = capacity if capacity is not None else auto_ck
        if not columns_stride_ok(box, float(r_cut), ck):
            raise ValueError(
                f"column capacity {ck} exceeds the column kernels' stride "
                f"budget - the state is too clustered for this mesh; "
                f"increase mesh_size (shrinks r_cut)"
            )
        w = window if window else column_window(box, float(r_cut), ck)
        acc_short, overflow = p3m_short_columns(
            pos, mass, box, float(eps), float(r_s), float(r_cut),
            ncell=ncell_c, col_capacity=ck, window=w, **ckw)
    else:
        acc_short = p3m_short_acc(pos, mass, box, float(eps), float(r_s),
                                  float(r_cut), **ckw)
        overflow = 0
    if part == "split":
        return _pm_long(), acc_short, overflow
    acc = acc_short if part == "short" else _pm_long() + acc_short
    if with_overflow:
        return acc, overflow
    return acc
