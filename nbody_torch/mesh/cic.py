"""Cloud-in-Cell mass assignment, window function, deconvolution and
interlacing.

Counterpart of :mod:`nbody.mesh.cic`.  The 8-corner trilinear scatter is
one :func:`scatter_sum` over all corners' flattened cell indices; the
gather is its adjoint.  Deconvolution is amplitude-level (divide by the
window prod_i sinc^p) and the interlacing phase is e^{-i k.d/2}, as in
the JAX package.
"""

from __future__ import annotations

import itertools
import math

import torch

from nbody_torch.mesh.grids import kvecs, rfft3

_CORNERS = tuple(itertools.product((0, 1), repeat=3))


def fixed_point_scale(vmax, count: int):
    """The power of two by which :func:`scatter_sum` scales its values:
    ``count`` values of magnitude at most ``vmax`` (a float64 tensor, one
    a member) sum below 2^61 once scaled.  It depends on the largest
    magnitude and the count alone, which any order of reduction gives the
    same, so a member's scale is the same in a batch as alone."""
    _, k = torch.frexp(torch.where(vmax > 0, vmax, torch.ones_like(vmax)))
    return torch.ldexp(torch.ones_like(vmax),
                       61 - k - int(count).bit_length())


def scatter_sum(size: int, index, values):
    """A flat (size,) tensor with ``values`` summed at ``index``, the same
    bits in every call, on the card too, where a float ``index_add_`` adds
    in the order its atomics land (so two runs of one float32 trajectory
    would part).  The values are summed in int64 fixed point, scaled by
    the power of two :func:`fixed_point_scale` gives: integer addition is
    exact, so no order of the additions can change a bit, and a bin's
    error is the rounding of its values to 2^-61 of count x the largest
    magnitude each, then float64 rounding.

    With ``index`` and ``values`` of shape (B, M), B members at once: one
    integer sum over member-offset indices, each member at its own scale,
    (B, size) out, each row the bits its own call gives (a flat call is
    one member)."""
    one = values.ndim == 1
    v = values.to(torch.float64)
    if one:
        v, index = v[None], index[None]
    B = v.shape[0]
    if v.shape[1] == 0:
        out = torch.zeros((B, size), dtype=values.dtype, device=v.device)
        return out[0] if one else out
    scale = fixed_point_scale(torch.amax(torch.abs(v), dim=1), v.shape[1])
    offset = torch.arange(B, device=index.device)[:, None] * size
    sums = torch.zeros(B * size, dtype=torch.int64, device=values.device)
    sums.index_add_(0, (index + offset).reshape(-1),
                    torch.round(v * scale[:, None]).to(torch.int64)
                    .reshape(-1))
    out = (sums.view(B, size).to(torch.float64) / scale[:, None]).to(
        values.dtype)
    return out[0] if one else out


def _cic_corners(pos, box: float, nmesh: int, shift: float = 0.0):
    """Flat cell index (8, ...) and trilinear weight (8, ...) of each
    corner of positions (..., 3)."""
    s = pos * (nmesh / box) - shift
    i0 = torch.floor(s)
    f = s - i0
    i0 = i0.to(torch.int64)
    lins, ws = [], []
    for dx, dy, dz in _CORNERS:
        ws.append(
            (f[..., 0] if dx else 1.0 - f[..., 0])
            * (f[..., 1] if dy else 1.0 - f[..., 1])
            * (f[..., 2] if dz else 1.0 - f[..., 2])
        )
        ix = torch.remainder(i0[..., 0] + dx, nmesh)
        iy = torch.remainder(i0[..., 1] + dy, nmesh)
        iz = torch.remainder(i0[..., 2] + dz, nmesh)
        lins.append((ix * nmesh + iy) * nmesh + iz)
    return torch.stack(lins), torch.stack(ws)


def _deposit(lin, w, nmesh: int):
    """The (nmesh,)^3 grid of the corners ``lin``, ``w`` (C, n), or of B
    members' (C, B, n) as (B, nmesh, nmesh, nmesh)."""
    B = lin.shape[1] if lin.ndim == 3 else 1
    grid = scatter_sum(nmesh**3, lin.reshape(lin.shape[0], B, -1)
                       .transpose(0, 1).reshape(B, -1),
                       w.reshape(w.shape[0], B, -1).transpose(0, 1)
                       .reshape(B, -1))
    return grid.reshape(lin.shape[1:-1] + (nmesh,) * 3)


def cic_deposit(pos, box: float, nmesh: int, weights=None,
                shift: float = 0.0):
    """CIC deposit onto an (nmesh,)*3 grid: each particle's weight spread
    trilinearly over its 8 cells with periodic wrap.  ``shift`` (cells)
    offsets the grid origin (interlacing).  ``pos`` (B, n, 3) deposits B
    members at once into (B, nmesh, nmesh, nmesh), each its own grid's
    bits."""
    lin, w = _cic_corners(pos, box, nmesh, shift)
    if weights is not None:
        w = w * weights
    return _deposit(lin, w, nmesh)


def cic_gather(grid, pos, box: float, shift: float = 0.0):
    """Trilinear interpolation of a grid at particle positions (the
    adjoint of :func:`cic_deposit`)."""
    return cic_gather_vec(grid[None], pos, box, shift=shift)[:, 0]


def cic_gather_vec(grids, pos, box: float, shift: float = 0.0):
    """CIC-interpolate C grids at once: grids (C, N, N, N) -> (n, C); or
    B members' grids (B, C, N, N, N) at their positions (B, n, 3) ->
    (B, n, C)."""
    C, nmesh = grids.shape[-4], grids.shape[-1]
    lin, w = _cic_corners(pos, box, nmesh, shift)
    B = grids.shape[0] if grids.ndim == 5 else 1
    # (B N^3, C): one row per corner fetch, member after member
    flat = grids.reshape(B, C, -1).transpose(1, 2).reshape(-1, C)
    member = (torch.arange(B, device=pos.device) * nmesh**3).reshape(
        (B,) + (1,) * (pos.ndim - 2))
    return (w[..., None] * flat[lin + member]).sum(dim=0)


def _bspline_weight(order: int, u):
    au = torch.abs(u)
    zero = torch.zeros_like(u)
    if order == 3:  # TSC
        return torch.where(
            au <= 0.5, 0.75 - u * u,
            torch.where(au < 1.5, 0.5 * (1.5 - au) ** 2, zero),
        )
    # PCS
    return torch.where(
        au <= 1.0, (4.0 - 6.0 * au * au + 3.0 * au**3) / 6.0,
        torch.where(au < 2.0, (2.0 - au) ** 3 / 6.0, zero),
    )


def bspline_deposit(pos, box: float, nmesh: int, order: int = 2,
                    weights=None, shift: float = 0.0):
    """B-spline mass assignment on a node-centred grid: 2 = CIC,
    3 = TSC, 4 = PCS.  The matching Fourier window is sinc^order per axis
    (:func:`assignment_window`)."""
    if order == 2:
        return cic_deposit(pos, box, nmesh, weights=weights, shift=shift)
    if order not in (3, 4):
        raise ValueError(f"unsupported assignment order {order}")
    s = pos * (nmesh / box) - shift
    if order == 3:  # 3 nodes around the nearest node
        ic = torch.floor(s + 0.5).to(torch.int64)
        offsets = (-1, 0, 1)
    else:  # 4 nodes from floor - 1
        ic = torch.floor(s).to(torch.int64)
        offsets = (-1, 0, 1, 2)
    w1 = [[_bspline_weight(order, s[..., ax] - (ic[..., ax] + o))
           for o in offsets] for ax in range(3)]
    idx = [[torch.remainder(ic[..., ax] + o, nmesh) for o in offsets]
           for ax in range(3)]
    lins, ws = [], []
    for a, b, c in itertools.product(range(len(offsets)), repeat=3):
        lins.append((idx[0][a] * nmesh + idx[1][b]) * nmesh + idx[2][c])
        ws.append(w1[0][a] * w1[1][b] * w1[2][c])
    w = torch.stack(ws)
    if weights is not None:
        w = w * weights
    return _deposit(torch.stack(lins), w, nmesh)


def density_to_delta(count_grid, n_particles: int):
    """Overdensity delta = rho/rho_mean - 1 from a CIC count grid."""
    mean = n_particles / count_grid.numel()
    return count_grid / mean - 1.0


def cic_window(nmesh: int, box: float, p: int = 2, *, device=None,
               dtype=torch.float32):
    """CIC Fourier window on the rfft grid: prod_i sinc(k_i d / 2 pi)^p."""
    d = box / nmesh
    kx, ky, kz = kvecs(nmesh, box, rfft=True, device=device, dtype=dtype)
    c = d / (2.0 * math.pi)
    return (torch.sinc(kx * c) * torch.sinc(ky * c) * torch.sinc(kz * c)) ** p


def assignment_window(nmesh: int, box: float, order: int, *, device=None,
                      dtype=torch.float32):
    """Fourier window of a B-spline assignment of the given order."""
    return cic_window(nmesh, box, p=order, device=device, dtype=dtype)


def deconvolve(delta_k, nmesh: int, box: float, p: int = 2):
    """Divide an rfft-layout field by the CIC window (zero-guarded)."""
    W = cic_window(nmesh, box, p=p, device=delta_k.device,
                   dtype=delta_k.real.dtype)
    return delta_k / torch.clamp_min(W, 1e-8)


def interlace_phase(nmesh: int, box: float, sign: float, *, device=None,
                    dtype=torch.float32):
    """exp(sign * i (kx + ky + kz) d / 2) on the rfft grid."""
    kx, ky, kz = kvecs(nmesh, box, rfft=True, device=device, dtype=dtype)
    arg = (kx + ky + kz) * (box / nmesh / 2.0)
    return torch.polar(torch.ones_like(arg), sign * arg)


def bspline_deposit_interlaced_k(pos, box: float, nmesh: int, order: int = 2,
                                 weights=None, base_shift: float = 0.0):
    """Interlaced B-spline deposit in k space (rfft layout): two grids
    half a cell apart, aligned with e^{-i k.d/2} and averaged, which
    cancels the odd alias images.  ``base_shift`` offsets both grids."""
    g0 = bspline_deposit(pos, box, nmesh, order=order, weights=weights,
                         shift=base_shift)
    g1 = bspline_deposit(pos, box, nmesh, order=order, weights=weights,
                         shift=base_shift + 0.5)
    phase = interlace_phase(nmesh, box, -1.0, device=pos.device,
                            dtype=pos.dtype)
    return 0.5 * (rfft3(g0) + rfft3(g1) * phase)


def cic_deposit_interlaced_k(pos, box: float, nmesh: int, weights=None,
                             base_shift: float = 0.0):
    """Interlaced CIC deposit, returned in k space (rfft layout)."""
    return bspline_deposit_interlaced_k(pos, box, nmesh, order=2,
                                        weights=weights,
                                        base_shift=base_shift)
