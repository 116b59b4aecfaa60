"""P3M gravity: PM far field + short-range particle-particle correction.

Counterpart of :mod:`nbody.forces.p3m`.  :func:`p3m_acc` resolves the
short-range tier by the JAX package's rule (:func:`resolve_shortrange`):
the dense "allpairs" tier for N <= 65,536, whose pair sum is K1 (a CUDA
kernel, ``forces/csrc/p3m_short.cu``, on a CUDA tensor, its plain PyTorch
version on a CPU tensor); above that the supercell tier
(:mod:`nbody_torch.forces.pm_supercell`, K2 + K3) where the mesh tiles a
chaining grid, and the columns tier (:mod:`nbody_torch.forces.
p3m_columns`, K4) where it does not.  The cell tier ('cells') packs the
particles into a ghost-padded plane of (ncell,)^3 cells
(:func:`build_padded_plane`) whose pair sum is K6 (``forces/csrc/
p3m_cells.cu``, :func:`run_cell_plane`); its two-plane masked form
(:func:`p3m_short_cells_pallas_masked`) carries the rung tier's interior
ticks.

The weight functions below are the physics and keep the JAX package's
algebra and constants exactly.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple

import torch

from nbody_torch.forces.pm import pm_acc
from nbody_torch.mesh.cells import build_cell_list, cell_capacity, cell_ids

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
    kernel it has no self-pair mask (d = 0 contributes nothing).  ``pos``
    (B, N, 3) and ``mass`` (B, N) sum B members at once, each alone."""
    weight = _weight_fn(split, softening)
    posw = torch.remainder(pos, box)
    n = pos.shape[-2]
    members = pos.shape[0] if pos.ndim == 3 else 1
    out = torch.empty_like(pos)
    step = max(1, chunk_pairs // max(n * members, 1))
    for i0 in range(0, n, step):
        d = _min_image(posw[..., None, :, :] - posw[..., i0:i0 + step, None, :],
                       box)
        r2 = torch.sum(d * d, dim=-1)
        w = mass[..., None, :] * weight(r2, eps * eps, r_s, r_cut)
        out[..., i0:i0 + step, :] = torch.einsum("...ij,...ijk->...ik", w, d)
    return out * G


# ---------------------------------------------------------------------------
# K1: the spatial order, the cull and the launch shape
# ---------------------------------------------------------------------------

#: K1's Hilbert grid: 2^K1_KEY_BITS cells a side of the box, and its
#: sources a tile (the kernel library's; ``p3m_short_info`` reports the
#: tile).  A target group is 32 sorted particles, one a thread.
K1_KEY_BITS = 5
K1_TILE = 32
#: r_cut / box from which K1 cuts its sources into slices: there a target
#: group's reach covers most tiles, so each group's work is the same and
#: the groups alone make too few blocks to fill the card (below it a
#: group's visited tiles lie near it in the sorted order, and slicing the
#: tiles by index would leave most slices idle)
K1_SLICE_RCUT = 0.25
#: the waves of the card's resident blocks K1's source slices aim for
K1_WAVES = 8


def k1_wrap(pos, box: float):
    """Positions wrapped into [0, box] as K1's kernels wrap them, in the
    tensor's type: x - box floor(x / box) with 1 / box rounded to it,
    clamped (x / box rounds up to 1 within an ulp below box)."""
    inv_box = torch.tensor(1.0 / box, dtype=pos.dtype, device=pos.device)
    return torch.clamp(pos - box * torch.floor(pos * inv_box), 0.0, box)


def hilbert_keys(pos, box: float, bits: int = K1_KEY_BITS):
    """The Hilbert index (int64) of each particle's cell on the
    2^bits-a-side grid of the box: K1's sort key (``p3m_short_keys``) at
    the default bits, with the device code's arithmetic (Skilling's
    transpose, three bits a level with x's highest)."""
    w = k1_wrap(pos, box)
    scale = torch.tensor((1 << bits) / box, dtype=pos.dtype,
                         device=pos.device)
    cells = torch.clamp(torch.trunc(w * scale), 0, (1 << bits) - 1).long()
    X = [cells[:, 0], cells[:, 1], cells[:, 2]]
    Q = 1 << (bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            hit = (X[i] & Q) != 0
            t = torch.where(hit, torch.zeros_like(X[0]), (X[0] ^ X[i]) & P)
            x0 = torch.where(hit, X[0] ^ P, X[0] ^ t)
            if i:
                X[i] = X[i] ^ t
            X[0] = x0
        Q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    Q = 1 << (bits - 1)
    while Q > 1:
        t = torch.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    key = torch.zeros_like(X[0])
    for b in range(bits - 1, -1, -1):
        for i in range(3):
            key = (key << 1) | (((X[i] ^ t) >> b) & 1)
    return key


class K1Plan(NamedTuple):
    """K1's order and cull, as its kernels compute them (:func:`k1_plan`):
    ``perm`` the sorted order; ``pos`` (npad, 3) and ``mass`` (npad,) in
    it, wrapped, the padding repeating the last particle at mass 0; the
    low and high corners of each source tile's and each target group's
    real particles; ``visit`` (groups, tiles): the tile pairs the kernel
    sums; ``rint`` (groups, tiles): the pairs of a visited tile take rint
    minimum images; else ``image`` (groups, tiles, 3): the image k of the
    tile's sources (x + k box) on each axis."""

    perm: torch.Tensor
    pos: torch.Tensor
    mass: torch.Tensor
    tile_lo: torch.Tensor
    tile_hi: torch.Tensor
    group_lo: torch.Tensor
    group_hi: torch.Tensor
    visit: torch.Tensor
    rint: torch.Tensor
    image: torch.Tensor


def k1_reach(box: float, r_cut: float) -> float:
    """The reach of K1's cull: r_cut, its float32 rounding and that of the
    coordinates (4 box / 2^21); the kernel library's ``p3m_short_reach``
    (a card test holds the two equal)."""
    return r_cut * (1.0 + 1e-5) + 4.0 * box / (1 << 21)


def _corners(pos, n: int, size: int):
    """Low and high corners of each run of ``size`` rows of the first n."""
    m = -(-pos.shape[0] // size) * size
    real = torch.arange(m, device=pos.device) < n
    inf = torch.tensor(float("inf"), dtype=pos.dtype, device=pos.device)
    p = torch.zeros((m, 3), dtype=pos.dtype, device=pos.device)
    p[:pos.shape[0]] = pos
    lo = torch.where(real[:, None], p, inf).view(-1, size, 3).amin(dim=1)
    hi = torch.where(real[:, None], p, -inf).view(-1, size, 3).amax(dim=1)
    return lo, hi


def k1_plan(pos, mass, box: float, r_cut: float,
            reach: float | None = None) -> K1Plan:
    """K1's spatial order, tile boxes and visit mask, in the tensor's type
    with the device code's arithmetic (float32 on the card; the card may
    contract a multiply-add, a rounding far inside the reach's margin).
    ``reach`` replaces :func:`k1_reach` (a planted narrowed cull in the
    tests)."""
    n = pos.shape[0]
    npad = max(K1_TILE, -(-n // K1_TILE) * K1_TILE)
    perm = torch.argsort(hilbert_keys(pos, box), stable=True)
    idx = torch.cat([perm, perm[-1:].expand(npad - n)])
    ps = k1_wrap(pos[idx], box)
    ms = torch.cat([mass[perm], mass.new_zeros(npad - n)])
    t_lo, t_hi = _corners(ps, n, K1_TILE)
    g_lo, g_hi = _corners(ps[:n], n, 32)
    r = k1_reach(box, r_cut) if reach is None else reach
    f = lambda v: torch.tensor(v, dtype=pos.dtype, device=pos.device)
    box_t, zero = f(box), f(0.0)
    a0, a1 = g_lo[:, None, :], g_hi[:, None, :]
    b0, b1 = t_lo[None, :, :], t_hi[None, :, :]
    g0 = torch.maximum(torch.maximum(b0 - a1, a0 - b1), zero)
    gp = torch.maximum((b0 + box_t) - a1, zero)  # sources + box
    gm = torch.maximum((a0 + box_t) - b1, zero)  # sources - box
    g = torch.minimum(g0, torch.minimum(gp, gm))
    g2 = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]
          + g[..., 2] * g[..., 2])
    near = torch.stack([g0 < f(r), gp < f(r), gm < f(r)])
    visit = g2 < f(r * r)
    rint = (near.sum(dim=0) != 1).any(dim=-1) & visit
    image = torch.where(near[1], 1, torch.where(near[2], -1, 0)).to(
        torch.int8)
    return K1Plan(perm, ps, ms, t_lo, t_hi, g_lo, g_hi, visit, rint, image)


def k1_visits(plan: K1Plan) -> int:
    """The pair visits K1's kernel makes on this plan: the 32 target slots
    of each group against the source slots of each visited tile."""
    return int(plan.visit.sum()) * 32 * K1_TILE


def p3m_short_culled_plain(pos, mass, box: float, eps: float, r_s: float,
                           r_cut: float, plan: K1Plan, G: float = 1.0,
                           split: str = "gaussian",
                           softening: str = "plummer"):
    """K1's sum over the tile pairs ``plan`` lists only, in the type of
    ``pos`` (minimum images by rint, in the input order): equal to
    :func:`p3m_short_plain` exactly when the cull drops no pair inside
    r_cut."""
    weight = _weight_fn(split, softening)
    n = pos.shape[0]
    perm = plan.perm
    ps = torch.remainder(pos, box)[perm]
    ms = mass[perm]
    group = torch.arange(n, device=pos.device) // 32
    src_tile = torch.arange(n, device=pos.device) // K1_TILE
    acc = torch.empty_like(pos)
    step = max(1, (1 << 22) // max(n, 1))
    for i0 in range(0, n, step):
        d = _min_image(ps[None, :, :] - ps[i0:i0 + step, None, :], box)
        r2 = torch.sum(d * d, dim=-1)
        keep = plan.visit[group[i0:i0 + step]][:, src_tile]
        w = torch.where(keep, ms[None, :] * weight(r2, eps * eps, r_s, r_cut),
                        torch.zeros_like(r2))
        acc[i0:i0 + step] = torch.einsum("ij,ijk->ik", w, d)
    out = torch.empty_like(pos)
    out[perm] = acc
    return out * G


class K1Geometry(NamedTuple):
    """One K1 launch: ``groups`` x ``slices`` blocks of ``warps`` warps;
    block (g, s) takes the 32 sorted targets of group g against the source
    tiles [s slice_tiles, (s + 1) slice_tiles) of ``tile`` sources.
    ``sms`` and ``blocks_per_sm`` are the card's, as the kernel library
    reports them."""

    groups: int
    slices: int
    slice_tiles: int
    tile: int
    warps: int
    sms: int
    blocks_per_sm: int


@functools.lru_cache(maxsize=64)
def k1_geometry(n: int, box: float, r_cut: float, info) -> K1Geometry:
    """K1's launch shape for n particles with this r_cut / box on a card
    whose kernel library reports ``info`` (``p3m_short_info``: tile, warps
    a block, tiles a chunk, resident blocks per SM, SMs).

    One slice below :data:`K1_SLICE_RCUT`; from it the sources are cut into
    slices of whole tiles where the target groups make fewer than
    :data:`K1_WAVES` waves of the card's resident blocks, then evened out
    over the tiles."""
    tile, warps, _, bps, sms = info
    groups = -(-n // 32)
    tiles = max(1, -(-n // tile))
    per = tiles
    if r_cut >= K1_SLICE_RCUT * box and groups:
        want = -(-K1_WAVES * sms * bps // groups)
        per = -(-tiles // min(want, tiles))
    return K1Geometry(groups, -(-tiles // per), per, tile, warps, sms, bps)


@functools.lru_cache(maxsize=None)
def _k1_info(lib, device: int, split: int, softening: int) -> tuple:
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = lib.p3m_short_info(split, softening, info)
    if err != 0 or info[3] < 1:
        raise RuntimeError(f"p3m_short_info failed (error {err}, "
                           f"{list(info)})")
    return tuple(info)


def k1_card_geometry(pos, box: float, r_cut: float, split: str = "gaussian",
                     softening: str = "plummer", lib=None) -> K1Geometry:
    """The launch shape K1 takes for ``pos`` (a CUDA tensor, (N, 3) or B
    members' (B, N, 3): each member's) on its card."""
    if lib is None:
        from nbody_torch._kernels import load_library

        lib = load_library()
    info = _k1_info(lib, pos.device.index, _SPLITS[split],
                    _SOFTENINGS[softening])
    return k1_geometry(pos.shape[-2], float(box), float(r_cut), info)


def _k1_run(lib, geo: K1Geometry, pos, mass, box: float, eps: float,
            r_s: float, r_cut: float, G: float, split: str, softening: str):
    """K1 from the kernel library ``lib`` in the launch shape ``geo``, on
    tensors :func:`p3m_short_acc` has checked: the keys, their stable
    argsort, the pack and the pair sum, all on the current stream.  The
    pack's sources and tile boxes and the slices' partial sums share one
    scratch tensor.  B members, ``pos`` (B, N, 3), run in one launch of
    each kernel (the keys of all members at once, each member's argsort
    along its own row, the scratch member after member); ``pos`` (N, 3)
    is one member."""
    one = pos.ndim == 2
    if one:
        pos, mass = pos[None], mass[None]
    members, n = pos.shape[0], pos.shape[1]
    dev = pos.device
    npad = -(-n // geo.tile) * geo.tile
    n_packed, n_boxes = 4 * npad, 8 * (npad // geo.tile)
    n_part = 3 * npad * geo.slices if geo.slices > 1 else 0
    keys = torch.empty((members, n), device=dev, dtype=torch.int16)
    out = torch.empty((members, n, 3), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.p3m_short_keys(pos.data_ptr(), members * n, float(box),
                                 keys.data_ptr(), stream)
        if err == 0:
            perm = torch.argsort(keys, dim=-1, stable=True)
            scratch = torch.empty(
                (members * (n_packed + n_boxes + n_part),), device=dev,
                dtype=torch.float32)
            base = scratch.data_ptr()
            err = lib.p3m_short_f32(
                pos.data_ptr(), mass.data_ptr(), perm.data_ptr(), n, members,
                float(box), float(eps), float(r_s), float(r_cut), float(G),
                _SPLITS[split], _SOFTENINGS[softening], geo.slice_tiles,
                geo.slices, base, base + 4 * members * n_packed,
                base + 4 * members * (n_packed + n_boxes) if n_part else None,
                out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"p3m_short_acc: CUDA launch failed (error {err})")
    return out[0] if one else out


def p3m_short_acc(pos, mass, box: float, eps: float, r_s: float,
                  r_cut: float, G: float = 1.0, split: str = "gaussian",
                  softening: str = "plummer"):
    """Short-range P3M correction force, minimum-image periodic (valid for
    r_cut < box/2), summed over the pairs inside r_cut.

    A CUDA tensor launches K1 (float32, contiguous (N, 3) positions and
    (N,) masses on one device; the particles sorted on the card along a
    Hilbert curve, the source tiles out of reach culled, the launch shape
    from :func:`k1_geometry`) or raises; a CPU tensor takes
    :func:`p3m_short_plain`.  B members at once, ``pos`` (B, N, 3) and
    ``mass`` (B, N), make one launch over a member axis of the grid (the
    batched site: the JAX package's ``vmap`` of the ensemble runner, each
    member's sums those of its own launch, bit for bit).
    ``p3m_short_acc.launches`` counts calls that launched K1."""
    if split not in _SPLITS:
        raise ValueError(f"unknown split {split!r}")
    if softening not in _SOFTENINGS:
        raise ValueError(f"unknown softening kernel {softening!r}")
    if pos.device.type == "cpu":
        return p3m_short_plain(pos, mass, box, eps, r_s, r_cut, G=G,
                               split=split, softening=softening)
    if pos.device.type != "cuda":
        raise ValueError(f"p3m_short_acc: no kernel for device {pos.device}")
    n = pos.shape[-2] if pos.ndim >= 2 else 0
    if pos.dtype != torch.float32 or mass.dtype != torch.float32:
        raise TypeError(
            f"p3m_short_acc: the CUDA kernel takes float32, got "
            f"{pos.dtype}/{mass.dtype}"
        )
    if (pos.ndim not in (2, 3) or pos.shape[-1] != 3
            or mass.shape != pos.shape[:-1]):
        raise ValueError(
            f"p3m_short_acc: shapes pos {tuple(pos.shape)} / mass "
            f"{tuple(mass.shape)}, expected (N, 3) / (N,) or (B, N, 3) / "
            f"(B, N)"
        )
    if mass.device != pos.device:
        raise ValueError("p3m_short_acc: pos and mass on different devices")
    if not (pos.is_contiguous() and mass.is_contiguous()):
        raise ValueError("p3m_short_acc: pos and mass must be contiguous")
    if not box > 0:
        raise ValueError(f"p3m_short_acc: box must be > 0, got {box}")
    from nbody_torch._kernels import load_library

    lib = load_library()
    geo = k1_card_geometry(pos, box, r_cut, split, softening, lib)
    out = _k1_run(lib, geo, pos, mass, box, eps, r_s, r_cut, G, split,
                  softening)
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
    over budget."""
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
    tier (:func:`resolve_shortrange`): 'allpairs' (K1), 'cells' (K6),
    'columns' (K4), 'supercell' (K2 + K3; its 'short' part runs K4 on
    the same chaining geometry) or 'auto'.  ``capacity`` sets the cell or
    column tiers' bucket capacity and ``window`` the column tiers'
    z-window (None: auto).  ``with_overflow=True``
    returns (acc, overflow): 0 iff no force was dropped (the column tiers'
    field-encoded word, a 0-d tensor; the dense tier returns 0).
    ``pos`` (B, N, 3) and ``mass`` (B, N) evaluate B members at once on
    every tier: batched FFTs on the mesh, one launch of each kernel over
    the members, and on the plane tiers one capacity and window for all
    (the overflow word the largest member's, field by field)."""
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
    n = pos.shape[-2]
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
    elif tier == "cells":
        ncell = int(box / float(r_cut))
        cap = capacity if capacity is not None else cell_capacity(n, ncell)
        acc_short, overflow = p3m_short_cells_pallas(
            pos, mass, box, float(eps), float(r_s), float(r_cut),
            ncell=ncell, capacity=cap, **ckw)
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


# ---------------------------------------------------------------------------
# The cell tier: a ghost-padded plane of (ncell,)^3 cells and K6
# ---------------------------------------------------------------------------


def build_padded_plane(pos, mass, box: float, r_cut: float, ncell: int,
                       capacity: int, valid=None):
    """Bucket particles and assemble the ghost-padded float32 SoA cell
    plane.

    Returns (plane (8, M^3 K), overflow, K, gidx, counts), M = ncell + 2,
    K = capacity rounded up to 128: the JAX package's four values, and
    the (M^3,) int32 count of stored particles of every padded cell
    (ghost cells repeat their periodic image's), where K6 stops.  Plane
    rows are x, y, z, mass, then four zero rows; cell (px, py, pz) holds
    slots [((px M + py) M + pz) K, + K), its particles first in the cell
    list's order and then sentinels (-4 r_cut in each coordinate, zero
    mass).  Ghost cells replicate the periodic wrap with the +-box shift
    baked into their massive slots' coordinates.  ``gidx`` (n,) is each
    particle's slot (M^3 K for an overflowed or excluded particle).
    ``valid`` (n,) bool excludes particles from the plane entirely: the
    rung tier's active-target plane.  B members, ``pos`` (B, n, 3) and
    ``mass`` (B, n), give the plane, overflow, gidx and counts with a
    leading member axis, each member's equal to its own build (one cell
    list of all members, one scatter, one gather)."""
    one = pos.ndim == 2
    if one:
        pos, mass = pos[None], mass[None]
        valid = None if valid is None else valid[None]
    B = pos.shape[0]
    dev = pos.device
    f32 = torch.float32
    K = -(-capacity // 128) * 128
    cl = build_cell_list(pos.to(f32), box, ncell, capacity, valid=valid)
    C3 = ncell**3
    M = ncell + 2
    ov = cl.slots >= C3 * capacity
    cid = torch.clamp_max(cl.slots // capacity, C3 - 1)
    rank = cl.slots - cid * capacity
    slotK = torch.where(ov, torch.full_like(cid, C3 * K), cid * K + rank)

    posw = torch.remainder(pos, box).to(f32)
    data = torch.cat([posw, mass.to(f32)[..., None]], dim=-1)
    interior = torch.tensor([-4.0 * r_cut] * 3 + [0.0], dtype=f32,
                            device=dev).repeat(B, C3 * K + 1, 1)
    interior[torch.arange(B, device=dev)[:, None], slotK] = data
    interior = interior[:, :C3 * K].reshape(B, ncell, ncell, ncell, K, 4)

    wrap = (torch.arange(M, device=dev) - 1) % ncell
    padded = interior[:, wrap][:, :, wrap][:, :, :, wrap]
    zero = torch.zeros((), dtype=f32, device=dev)
    for ax in range(3):
        for edge, delta in ((0, -box), (M - 1, box)):
            sl = padded[(slice(None),) * (ax + 1) + (edge,)]
            sl[..., ax] += torch.where(sl[..., 3] > 0, zero + delta, zero)
    soa = padded.reshape(B, M**3 * K, 4).transpose(1, 2)
    plane = torch.cat([soa, torch.zeros_like(soa)], dim=1).contiguous()

    cx, cy, cz = cid // (ncell * ncell), (cid // ncell) % ncell, cid % ncell
    pad_cid = ((cx + 1) * M + (cy + 1)) * M + (cz + 1)
    gidx = torch.where(ov, torch.full_like(cid, M**3 * K), pad_cid * K + rank)
    stored = torch.clamp_max(cl.counts, capacity).reshape(B, ncell, ncell,
                                                          ncell)
    counts = stored[:, wrap][:, :, wrap][:, :, :, wrap].reshape(B, -1).to(
        torch.int32).contiguous()
    if one:
        return plane[0], cl.overflow[0], K, gidx[0], counts[0]
    return plane, cl.overflow, K, gidx, counts


def _real_cells(nx: int, ncell: int, device):
    """Padded ids of the real cells of a plane with nx real x-slabs."""
    M = ncell + 2
    px = torch.arange(1, nx + 1, device=device)
    py = torch.arange(1, ncell + 1, device=device)
    c = (px[:, None, None] * M + py[None, :, None]) * M + py[None, None, :]
    return c.reshape(-1)


def cell_plane_plain(plane, counts, *, nx: int, ncell: int, K: int,
                     eps2: float, r_s: float, r_cut: float,
                     split: str = "gaussian", softening: str = "plummer",
                     plane_j=None, K_j: int = 0, counts_j=None,
                     max_pairs: int = 1 << 24):
    """Plain PyTorch version of K6, in the plane's dtype: the output plane
    whose rows 0-2 hold, at every stored target slot of every real cell,
    the short-range sum over the stored sources of its 27 neighbour cells
    of ``plane_j`` (default ``plane``), zeros everywhere else.  The JAX
    kernel also visits the sentinel slots; they lie farther than r_cut
    from every slot they meet, so the sums are the same.  B members'
    planes (B, 8, ...) and counts (B, ...) give B output planes, each
    member alone."""
    if plane_j is None:
        plane_j, K_j, counts_j = plane, K, counts
    elif K_j <= 0 or counts_j is None:
        raise ValueError("plane_j requires its bucket width K_j and counts_j")
    if plane.ndim == 3:
        return torch.stack([cell_plane_plain(
            plane[b], counts[b], nx=nx, ncell=ncell, K=K, eps2=eps2, r_s=r_s,
            r_cut=r_cut, split=split, softening=softening,
            plane_j=plane_j[b], K_j=K_j, counts_j=counts_j[b],
            max_pairs=max_pairs) for b in range(plane.shape[0])])
    wfn = _weight_fn(split, softening)
    dev = plane.device
    M = ncell + 2
    counts = counts.to(torch.int64)
    counts_j = counts_j.to(torch.int64)
    cells = _real_cells(nx, ncell, dev)
    ci = counts[cells]
    tcell = torch.repeat_interleave(cells, ci)
    first = torch.cumsum(ci, 0) - ci
    rank = torch.arange(tcell.numel(), device=dev) - torch.repeat_interleave(
        first, ci)
    tslot = tcell * K + rank
    out = torch.zeros_like(plane)
    kmax = int(counts_j.max()) if counts_j.numel() else 0
    if tslot.numel() == 0 or kmax == 0:
        return out
    xt = plane[0:3, tslot]
    acc = torch.zeros_like(xt)
    jr = torch.arange(kmax, device=dev)
    step = max(1, max_pairs // kmax)
    offsets = [(ox * M + oy) * M + oz for ox in (-1, 0, 1)
               for oy in (-1, 0, 1) for oz in (-1, 0, 1)]
    for t0 in range(0, tslot.numel(), step):
        sl = slice(t0, t0 + step)
        for off in offsets:
            scell = tcell[sl] + off
            src = scell[:, None] * K_j + jr[None, :]
            live = jr[None, :] < counts_j[scell][:, None]
            src = torch.where(live, src, torch.zeros_like(src))
            d = plane_j[0:3, src] - xt[:, sl, None]
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            w = torch.where(live, plane_j[3, src], torch.zeros_like(r2))
            w = w * wfn(r2, eps2, r_s, r_cut)
            acc[:, sl] += torch.sum(w * d, dim=-1)
    out[0:3, tslot] = acc
    return out


#: K6's sources a tile and warps a block, as the kernel library builds
#: them (``p3m_cells_info`` reports both)
K6_TILE = 32
K6_WARPS = (1, 2, 4, 8, 16)
#: the waves of the card's resident blocks up to which K6 takes more warps
#: a block: more warps split a cell's neighbourhood finer (the slab sites'
#: 128 blocks fill the card only so, and a clustered cell's block ends
#: sooner), fewer make more blocks resident at once
K6_WAVES = 5


class K6Geometry(NamedTuple):
    """One K6 launch: ``blocks`` blocks (a real target cell each) of
    ``warps`` warps; ``sms`` and ``blocks_per_sm`` (at ``warps``) are the
    card's, as the kernel library reports them."""

    blocks: int
    warps: int
    sms: int
    blocks_per_sm: int


@functools.lru_cache(maxsize=64)
def k6_geometry(nx: int, ncell: int, info) -> K6Geometry:
    """K6's launch shape for a plane of ``nx`` x ``ncell``^2 real cells on
    a card whose kernel library reports ``info`` (``p3m_cells_info``: the
    tile, the SMs, then the resident blocks an SM at each of
    :data:`K6_WARPS`): the most warps a block whose blocks make at most
    :data:`K6_WAVES` waves of the card's resident blocks, else one."""
    _, sms, *bps = info
    blocks = nx * ncell * ncell
    for w, b in reversed(list(zip(K6_WARPS, bps))):
        if blocks <= K6_WAVES * sms * b:
            return K6Geometry(blocks, w, sms, b)
    return K6Geometry(blocks, K6_WARPS[0], sms, bps[0])


@functools.lru_cache(maxsize=None)
def _k6_info(lib, device: int, split: int, softening: int) -> tuple:
    info = (ctypes.c_int * (2 + len(K6_WARPS)))()
    with torch.cuda.device(device):
        err = lib.p3m_cells_info(split, softening, info)
    if err != 0 or min(info) < 1 or info[0] != K6_TILE:
        raise RuntimeError(f"p3m_cells_info failed (error {err}, "
                           f"{list(info)})")
    return tuple(info)


class K6Work(NamedTuple):
    """How K6 deals out one real target cell (:func:`k6_work`): ``lanes``
    lanes a target, ``groups`` groups of targets, ``shares`` shares of the
    neighbourhood's source tiles a group."""

    lanes: int
    groups: int
    shares: int


def k6_work(count: int, warps: int) -> K6Work:
    """The kernel's rule for a target cell of ``count`` targets in a block
    of ``warps`` warps: up to 32 targets take 32 // count lanes each (one
    group, a share a warp); more are cut into groups of 32, one a lane,
    and the warps into warps // groups shares (at least 1) of each."""
    if count <= 32:
        return K6Work(32 // count if count else 32, 1, warps)
    groups = -(-count // 32)
    return K6Work(1, groups, max(1, warps // groups))


def k6_items(count: int, warps: int):
    """The kernel's deal of one target cell of ``count`` targets over a
    block of ``warps`` warps (:func:`k6_work`), item by item (warp w takes
    items w, w + warps, ...): (target (items, 32) the target index each
    lane holds, -1 for none; sub (items, 32) the lane's place among its
    target's lanes; share (items,) the share of the source tiles the item
    sums)."""
    work = k6_work(count, warps)
    n = work.groups * work.shares if count else 0
    q = torch.arange(n)
    g, share = q % work.groups, q // work.groups
    lane = torch.arange(32)
    if count <= 32:
        t = (lane // work.lanes).expand(n, 32)
        sub = (lane % work.lanes).expand(n, 32)
    else:
        t = g[:, None] * 32 + lane[None, :]
        sub = torch.zeros((n, 32), dtype=torch.int64)
    return torch.where(t < count, t, -1), sub, share


def cell_plane_ordered(plane, counts, *, nx: int, ncell: int, K: int,
                       eps2: float, r_s: float, r_cut: float, warps: int,
                       split: str = "gaussian", softening: str = "plummer",
                       plane_j=None, K_j: int = 0, counts_j=None):
    """K6's sum dealt out as the kernel deals it, in the plane's dtype (a
    plain model of the device code, for the tests): each real target
    cell's 27 neighbour cells in order, cut into tiles of
    :data:`K6_TILE` stored sources of one cell, tile q going to share
    q mod S; the lanes of :func:`k6_items` take the sources l, l + L, ...
    of each tile of their item's share; each lane's sum, then the lanes of
    a target in lane order, then the shares in share order.  Returns the
    output plane as :func:`cell_plane_plain` does."""
    if plane_j is None:
        plane_j, K_j, counts_j = plane, K, counts
    wfn = _weight_fn(split, softening)
    M = ncell + 2
    dev = plane.device
    out = torch.zeros_like(plane)
    offsets = [(ox * M + oy) * M + oz for ox in (-1, 0, 1)
               for oy in (-1, 0, 1) for oz in (-1, 0, 1)]
    for tcell in _real_cells(nx, ncell, dev).tolist():
        c = int(counts[tcell])
        if c == 0:
            continue
        work = k6_work(c, warps)
        target, sub, share = k6_items(c, warps)
        cnt = [int(counts_j[tcell + o]) for o in offsets]
        src = torch.cat([torch.arange(cj, device=dev) + (tcell + o) * K_j
                         for o, cj in zip(offsets, cnt)])
        pos_in = torch.cat([torch.arange(cj, device=dev) for cj in cnt])
        ntiles = [-(-cj // K6_TILE) for cj in cnt]
        tile = torch.cat([torch.arange(cj, device=dev) // K6_TILE + sum(
            ntiles[:i]) for i, cj in enumerate(cnt)])
        xt = plane[0:3, tcell * K:tcell * K + c]
        d = plane_j[0:3, src][:, None, :] - xt[:, :, None]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        f = plane_j[3, src][None, :] * wfn(r2, eps2, r_s, r_cut) * d
        total = torch.zeros_like(xt)
        for s in range(work.shares):
            held, lanes = target[share == s], sub[share == s]
            part = torch.zeros_like(xt)
            for lane in range(work.lanes):
                mine = ((tile % work.shares == s)
                        & (pos_in % K6_TILE % work.lanes == lane))
                who = held[(lanes == lane) & (held >= 0)]
                part[:, who] += f[:, who][:, :, mine].sum(-1)
            total += part
        out[0:3, tcell * K:tcell * K + c] = total
    return out


def _check_cell_plane(name: str, plane, counts, ncells: int, k: int,
                      device, members: int):
    if plane.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes a float32 plane, got "
                        f"{plane.dtype}")
    want = (8, ncells * k) if plane.ndim == 2 else (members, 8, ncells * k)
    if tuple(plane.shape) != want or not plane.is_contiguous():
        raise ValueError(f"{name}: plane {tuple(plane.shape)}, expected a "
                         f"contiguous {want}")
    if counts.dtype != torch.int32:
        raise TypeError(f"{name}: counts must be int32, got {counts.dtype}")
    if (counts.device != device or plane.device != device
            or counts.numel() != members * ncells
            or not counts.is_contiguous()):
        raise ValueError(f"{name}: the plane and its counts must be "
                         f"contiguous, on {device}, with {members} x "
                         f"{ncells} cells")


def _k6_run(lib, geo: K6Geometry, plane, counts, plane_j, counts_j, *,
            nx: int, ncell: int, K: int, K_j: int, eps2: float, r_s: float,
            r_cut: float, split: str, softening: str):
    """K6 from the kernel library ``lib`` in the launch shape ``geo``, on
    planes :func:`run_cell_plane` has checked, on the current stream: one
    launch over every member of batched planes, which writes the whole
    output plane."""
    out = torch.empty_like(plane)
    dev = plane.device
    ctx = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
           else torch.cuda.device(dev))
    with ctx:
        err = lib.p3m_cells_f32(
            plane.data_ptr(), plane_j.data_ptr(), counts.data_ptr(),
            counts_j.data_ptr(), plane.shape[0] if plane.ndim == 3 else 1,
            nx, ncell, K, K_j, math.sqrt(float(eps2)),
            float(r_s), float(r_cut), _SPLITS[split], _SOFTENINGS[softening],
            geo.warps, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"run_cell_plane: CUDA launch failed (error {err})")
    return out


def run_cell_plane(plane, counts, *, nx: int, ncell: int, K: int,
                   eps2: float, r_s: float, r_cut: float,
                   split: str = "gaussian", softening: str = "plummer",
                   plane_j=None, K_j: int = 0, counts_j=None):
    """K6: the cell-pair sum over a ghost-padded plane from
    :func:`build_padded_plane` -> an output plane of the same shape whose
    rows 0-2 hold the sums at the real cells' stored targets (see
    :func:`cell_plane_plain`).  ``plane`` is (8, (nx + 2) M^2 K) with
    ``counts`` its (nx + 2) M^2 per-cell counts; ``plane_j``/``K_j``/
    ``counts_j`` an optional SOURCE plane of the same cell geometry with
    its own bucket width (the rung tier's active-target plane against the
    full plane).  B members' planes (B, 8, ...) with their counts (B, ...)
    make one launch, each member with the blocks and the bits of its own.
    A CUDA plane launches the kernel (a block a real cell,
    the warps a block from :func:`k6_geometry`; K a multiple of 4) or
    raises; a CPU plane takes the plain version.
    ``run_cell_plane.launches`` counts kernel launches."""
    if split not in _SPLITS or softening not in _SOFTENINGS:
        raise ValueError(f"unknown split/softening {split!r}/{softening!r}")
    if plane.device.type == "cpu":
        return cell_plane_plain(plane, counts, nx=nx, ncell=ncell, K=K,
                                eps2=eps2, r_s=r_s, r_cut=r_cut, split=split,
                                softening=softening, plane_j=plane_j,
                                K_j=K_j, counts_j=counts_j)
    if plane.device.type != "cuda":
        raise ValueError(f"run_cell_plane: no kernel for {plane.device}")
    ncells = (nx + 2) * (ncell + 2) ** 2
    members = plane.shape[0] if plane.ndim == 3 else 1
    _check_cell_plane("run_cell_plane plane", plane, counts, ncells, K,
                      plane.device, members)
    if K % 4:
        raise ValueError(f"run_cell_plane: K {K} is not a multiple of 4")
    if plane_j is None:
        plane_j, K_j, counts_j = plane, K, counts
    elif K_j <= 0 or counts_j is None:
        raise ValueError("plane_j requires its bucket width K_j and counts_j")
    else:
        _check_cell_plane("run_cell_plane plane_j", plane_j, counts_j,
                          ncells, K_j, plane.device, members)
    from nbody_torch._kernels import load_library

    lib = load_library()
    geo = k6_geometry(nx, ncell, _k6_info(lib, plane.device.index,
                                          _SPLITS[split],
                                          _SOFTENINGS[softening]))
    out = _k6_run(lib, geo, plane, counts, plane_j, counts_j, nx=nx,
                  ncell=ncell, K=K, K_j=K_j, eps2=eps2, r_s=r_s, r_cut=r_cut,
                  split=split, softening=softening)
    run_cell_plane.launches += 1
    return out


run_cell_plane.launches = 0


def p3m_short_cells_pallas(pos, mass, box: float, eps: float, r_s: float,
                           r_cut: float, G: float = 1.0, *, ncell: int,
                           capacity: int, split: str = "gaussian",
                           softening: str = "plummer"):
    """Short-range P3M force over the ghost-padded cell plane (K6).

    Returns (acc (N, 3) in ``pos``'s dtype, overflow 0-d tensor): the
    particles of over-full cells lose their short-range term and are
    counted in ``overflow``.  B members, ``pos`` (B, N, 3), share one
    capacity: one plane build, one K6 launch, acc (B, N, 3) and the
    largest member's count."""
    if box / ncell < r_cut - 1e-9:
        raise ValueError(f"cell size {box / ncell:.3f} < r_cut {r_cut:.3f}")
    plane, overflow, K, gidx, counts = build_padded_plane(
        pos, mass, box, r_cut, ncell, capacity)
    out = run_cell_plane(plane, counts, nx=ncell, ncell=ncell, K=K,
                         eps2=float(eps) ** 2, r_s=r_s, r_cut=r_cut,
                         split=split, softening=softening)
    from nbody_torch.forces.p3m_columns import read_back

    return G * read_back(out, gidx, 3).to(pos.dtype), torch.amax(overflow)


def p3m_short_cells_pallas_masked(pos, mass, target, box: float, eps: float,
                                  r_s: float, r_cut: float, G: float = 1.0,
                                  *, ncell: int, capacity: int,
                                  target_capacity: int,
                                  split: str = "gaussian",
                                  softening: str = "plummer"):
    """Short-range P3M force ON the ``target`` particles FROM all, with
    K6's two-plane form: a compact target plane holding only the targets
    (bucket width K_target) against the full source plane, so the work
    scales with K_target * K_source.  Non-target rows come back 0.

    Returns (acc (N, 3), overflow_source, overflow_target,
    occupancy_target): the two planes' bucket spills, which heal
    different capacities, and the densest target cell's true occupancy,
    which the driver pre-warms the next segment's target capacity from."""
    if box / ncell < r_cut - 1e-9:
        raise ValueError(f"cell size {box / ncell:.3f} < r_cut {r_cut:.3f}")
    plane_j, ov_j, K_j, _, counts_j = build_padded_plane(
        pos, mass, box, r_cut, ncell, capacity)
    plane_i, ov_i, K_i, gidx, counts_i = build_padded_plane(
        pos, mass, box, r_cut, ncell, target_capacity, valid=target)
    C3 = ncell**3
    cid = torch.where(target, cell_ids(pos, box, ncell), C3)
    occ_i = torch.bincount(cid, minlength=C3 + 1)[:C3].max()
    out = run_cell_plane(plane_i, counts_i, nx=ncell, ncell=ncell, K=K_i,
                         eps2=float(eps) ** 2, r_s=r_s, r_cut=r_cut,
                         split=split, softening=softening, plane_j=plane_j,
                         K_j=K_j, counts_j=counts_j)
    from nbody_torch.forces.p3m_columns import read_back

    return G * read_back(out, gidx, 3).to(pos.dtype), ov_j, ov_i, occ_i
