"""Supercell P3M tier: one particle sort into z-ordered (x, y) columns
feeds the PM deposit, and the PM readback is fused into the short-range
column pair sum.

Counterpart of :mod:`nbody.forces.pm_supercell`: the fresh plane, which
can also emit a frozen column plan, and the evaluation on a frozen plan
(:func:`p3m_supercell_frozen`).
When the PM mesh tiles the chaining columns (S = nmesh / ncell mesh cells
per column side), a force evaluation is: the column plane of
:func:`nbody_torch.forces.p3m_columns.build_column_plane`; K2, the CIC
deposit of the plane's real slots onto the mesh; the FFT Poisson solve
(:meth:`nbody_torch.forces.pm.PMForce.force_grids_from_rho`); K3, which
starts each target's output at the PM force read back from the force
grids and adds the short-range sum over its 9 neighbour windows; and one
per-particle read of the output plane.

Both kernels are CUDA (``forces/csrc/pm_supercell.cu``) on CUDA tensors,
and their plain PyTorch versions on CPU tensors:
:func:`deposit_node_masses_plain` (the JAX package's per-column haloed
node masses, then :func:`fold_node_masses`) and
:func:`fused_column_plane_plain`.
"""

from __future__ import annotations

import contextlib
import itertools
import math

import torch

from nbody_torch.forces.p3m import _SOFTENINGS, _SPLITS
from nbody_torch.forces.p3m_columns import (
    ColumnPlan,
    build_column_plane,
    check_plane_args,
    column_pair_sums,
    column_window,
    columns_stride_ok,
    encode_overflow,
    frozen_plane,
    interior_slots,
    plane_geometry,
    plane_members,
    reach_args,
    read_back,
)
from nbody_torch.forces.pm import pm_module


def supercell_geometry(nmesh: int, ncell: int):
    """(S, ZP) for the supercell tier, or None if unsupported: S = mesh
    cells per column side (an integer <= 13, so the haloed (S + 3)^2 node
    grid of a column packs into 16 x 16 rows), ZP = the 128-aligned z-node
    width (nmesh + 4 nodes: -1 .. nmesh + 2)."""
    if nmesh % ncell:
        return None
    S = nmesh // ncell
    if S > 13:
        return None
    ZP = -(-(nmesh + 4) // 128) * 128
    return S, ZP


def deposit_node_masses_plain(plane, counts, *, ncell: int, S: int, ZP: int,
                              stride: int, gz: int, scale: float,
                              shift: float = 0.0, max_elems: int = 1 << 24,
                              nx: int | None = None, row0: int = 0):
    """CIC node masses of each interior column's real slots on its haloed
    16 x 16 x ZP node grid, in the plane's dtype: (ncol * 256, ZP), row
    a * 16 + b = node (a - 1, b - 1) of the column's tile, lane l = z node
    l - 1.  Every weight is the CIC triangle max(0, 1 - |u - node|) of the
    coordinates in mesh cells minus ``shift``, as in the JAX package's
    kernel; columns are processed in groups of at most ``max_elems``
    weights.  ``nx`` is the plane's count of interior x-rows (ncell, or a
    slab's ncell / D: ncol = nx * ncell) and ``row0`` the box's x-row of
    the first (a slab's plane keeps box coordinates)."""
    dev, dt = plane.device, plane.dtype
    ncol = (ncell if nx is None else nx) * ncell
    P = ncell + 2
    CK = stride - 2 * gz
    lane = torch.arange(256, device=dev)
    node_a = (lane // 16).to(dt) - 1.0
    node_b = (lane % 16).to(dt) - 1.0
    node_z = torch.arange(ZP, device=dev).to(dt) - 1.0
    r = torch.arange(CK, device=dev)
    out = torch.empty((ncol, 256, ZP), dtype=dt, device=dev)
    step = max(1, max_elems // (CK * max(256, ZP)))
    for c0 in range(0, ncol, step):
        c = torch.arange(c0, min(ncol, c0 + step), device=dev)
        pcol = (c // ncell + 1) * P + (c % ncell + 1)
        slots = (pcol * stride + gz)[:, None] + r[None, :]
        x0 = ((c // ncell + row0) * S).to(dt)[:, None]
        y0 = ((c % ncell) * S).to(dt)[:, None]
        x = plane[0][slots] * scale - x0 - shift
        y = plane[1][slots] * scale - y0 - shift
        z = plane[2][slots] * scale - shift
        live = r[None, :] < counts[c].to(torch.int64)[:, None]
        wm = torch.where(live, plane[3][slots], torch.zeros((), dtype=dt,
                                                              device=dev))
        wxy = (torch.clamp_min(1.0 - torch.abs(x[..., None] - node_a), 0.0)
               * torch.clamp_min(1.0 - torch.abs(y[..., None] - node_b), 0.0)
               * wm[..., None])
        wz = torch.clamp_min(1.0 - torch.abs(z[..., None] - node_z), 0.0)
        out[c0:c0 + c.numel()] = torch.bmm(wxy.transpose(1, 2), wz)
    return out.reshape(ncol * 256, ZP)


def _fold_rows(O, t_axis: int, r_axis: int, S: int):
    """Overlap-add one axis's 16 node rows (node = row - 1) onto the S core
    nodes of each tile: node g of tile t is node g mod S of tile
    t + g // S (periodic in the tiles)."""
    core = O.narrow(r_axis, 1, S).clone()
    for r in [0] + list(range(S + 1, min(S + 4, 16))):
        q, loc = divmod(r - 1, S)
        core.narrow(r_axis, loc, 1).add_(
            torch.roll(O.narrow(r_axis, r, 1), q, dims=t_axis))
    return core


def fold_node_masses(nodes, *, ncell: int, S: int, ZP: int, nmesh: int):
    """The (nmesh,)^3 mass grid from the per-column haloed node masses of
    :func:`deposit_node_masses_plain`: halo rows onto the neighbouring
    tiles, z nodes -1 / nmesh .. nmesh + 2 onto their periodic images."""
    O = nodes.reshape(ncell, ncell, 16, 16, ZP)
    A = _fold_rows(O, t_axis=0, r_axis=2, S=S)
    B = _fold_rows(A, t_axis=1, r_axis=3, S=S)
    grid = B.permute(0, 2, 1, 3, 4).reshape(nmesh, nmesh, ZP)
    ext = grid[..., : nmesh + 4]
    res = ext[..., 1: nmesh + 1].clone()
    res[..., nmesh - 1] += ext[..., 0]
    res[..., 0] += ext[..., nmesh + 1]
    res[..., 1] += ext[..., nmesh + 2]
    res[..., 2] += ext[..., nmesh + 3]
    return res


def fold_slab_node_masses(nodes, *, nx: int, ncell: int, S: int, ZP: int,
                          nmesh: int):
    """The haloed (nx * S + 3, nmesh, nmesh) mass slab of a slab plane's
    per-column node masses (:func:`deposit_node_masses_plain` with ``nx``):
    y and z fold periodically as in :func:`fold_node_masses`; x does not
    wrap, and plane p holds local node p - 1 (node -1 and nodes nx * S,
    nx * S + 1 belong to the neighbouring slabs, :func:`slab_halo_fold`).
    The fold of the JAX package's ``supercell_deposit_local`` before its
    ppermutes."""
    nml = nx * S
    O = nodes.reshape(nx, ncell, 16, 16, ZP)
    A = _fold_rows(O, t_axis=1, r_axis=3, S=S)  # (nx, ncell, 16, S, ZP)
    ext_z = A[..., : nmesh + 4]
    Az = ext_z[..., 1: nmesh + 1].clone()
    Az[..., nmesh - 1] += ext_z[..., 0]
    Az[..., 0] += ext_z[..., nmesh + 1]
    Az[..., 1] += ext_z[..., nmesh + 2]
    Az[..., 2] += ext_z[..., nmesh + 3]
    ext = torch.zeros((nml + 3, ncell, S, nmesh), dtype=nodes.dtype,
                      device=nodes.device)
    for r in range(S + 3):
        # tile t's row r is local node t * S + r - 1, plane t * S + r
        ext[r: r + nx * S: S] += Az[:, :, r]
    return ext.reshape(nml + 3, nmesh, nmesh)


def slab_halo_fold(exts: list, group) -> list:
    """The shards' (nml, nmesh, nmesh) mass slabs from their haloed slabs
    (nml + 3 planes, plane p = local node p - 1): node -1 goes to the left
    neighbour's last plane, nodes nml and nml + 1 to the right neighbour's
    first two (a ppermute each way, as ``supercell_deposit_local``)."""
    nml = exts[0].shape[0] - 3
    left = group.ppermute([e[0] for e in exts], -1)
    right = group.ppermute([e[nml + 1: nml + 3] for e in exts], +1)
    out = []
    for e, lf, rt in zip(exts, left, right):
        g = e[1: nml + 1].clone()
        g[nml - 1] += lf
        g[0:2] += rt
        out.append(g)
    return out


def deposit_fixed_exponent(mass_max: float, nslots: int) -> int:
    """K2's fixed-point exponent: the corner masses are scaled by 2^e and
    rounded to 64-bit integers, e chosen so that ``nslots`` masses below
    2^k (k from the largest real mass, ``mass_max``) sum below 2^62; 0
    when no mass is positive.  ``nslots`` is the plane's count of real
    slots (its deposited particles), which does not depend on the
    capacity, so neither do the rounded weights."""
    if not mass_max > 0.0:
        return 0
    return 62 - math.frexp(float(mass_max))[1] - int(nslots).bit_length()


def deposit_fixed(size: int, node, w, e: int):
    """K2's sums as the kernel forms them, from :func:`deposit_atomics`:
    each corner weight scaled by 2^e and rounded to an integer, the
    integers summed (exact, in any order) into ``size`` nodes, each sum
    rounded once to float32 and scaled back.  Returns (sums (size,) int64,
    node masses (size,) float32)."""
    ok = node >= 0
    q = torch.round(torch.ldexp(w[ok].double(),
                                torch.tensor(float(e), dtype=torch.float64)))
    sums = torch.zeros(size, dtype=torch.int64, device=w.device)
    sums.index_add_(0, node[ok], q.to(torch.int64))
    rho = torch.ldexp(sums.to(torch.float32),
                      torch.tensor(float(-e), dtype=torch.float32))
    return sums, rho


def deposit_atomics(plane, counts, *, ncell: int, S: int, nmesh: int,
                    stride: int, gz: int, scale: float, shift: float = 0.0,
                    nx: int | None = None, row0: int = 0):
    """K2's atomics, in plain PyTorch as the kernel issues them (a model
    of the device code, for the tests): for each real slot its 8 corners
    k = (a, b, c) = (k // 4, k // 2 % 2, k % 2), with coordinates and
    weights rounded op by op as the kernel's.  Returns (node (ncol, CK, 8)
    int64, the corner's mesh offset, -1 outside a slab's halo or past
    counts; w (ncol, CK, 8) float32, its weight) and the exponent
    :func:`deposit_fixed_exponent` gives from the largest real mass and
    the plane's count of real slots (the sum of ``counts``)."""
    nx = ncell if nx is None else nx
    ncol = nx * ncell
    P = ncell + 2
    CK = stride - 2 * gz
    dev = plane.device
    c = torch.arange(ncol, device=dev)
    r = torch.arange(CK, device=dev)
    slots = (((c // ncell + 1) * P + c % ncell + 1) * stride + gz)[:, None] \
        + r[None, :]
    live = r[None, :] < counts.to(torch.int64)[:, None]
    f32 = torch.float32
    p32 = plane.to(f32)
    sc = torch.tensor(scale, dtype=f32)
    sh = torch.tensor(shift, dtype=f32)
    x = p32[0][slots] * sc - ((c // ncell + row0) * S).to(f32)[:, None] - sh
    y = p32[1][slots] * sc - ((c % ncell) * S).to(f32)[:, None] - sh
    z = p32[2][slots] * sc - sh
    m = p32[3][slots]
    fx0, fy0, fz0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - fx0, y - fy0, z - fz0
    ix = fx0.to(torch.int64) + (c // ncell * S)[:, None]
    iy = fy0.to(torch.int64) + (c % ncell * S)[:, None]
    iz = fz0.to(torch.int64)
    slab = nx != ncell
    nodes, ws = [], []
    for k in range(8):
        a, b, cz = k // 4, k // 2 % 2, k % 2
        if slab:
            px = ix + a + 1
            ok = (px >= 0) & (px < nx * S + 3) & live
        else:
            px = torch.remainder(ix + a, nmesh)
            ok = live
        node = ((px * nmesh + torch.remainder(iy + b, nmesh)) * nmesh
                + torch.remainder(iz + cz, nmesh))
        nodes.append(torch.where(ok, node, -1))
        wxy = (fx if a else 1.0 - fx) * (fy if b else 1.0 - fy) * m
        ws.append(wxy * (fz if cz else 1.0 - fz))
    m_max = float(torch.where(live, m.abs(), 0.0).max()) if ncol else 0.0
    return (torch.stack(nodes, dim=-1), torch.stack(ws, dim=-1),
            deposit_fixed_exponent(m_max, int(counts.sum())))


def supercell_deposit_from_plane(plane, counts, *, box: float, nmesh: int,
                                 ncell: int, stride: int, gz: int,
                                 chunk: int = 256, shift: float = 0.0,
                                 nx: int | None = None, row0: int = 0):
    """K2: CIC deposit of a column plane's real slots (the first
    ``counts[c]`` interior slots of each column; ghosts excluded) onto the
    (nmesh,)^3 mesh, coordinates in cells minus ``shift``: the contract of
    :func:`nbody_torch.mesh.cic.cic_deposit` over the deposited particles.
    With ``nx`` < ncell the plane is a slab's (nx interior x-rows from the
    box's x-row ``row0``, box coordinates) and the result its haloed
    (nx * S + 3, nmesh, nmesh) slab (:func:`fold_slab_node_masses`;
    :func:`supercell_deposit_local` sends the halo planes on).

    A CUDA plane launches the kernel (a thread a real slot, its corner
    masses summed in 64-bit integer fixed point, exact in any order, so
    two launches give the same bits; :func:`deposit_atomics`) or raises; a
    CPU plane takes :func:`deposit_node_masses_plain` +
    :func:`fold_node_masses` (or :func:`fold_slab_node_masses`).  B
    members' planes (B, 8, ...) with their counts (B, ncol) give B mass
    grids from one launch, each member at its own fixed-point exponent
    (its bits those of its own launch).
    ``supercell_deposit_from_plane.launches`` counts kernel launches."""
    geom = supercell_geometry(nmesh, ncell)
    if geom is None:
        raise ValueError(
            f"supercell deposit needs nmesh % ncell == 0 and nmesh/ncell <= "
            f"13 (got nmesh={nmesh}, ncell={ncell})")
    S, ZP = geom
    nx = ncell if nx is None else nx
    slab = nx != ncell
    scale = float(nmesh / box)
    if plane.device.type == "cpu" and plane.ndim == 3:
        return torch.stack([supercell_deposit_from_plane(
            plane[b], counts[b], box=box, nmesh=nmesh, ncell=ncell,
            stride=stride, gz=gz, chunk=chunk, shift=shift, nx=nx, row0=row0)
            for b in range(plane.shape[0])])
    if plane.device.type == "cpu":
        nodes = deposit_node_masses_plain(
            plane, counts, ncell=ncell, S=S, ZP=ZP, stride=stride, gz=gz,
            scale=scale, shift=float(shift), nx=nx, row0=row0)
        if slab:
            return fold_slab_node_masses(nodes, nx=nx, ncell=ncell, S=S,
                                         ZP=ZP, nmesh=nmesh)
        return fold_node_masses(nodes, ncell=ncell, S=S, ZP=ZP, nmesh=nmesh)
    if plane.device.type != "cuda":
        raise ValueError(f"supercell_deposit_from_plane: no kernel for "
                         f"{plane.device}")
    CK = stride - 2 * gz
    members = check_plane_args("supercell_deposit_from_plane", plane,
                               {"counts": counts}, maxch=CK // chunk,
                               ncell=ncell, stride=stride, nx=nx)
    from nbody_torch._kernels import load_library

    lib = load_library()
    dev = plane.device
    grid = (nx * S + 3 if slab else nmesh, nmesh, nmesh)
    rho = torch.empty(plane.shape[:-2] + grid, dtype=torch.float32,
                      device=dev)
    # each member's integer sums, then a word a member (its largest mass
    # and its count of real slots)
    scratch = torch.empty((rho.numel() + members,), dtype=torch.int64,
                          device=dev)
    ctx = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
           else torch.cuda.device(dev))
    with ctx:
        err = lib.pm_supercell_deposit_f32(
            plane.data_ptr(), counts.data_ptr(), members, nx, ncell, int(slab), row0,
            S, nmesh, stride, gz, CK, scale, float(shift), rho.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"supercell_deposit_from_plane: CUDA launch "
                           f"failed (error {err})")
    supercell_deposit_from_plane.launches += 1
    return rho


supercell_deposit_from_plane.launches = 0


def _cic_read(grids, x, y, z, x0, y0, slab: bool = False):
    """Trilinear read of (C, X, N, N) grids at coordinates in cells, x and
    y relative to the tile origin (x0, y0): (C,) + x.shape.  x is periodic
    over X = N, or on a ``slab`` a haloed axis whose plane p holds local
    node p - 1 (a corner outside it reads nothing)."""
    nmesh = grids.shape[-1]
    flat = grids.reshape(grids.shape[0], -1)
    s = [x, y, z]
    base = [torch.floor(u) for u in s]
    f = [u - b for u, b in zip(s, base)]
    idx = [base[0].to(torch.int64) + x0, base[1].to(torch.int64) + y0,
           base[2].to(torch.int64)]
    out = 0.0
    for d in itertools.product((0, 1), repeat=3):
        w = 1.0
        for ax in range(3):
            w = w * (f[ax] if d[ax] else 1.0 - f[ax])
        if slab:
            px = idx[0] + d[0] + 1
            inside = (px >= 0) & (px < grids.shape[1])
            w = torch.where(inside, w, torch.zeros_like(w))
            px = torch.where(inside, px, torch.zeros_like(px))
        else:
            px = (idx[0] + d[0]) % nmesh
        lin = ((px * nmesh + (idx[1] + d[1]) % nmesh) * nmesh
               + (idx[2] + d[2]) % nmesh)
        out = out + w * flat[:, lin]
    return out


def column_pm_readback(plane, nch, grids, *, ncell: int, stride: int,
                       gz: int, chunk: int, S: int, scale: float,
                       interlaced: bool = False, nx: int | None = None,
                       row0: int = 0):
    """The PM force at every occupied chunk's target slot, in the plane's
    dtype: (targets (B, chunk), force (3, B, chunk)); with ``interlaced``
    the mean of the unshifted read of grids 0-2 and the read of grids 3-5
    at -0.5 cell.  With ``nx`` < ncell the plane is a slab's (from the
    box's x-row ``row0``) and ``grids`` its haloed slab grids
    (:func:`extract_local_subgrids`)."""
    dev = plane.device
    slab = nx is not None and nx != ncell
    ic, _, first = interior_slots(ncell, stride, gz, chunk, nch, dev, nx=nx)
    tgt = first[:, None] + torch.arange(chunk, device=dev)[None, :]
    ix0 = (ic // ncell * S)[:, None]
    iy0 = (ic % ncell * S)[:, None]
    x = plane[0][tgt] * scale - (ix0 + row0 * S).to(plane.dtype)
    y = plane[1][tgt] * scale - iy0.to(plane.dtype)
    z = plane[2][tgt] * scale
    g = grids.to(plane.dtype)
    f = _cic_read(g[0:3], x, y, z, ix0, iy0, slab)
    if interlaced:
        f1 = _cic_read(g[3:6], x - 0.5, y - 0.5, z - 0.5, ix0, iy0, slab)
        f = 0.5 * (f + f1)
    return tgt, f


def fused_column_plane_plain(plane, ws, nch, grids, *, ncell: int,
                             stride: int, W: int, maxch: int, gz: int,
                             chunk: int, eps: float, r_s: float, r_cut: float,
                             split: str, softening: str, S: int, scale: float,
                             split_out: bool = False,
                             interlaced: bool = False,
                             nx: int | None = None, row0: int = 0):
    """Plain PyTorch version of K3: the output plane, shaped like
    ``plane``, whose rows 0-2 hold PM + short-range force at the occupied
    chunks' slots of the interior columns (``split_out``: short range in
    rows 0-2, PM in rows 3-5), zeros elsewhere; ``nx`` and ``row0`` as in
    :func:`column_pm_readback`.  B members' planes (B, 8, ...), tables
    and grids (B, ...) give B output planes, each member alone."""
    if plane.ndim == 3:
        return torch.stack([fused_column_plane_plain(
            plane[b], ws[b], nch[b], grids[b], ncell=ncell, stride=stride,
            W=W, maxch=maxch, gz=gz, chunk=chunk, eps=eps, r_s=r_s,
            r_cut=r_cut, split=split, softening=softening, S=S, scale=scale,
            split_out=split_out, interlaced=interlaced, nx=nx, row0=row0)
            for b in range(plane.shape[0])])
    tgt, pm = column_pm_readback(plane, nch, grids, ncell=ncell,
                                 stride=stride, gz=gz, chunk=chunk, S=S,
                                 scale=scale, interlaced=interlaced, nx=nx,
                                 row0=row0)
    _, short = column_pair_sums(
        plane, ws, nch, ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
        chunk=chunk, eps=eps, r_s=r_s, r_cut=r_cut, split=split,
        softening=softening, nx=nx)
    out = torch.zeros_like(plane)
    flat = tgt.reshape(-1)
    if split_out:
        out[0:3, flat] = short.reshape(3, -1)
        out[3:6, flat] = pm.reshape(3, -1)
    else:
        out[0:3, flat] = (pm + short).reshape(3, -1)
    return out


def launch_fused(lib, plane, ws, nch, grids, *, ncell: int, stride: int,
                 W: int, maxch: int, gz: int, chunk: int, eps: float,
                 r_s: float, r_cut: float, split: str, softening: str,
                 S: int, scale: float, split_out: bool, interlaced: bool,
                 nx: int, row0: int, box: float, drift):
    """One launch of K3 from the kernel library ``lib`` on checked
    arguments, over every member of a batched plane -> the output plane;
    raises if the launch fails.  The
    wrapper calls it with the port's library, the ablation with its
    variants'."""
    out = torch.zeros_like(plane)
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    with torch.cuda.device(plane.device):
        err = lib.pm_supercell_fused_f32(
            plane.data_ptr(), ws.data_ptr(), nch.data_ptr(),
            grids.data_ptr(), plane_members(plane), grids.shape[-1],
            int(interlaced),
            int(split_out), nx, ncell, int(nx != ncell), row0, S,
            float(scale), stride, W, maxch, gz, chunk, float(eps),
            float(r_s), float(r_cut), float(box),
            None if drift is None else drift.data_ptr(), _SPLITS[split], _SOFTENINGS[softening], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"run_fused_column_plane: CUDA launch failed "
                           f"(error {err})")
    return out


def run_fused_column_plane(plane, ws, nch, grids, *, ncell: int, stride: int,
                           W: int, maxch: int, gz: int, chunk: int,
                           eps: float, r_s: float, r_cut: float, split: str,
                           softening: str, S: int, scale: float,
                           split_out: bool = False,
                           interlaced: bool = False,
                           nx: int | None = None, row0: int = 0,
                           drift=None):
    """K3: the PM readback from the (3 or 6, N, N, N) force ``grids``
    fused with the short-range column pair sum -> the output plane of
    :func:`fused_column_plane_plain`.  With ``nx`` < ncell the plane is a
    slab's (from the box's x-row ``row0``, box coordinates) and ``grids``
    the slab's haloed (3 or 6, nx * S + 4, N, N) grids
    (:func:`extract_local_subgrids`).  B members' planes (B, 8, ...),
    tables and grids (B, 3 or 6, ...) make one launch, each member's sums
    those of its own launch.  A CUDA plane launches the
    kernel or raises; a CPU plane takes the plain version.  The kernel
    takes the box from ``scale`` (N / box) and, for a frozen plane, its
    ``drift`` (:func:`~nbody_torch.forces.p3m_columns.frozen_plane`).
    ``run_fused_column_plane.launches`` counts kernel launches."""
    if split not in _SPLITS or softening not in _SOFTENINGS:
        raise ValueError(f"unknown split/softening {split!r}/{softening!r}")
    nx = ncell if nx is None else nx
    kw = dict(ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
              chunk=chunk, eps=eps, r_s=r_s, r_cut=r_cut, split=split,
              softening=softening, S=S, scale=scale, split_out=split_out,
              interlaced=interlaced, nx=nx, row0=row0)
    if plane.device.type == "cpu":
        return fused_column_plane_plain(plane, ws, nch, grids, **kw)
    if plane.device.type != "cuda":
        raise ValueError(f"run_fused_column_plane: no kernel for "
                         f"{plane.device}")
    check_plane_args("run_fused_column_plane", plane, {"ws": ws, "nch": nch},
                     maxch=maxch, ncell=ncell, stride=stride, nx=nx)
    nmesh = grids.shape[-1]
    nc = 6 if interlaced else 3
    nxg = nx * S + 4 if nx != ncell else nmesh
    want = plane.shape[:-2] + (nc, nxg, nmesh, nmesh)
    if (grids.dtype != torch.float32 or grids.device != plane.device
            or tuple(grids.shape) != want or not grids.is_contiguous()):
        raise ValueError(f"run_fused_column_plane: grids must be contiguous "
                         f"float32 {want} on {plane.device}, got "
                         f"{grids.dtype} {tuple(grids.shape)}")
    from nbody_torch._kernels import load_library

    out = launch_fused(load_library(), plane, ws, nch, grids,
                       **reach_args("run_fused_column_plane", plane,
                                    nmesh / float(scale), drift), **kw)
    run_fused_column_plane.launches += 1
    return out


run_fused_column_plane.launches = 0


def supercell_params(box: float, nmesh: int, n: int):
    """(r_s, r_cut, ncell, col_capacity, window) for the supercell tier,
    or None when no chaining grid both tiles the mesh and respects r_cut
    (ncell = :func:`nbody_torch.forces.p3m.supercell_ncell`)."""
    from nbody_torch.forces.p3m import (
        auto_column_capacity,
        p3m_short_params,
        supercell_ncell,
    )

    r_s, r_cut, _, _ = p3m_short_params(box, nmesh, n)
    ncell = supercell_ncell(box, nmesh, r_cut)
    if ncell is None:
        return None
    col_capacity = auto_column_capacity(n, ncell)
    return r_s, r_cut, ncell, col_capacity, column_window(
        box, r_cut, col_capacity)


def supercell_stride_ok(box: float, r_cut: float, col_capacity: int) -> bool:
    """True when the column stride at this capacity is within the stride
    budget (past it the columns tier carries the force).  The JAX
    package's fused kernel has its own budget (TPU scoped VMEM), equal to
    the column kernels' ``p3m_columns._STRIDE_MAX``; the CUDA kernels have
    no such limit, but the port keeps the rule so that both packages
    resolve the same tier for a config."""
    return columns_stride_ok(box, r_cut, col_capacity)


def p3m_supercell_acc(pos, mass, box: float, nmesh: int, G: float = 1.0,
                      eps: float = 0.0, r_s: float = 0.0, r_cut: float = 0.0,
                      deconvolve_p: int = 2, split: str = "spline",
                      softening: str = "plummer", *, ncell: int,
                      col_capacity: int, window: int, grad_order: str = "fd4",
                      chunk: int = 256, part_split: bool = False,
                      interlace: bool = False, skin: float = 0.0,
                      with_plan: bool = False):
    """Full P3M force (PM far field + short-range correction) from one
    particle sort: K2 deposit, FFT Poisson, K3 readback + pair sum.  B
    members, ``pos`` (B, N, 3), share one capacity and window: one plane
    build, one launch of K2 and of K3, batched FFTs; acc (B, N, 3) and the
    batch's overflow word (:func:`encode_overflow`).

    Returns (acc (N, 3), overflow) with the columns tier's field-encoded
    overflow word (a 0-d tensor); an overflowed particle loses its whole
    force, which the driver's capacity heal repairs.  ``interlace=True``
    deposits a second time at the half-cell shift, alias-cancels in k and
    averages the two readbacks.  ``part_split=True`` returns (acc_long,
    acc_short, overflow) from the same evaluation.  ``with_plan=True``
    appends the :class:`ColumnPlan` of the same sort, its tables widened
    by ``skin`` (the rung tier's boundary tick hands it to the next
    step's interior ticks)."""
    geom = supercell_geometry(nmesh, ncell)
    if geom is None:
        raise ValueError(f"nmesh={nmesh} does not tile ncell={ncell}")
    if box / ncell < r_cut - 1e-9:
        raise ValueError(f"column size {box / ncell:.3f} < r_cut {r_cut:.3f}")
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut,
                                                     col_capacity, window,
                                                     chunk)
    built = build_column_plane(pos, mass, box, float(r_cut), ncell, CK, W,
                               chunk=chunk, skin=float(skin),
                               with_plan=with_plan)
    plane, ws, nch, ov_b, ov_w, gidx, counts = built[:7]
    out = _supercell_eval(
        plane, ws, nch, gidx, counts, pos, mass, box, nmesh, G=G, eps=eps,
        r_s=r_s, r_cut=r_cut, deconvolve_p=deconvolve_p, split=split,
        softening=softening, ncell=ncell, stride=stride, W=W, maxch=maxch,
        gz=gz, chunk=chunk, grad_order=grad_order, part_split=part_split,
        interlace=interlace, ov=encode_overflow(ov_b, ov_w))
    return out + (built[7],) if with_plan else out


def _supercell_eval(plane, ws, nch, gidx, counts, pos, mass, box: float,
                    nmesh: int, *, G: float, eps: float, r_s: float,
                    r_cut: float, deconvolve_p: int, split: str,
                    softening: str, ncell: int, stride: int, W: int,
                    maxch: int, gz: int, chunk: int, grad_order: str,
                    part_split: bool, interlace: bool, ov, drift=None):
    """K2, the FFT solve, K3 and the per-particle read of one column
    plane (a frozen one with its ``drift``): (acc, ov) or (acc_long,
    acc_short, ov)."""
    S, _ = supercell_geometry(nmesh, ncell)
    dkw = dict(box=box, nmesh=nmesh, ncell=ncell, stride=stride, gz=gz,
               chunk=chunk)
    rho = supercell_deposit_from_plane(plane, counts, **dkw)
    rho1 = (supercell_deposit_from_plane(plane, counts, shift=0.5, **dkw)
            if interlace else None)
    # G is applied once at the end (the short-range sum is unscaled), so
    # the Poisson source carries 4 pi rho_mean only; each member's mass
    # summed in float64, exact for equal masses whatever the reduction's
    # order (so a member's bits are its own run's)
    mass_sum = torch.sum(mass, dim=-1, dtype=torch.float64).to(torch.float32)
    amp = 4.0 * math.pi * mass_sum / box**3
    pm = pm_module(float(box), int(nmesh), int(deconvolve_p), bool(interlace),
                   float(r_s) if split == "gaussian" else 0.0,
                   float(r_cut) if split == "spline" else 0.0, grad_order,
                   0.0, plane.device, torch.float32)
    grids = pm.force_grids_from_rho(rho, amp, mass_sum, rho1=rho1)
    out = run_fused_column_plane(
        plane, ws, nch, grids.contiguous(), ncell=ncell, stride=stride, W=W,
        maxch=maxch, gz=gz, chunk=chunk, eps=float(eps), r_s=float(r_s),
        r_cut=float(r_cut), split=split, softening=softening, S=S,
        scale=float(nmesh / box), split_out=part_split,
        interlaced=interlace, drift=drift)
    if part_split:
        both = read_back(out, gidx, 6).to(pos.dtype)
        return G * both[..., 3:6], G * both[..., 0:3], ov
    return G * read_back(out, gidx, 3).to(pos.dtype), ov


def p3m_supercell_frozen(pos, mass, plan: ColumnPlan, box: float, nmesh: int,
                         G: float = 1.0, eps: float = 0.0, r_s: float = 0.0,
                         r_cut: float = 0.0, deconvolve_p: int = 2,
                         split: str = "spline", softening: str = "plummer",
                         *, ncell: int, col_capacity: int, window: int,
                         grad_order: str = "fd4", chunk: int = 256,
                         part_split: bool = False, interlace: bool = False):
    """:func:`p3m_supercell_acc` on a frozen column plan: no sort and no
    window tables; the plane is one row gather at the current positions
    (within skin/2 of the freeze positions, so possibly just outside the
    box and the frozen column: K2 and K3 wrap their mesh indices), K2, K3
    and the read use the plan's windows and slot map.  The driver keeps
    skin/2 below one PM cell.  Returns (acc, plan.ov), or (acc_long,
    acc_short, plan.ov) with ``part_split=True``."""
    geom = supercell_geometry(nmesh, ncell)
    if geom is None:
        raise ValueError(f"nmesh={nmesh} does not tile ncell={ncell}")
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut,
                                                     col_capacity, window,
                                                     chunk)
    plane, _, drift = frozen_plane(pos, mass, plan, box, r_cut, ncell, CK,
                                   gz, stride)
    counts = torch.clamp_max(plan.counts, CK).to(torch.int32)
    return _supercell_eval(
        plane, plan.ws, plan.nch, plan.gidx, counts, pos, mass, box, nmesh,
        G=G, eps=eps, r_s=r_s, r_cut=r_cut, deconvolve_p=deconvolve_p,
        split=split, softening=softening, ncell=ncell, stride=stride, W=W,
        maxch=maxch, gz=gz, chunk=chunk, grad_order=grad_order,
        part_split=part_split, interlace=interlace, ov=plan.ov, drift=drift)


# ---------------------------------------------------------------------------
# The slab tier of the domain decomposition
# ---------------------------------------------------------------------------


def supercell_deposit_local(planes: list, counts: list, *, box: float,
                            nmesh: int, ncell: int, group, stride: int,
                            gz: int, chunk: int = 256,
                            shift: float = 0.0) -> list:
    """Slab sibling of :func:`supercell_deposit_from_plane`: K2 on each
    shard's local column plane (from
    :func:`nbody_torch.forces.p3m_columns.build_local_column_plane`) into
    its haloed slab, then the halo planes to the neighbours
    (:func:`slab_halo_fold`).  Returns the shards' (nmesh / D,
    nmesh, nmesh) mass slabs: the contract of
    :func:`nbody_torch.distributed.domain.slab_deposit` over the deposited
    particles."""
    nx = ncell // group.size
    exts = [supercell_deposit_from_plane(
        p, c, box=box, nmesh=nmesh, ncell=ncell, stride=stride, gz=gz,
        chunk=chunk, shift=shift, nx=nx, row0=d * nx)
        for d, (p, c) in enumerate(zip(planes, counts))]
    return slab_halo_fold(exts, group)


def extract_local_subgrids(grids: list, group) -> list:
    """The shards' haloed force grids (C, nml + 4, N, N) from their local
    (C, nml, N, N) slabs: plane p is local node p - 1, so node -1 is the
    left neighbour's last plane and nodes nml .. nml + 2 the right
    neighbour's first three (a ppermute each way).  K3 reads a slab's
    target forces from them.  The JAX package cuts the same halo into
    per-column 16 x 16 x ZP node subgrids for its MXU contraction; the
    card reads the grids directly (TPU mechanics, see
    ``csrc/pm_supercell.cu``)."""
    nml = grids[0].shape[1]
    from_left = group.ppermute([g[:, nml - 1:] for g in grids], +1)
    from_right = group.ppermute([g[:, :3] for g in grids], -1)
    return [torch.cat([lf, g, rt], dim=1).contiguous()
            for lf, g, rt in zip(from_left, grids, from_right)]
