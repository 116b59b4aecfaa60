"""Block sharding of particles and the forces that ride it.

Counterpart of :mod:`nbody.distributed.sharding`: the shard group of a
run (:func:`device_mesh`), block sharding of a state (:func:`shard_state`)
and the four forces over particle blocks:

* :func:`make_ring_acc_fn`: the ring all-pairs force.  Each shard holds
  N/D targets; the (pos, mass) source blocks rotate around the ring by
  ``ppermute``, and at every hop each shard sums its targets against the
  visiting block with K7 (:func:`~nbody_torch.forces.pallas_pp.
  block_acc_pallas`).
* :func:`make_ring_ewald_acc_fn`: the exact periodic PP force (Ewald) on
  the same ring: the erfc-weighted minimum-image block in torch ops, the
  k-space structure factors ``psum``'d over the shards.
* :func:`make_sharded_pm_cosmo_force`: a shard's CIC deposit, ``psum`` of
  the grids, the replicated FFT Poisson solve, the local gather.
* :func:`make_sharded_p3m_cosmo_force`: that far field with the split
  filter, plus the short range on the replicated grid: every shard builds
  the whole ghost-padded cell plane from the ``all_gather``'d particles
  and runs K6 (:func:`~nbody_torch.forces.p3m.run_cell_plane`) on its
  x-slab of it.

One process drives every shard (:mod:`nbody_torch.distributed.
collectives`).  A force takes the whole (N, 3) and (N,) tensors, the JAX
package's global-array view, cuts them into D row blocks by
:func:`shard_state`'s rule (on one card the blocks are views, not
copies) and returns its result whole, on the input's device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nbody_torch.core import units
from nbody_torch.core.types import ParticleState
from nbody_torch.distributed.collectives import ShardGroup
from nbody_torch.forces.ewald import (
    _BLOCK,
    _full_precision_matmul,
    _half_space_modes,
    _structure_sum,
)
from nbody_torch.forces.p3m import (
    _min_image,
    _weight_fn,
    build_padded_plane,
    run_cell_plane,
)
from nbody_torch.forces.pallas_pp import _PLAIN_PAIRS, block_acc_pallas
from nbody_torch.forces.pm import pm_module
from nbody_torch.mesh.cells import cell_capacity
from nbody_torch.mesh.cic import cic_deposit, cic_gather_vec


def device_mesh(n_devices: int | None = None, device="cuda") -> ShardGroup:
    """A 1-D group of ``n_devices`` shards on ``device``'s kind, placed
    round-robin over the visible cards (shard d on ``cuda:(d % cards)``),
    so four shards on a one-card machine share ``cuda:0``.  ``None`` (or
    0) means one shard a visible card; on the CPU every shard lives on
    the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device_mesh: no CUDA device is visible")
        n = n_devices or cards
        return ShardGroup([torch.device("cuda", d % cards) for d in range(n)])
    if device.type != "cpu":
        raise ValueError(f"device_mesh: no shards on {device}")
    return ShardGroup([device] * (n_devices or 1))


def shard_state(state: ParticleState, group: ShardGroup) -> list:
    """The state's particles block-sharded over the group: shard d holds
    rows [d N / D, (d + 1) N / D), on its device."""
    D = group.size
    if state.n % D:
        raise ValueError(f"N={state.n} not divisible by {D} devices")
    n = state.n // D
    return [ParticleState(pos=state.pos[d * n:(d + 1) * n].to(dev),
                          vel=state.vel[d * n:(d + 1) * n].to(dev),
                          mass=state.mass[d * n:(d + 1) * n].to(dev),
                          time=state.time.to(dev))
            for d, dev in enumerate(group.devices)]


def _blocks(x, group: ShardGroup) -> list:
    """``x``'s rows cut into the group's D blocks, each on its shard's
    device (:func:`shard_state`'s rule)."""
    D = group.size
    if x.shape[0] % D:
        raise ValueError(f"N={x.shape[0]} not divisible by {D} devices")
    n = x.shape[0] // D
    return [x[d * n:(d + 1) * n].to(dev) for d, dev in enumerate(group.devices)]


def _whole(xs, like):
    """The shards' blocks concatenated in shard order on ``like``'s
    device."""
    return torch.cat([x.to(like.device) for x in xs])


def make_ring_acc_fn(group: ShardGroup, eps: float, G: float = 1.0,
                     use_pallas: bool | None = None) -> Callable:
    """acc_fn(pos, mass) -> (acc, phi) by the ring exchange, for whole
    (N, 3)/(N,) tensors (N a multiple of the group's size).  Composes with
    :func:`nbody_torch.integrate.leapfrog.run` and
    ``run_with_diagnostics`` unchanged.

    D hops: at each, shard d sums its targets against the visiting source
    block (at hop h the block of shard d - h) with K7, then passes the
    block forward (``ppermute(+1)``, the JAX package's ``i -> i + 1``).
    ``phi`` has the self-pair term removed.  The tensor's device picks the
    route, as in every wrapper of the port: a CPU tensor takes the plain
    version, a CUDA tensor K7 or an error.  ``use_pallas=False`` asks for
    the plain version, which only shards on the CPU take: with shards on
    another device it raises.  ``eps`` must be > 0."""
    if eps <= 0:
        raise ValueError("make_ring_acc_fn requires eps > 0 (self-pair "
                         "handling)")
    if use_pallas is False and any(d.type != "cpu" for d in group.devices):
        raise ValueError("make_ring_acc_fn: use_pallas=False asks for the "
                         "plain version, which runs on the CPU only; shards "
                         f"on {group.devices[0]} launch K7")
    D = group.size
    self_pot = (float(eps) ** 2) ** -0.5

    def ring(pos, mass):
        pos_l, mass_l = _blocks(pos, group), _blocks(mass, group)
        pj, mj = pos_l, mass_l
        acc = [torch.zeros_like(p) for p in pos_l]
        pot = [torch.zeros_like(m) for m in mass_l]
        for hop in range(D):
            for d in range(D):
                a, p = block_acc_pallas(pos_l[d], pj[d], mj[d], eps)
                acc[d] = acc[d] + a
                pot[d] = pot[d] + p
            if hop < D - 1:
                pj, mj = group.ppermute(pj, 1), group.ppermute(mj, 1)
        phi = [-G * (p - m * self_pot) for p, m in zip(pot, mass_l)]
        return G * _whole(acc, pos), _whole(phi, pos)

    return ring


def _real_space_block(pos_i, pos_j, mass_j, box: float, eps2: float,
                      r_s: float, r_cut: float, wfn):
    """sum_j m_j w(r_ij) d_ij over minimum images, targets i against
    sources j, chunked over targets so that at most ``_PLAIN_PAIRS`` pairs
    are materialized at once."""
    acc = torch.empty_like(pos_i)
    step = max(1, _PLAIN_PAIRS // max(pos_j.shape[0], 1))
    for i0 in range(0, pos_i.shape[0], step):
        d = _min_image(pos_j[None, :, :] - pos_i[i0:i0 + step, None, :], box)
        r2 = torch.sum(d * d, dim=-1)
        wgt = mass_j[None, :] * wfn(r2, eps2, r_s, r_cut)
        acc[i0:i0 + step] = torch.sum(wgt[..., None] * d, dim=1)
    return acc


def make_ring_ewald_acc_fn(group: ShardGroup, box: float, eps: float,
                           G: float = 1.0, r_s: float | None = None,
                           n_max: int = 10,
                           softening: str = "plummer") -> Callable:
    """acc_fn(pos, mass) -> acc: the exact periodic PP force (Ewald) over
    the group's particle blocks, the multi-device sibling of
    :func:`nbody_torch.forces.ewald.ewald_pp_acc`.

    Real-space half: the erfc-weighted pair sum over minimum images
    (r_cut = 0.4999 box, so each pair is taken once, at its nearest
    image) rides the ring: each shard's wrapped block visits every other
    by ``ppermute``.  The JAX package computes this block outside any
    Pallas kernel, and so does the port (torch ops, chunked over
    targets).  k-space half: each shard takes its structure factors
    C_k, S_k with the blocked float32 sum of
    :func:`~nbody_torch.forces.ewald.ewald_kspace_acc`, the shards' float64
    partials are ``psum``'d in shard order, and each shard reads back its
    own rows; the products run in full float32 (no TF32)."""
    if r_s is None:
        r_s = box / 16.0
    r_s = float(r_s)
    D = group.size
    eps2 = float(eps) ** 2
    r_cut = 0.4999 * box
    wfn = _weight_fn("gaussian", softening)
    chunk = 512
    nmod = _half_space_modes(n_max)
    K = nmod.shape[0]
    pad = -(-K // chunk) * chunk
    kv = np.zeros((pad, 3))
    kv[:K] = nmod * (2.0 * np.pi / box)
    k2 = (kv**2).sum(axis=1)
    w = np.zeros(pad)
    w[:K] = np.exp(-k2[:K] * r_s**2) / k2[:K]

    def local(pos, mass):
        dtype = pos.dtype
        mass = mass.to(dtype)
        posw = [torch.remainder(p, box) for p in _blocks(pos, group)]
        mass_l = _blocks(mass, group)
        pj, mj = posw, mass_l
        acc_sr = [torch.zeros_like(p) for p in posw]
        for hop in range(D):
            for d in range(D):
                acc_sr[d] = acc_sr[d] + _real_space_block(
                    posw[d], pj[d], mj[d], box, eps2, r_s, r_cut, wfn)
            if hop < D - 1:
                pj, mj = group.ppermute(pj, 1), group.ppermute(mj, 1)

        # zero-mass rows at the origin fill each block to a multiple of
        # the structure sum's particle block
        n_loc = posw[0].shape[0]
        nblk = -(-n_loc // _BLOCK) * _BLOCK
        pos_p = [torch.nn.functional.pad(p, (0, 0, 0, nblk - n_loc))
                 for p in posw]
        mass_p = [torch.nn.functional.pad(m, (0, nblk - n_loc))
                  for m in mass_l]
        kvecs = [torch.as_tensor(kv, dtype=dtype, device=dev)
                 for dev in group.devices]
        wk = [torch.as_tensor(w, dtype=dtype, device=dev)
              for dev in group.devices]
        acc_lr = [torch.zeros_like(p) for p in pos_p]
        with _full_precision_matmul():
            for c0 in range(0, pad, chunk):
                kc = [k[c0:c0 + chunk] for k in kvecs]
                cs = [torch.cos(p @ k.T) for p, k in zip(pos_p, kc)]
                sn = [torch.sin(p @ k.T) for p, k in zip(pos_p, kc)]
                Ck = group.psum([_structure_sum(m, c, torch.float64)
                                 for m, c in zip(mass_p, cs)])
                Sk = group.psum([_structure_sum(m, s, torch.float64)
                                 for m, s in zip(mass_p, sn)])
                for d in range(D):
                    kw = kc[d] * wk[d][c0:c0 + chunk, None]
                    acc_lr[d] = (acc_lr[d]
                                 + sn[d] @ (kw * Ck[d].to(dtype)[:, None])
                                 - cs[d] @ (kw * Sk[d].to(dtype)[:, None]))
        scale = -2.0 * 4.0 * np.pi / box**3
        return _whole([G * sr + G * (lr[:n_loc] * scale)
                       for sr, lr in zip(acc_sr, acc_lr)], pos)

    return local


def _far_field(pos_l, mass_l, group: ShardGroup, pm_of, amp):
    """The sharded PM far field: each shard's CIC deposit, the grids and
    masses ``psum``'d, the replicated solve on each shard (``pm_of(d)``
    its :class:`~nbody_torch.forces.pm.PMForce`) and the local gather:
    the per-shard (n_loc, 3) accelerations at Poisson amplitude ``amp``."""
    pm0 = pm_of(0)
    box, nmesh = pm0.box, pm0.nmesh
    grids = group.psum([cic_deposit(p, box, nmesh, weights=m)
                        for p, m in zip(pos_l, mass_l)])
    total = group.psum([torch.sum(m) for m in mass_l])
    return [cic_gather_vec(pm_of(d).force_grids_from_rho(g, amp, t), p, box)
            for d, (p, g, t) in enumerate(zip(pos_l, grids, total))]


def _pm_modules(group: ShardGroup, box: float, nmesh: int, deconvolve_p: int,
                grad_order: str, dtype, longrange_split: float = 0.0,
                spline_split: float = 0.0):
    """pm_of(d): shard d's PMForce (one per device and dtype, built
    once a process by :func:`~nbody_torch.forces.pm.pm_module`)."""
    def pm_of(d):
        return pm_module(float(box), int(nmesh), int(deconvolve_p), False,
                         float(longrange_split), float(spline_split),
                         grad_order, 0.0, group.devices[d], dtype)

    return pm_of


def make_sharded_pm_cosmo_force(cosmo, box: float, nmesh: int,
                                group: ShardGroup, deconvolve_p: int = 2,
                                grad_order: str = "fd4") -> Callable:
    """acc_fn(pos, mass, a) -> g, the comoving PM force g = -grad phi with
    lap phi = (3/2) Omega_m H0^2 delta / a, over the group's particle
    blocks: a shard's CIC deposit -> ``psum`` of the grids -> the
    replicated FFT Poisson solve -> the local gather.  No hand kernel."""
    base = 1.5 * cosmo.Omega_m * cosmo.H0**2

    def local(pos, mass, a):
        pos_l, mass_l = _blocks(pos, group), _blocks(mass.to(pos.dtype), group)
        pm_of = _pm_modules(group, box, nmesh, deconvolve_p, grad_order,
                            pos.dtype)
        return _whole(_far_field(pos_l, mass_l, group, pm_of, base / a), pos)

    return local


def sharded_p3m_geometry(box: float, nmesh: int, D: int,
                         r_s: float | None = None,
                         r_cut: float | None = None):
    """(r_s, r_cut, ncell, nxl) of :func:`make_sharded_p3m_cosmo_force`:
    r_s = 1.25 cells and r_cut = 4.5 r_s by default, the cell grid
    int(box / r_cut) rounded down to a multiple of D (raising below
    max(3, D)), nxl = ncell / D real x-layers a shard."""
    cell = box / nmesh
    r_s = 1.25 * cell if r_s is None else float(r_s)
    r_cut = 4.5 * r_s if r_cut is None else float(r_cut)
    ncell = int(box / r_cut)
    ncell -= ncell % D
    if ncell < max(3, D):
        raise ValueError(f"box/r_cut = {box / r_cut:.1f} cannot host {D} "
                         f"x-slabs")
    return r_s, r_cut, ncell, ncell // D


def slice_plane(plane, counts, *, d: int, nxl: int, ncell: int, K: int):
    """Shard d's part of a whole ghost-padded plane: its x-layers
    [d nxl, d nxl + nxl + 2) of the plane and of the per-cell counts, the
    nxl real layers with their two neighbours, as K6's ``nx`` form takes
    them."""
    M = ncell + 2
    rows = slice(d * nxl, d * nxl + nxl + 2)
    local = plane.reshape(8, M, M * M * K)[:, rows].reshape(8, -1)
    return local.contiguous(), counts.reshape(M, M * M)[rows].reshape(-1)


def make_sharded_p3m_cosmo_force(cosmo, box: float, nmesh: int,
                                 group: ShardGroup, eps: float,
                                 deconvolve_p: int = 2, split: str = "spline",
                                 grad_order: str = "fd4",
                                 r_s: float | None = None,
                                 r_cut: float | None = None,
                                 capacity: int | None = None,
                                 checked: bool = False,
                                 softening: str = "plummer") -> Callable:
    """acc_fn(pos, mass, a) -> g, comoving P3M over the group's particle
    blocks: the sharded PM far field with the split filter, plus the
    short range on the replicated grid.

    Short range: the positions and masses are ``all_gather``'d; every
    shard builds the whole ghost-padded cell plane (``ncell``^3 cells of
    side >= r_cut, ``ncell`` a multiple of D: :func:`sharded_p3m_geometry`)
    and runs K6 (:func:`~nbody_torch.forces.p3m.run_cell_plane`) on its
    x-slab of it (:func:`slice_plane`).  A particle's slot lies in shard
    d's slab iff its padded x-layer is in (d nxl, d nxl + nxl]: each
    shard reads back the particles of its slab (zeros elsewhere), the
    ``psum`` counts each particle once, and each shard keeps its rows.

    The JAX function drops the particles of an over-full cell without a
    word (their slot is the plane's zero row).  ``checked=True`` returns
    (g, overflow): the cell tier's overflow word, the number of particles
    that lost their short-range force (every shard builds the same plane,
    and the shards' words are ``pmax``'d), 0 iff nothing was dropped, a
    0-d tensor on the input's device.  ``capacity`` defaults to
    :func:`~nbody_torch.mesh.cells.cell_capacity` of N and the grid.
    ``softening`` is the pair sum's ('plummer', the JAX function's, or
    'spline')."""
    D = group.size
    r_s, r_cut, ncell, nxl = sharded_p3m_geometry(box, nmesh, D, r_s, r_cut)
    M = ncell + 2
    base = 1.5 * cosmo.Omega_m * cosmo.H0**2
    G = units.COSMO.G
    eps2 = float(eps) ** 2
    if split not in ("spline", "gaussian"):
        raise ValueError(f"unknown split {split!r}")

    def local(pos, mass, a):
        dtype = pos.dtype
        pos_l, mass_l = _blocks(pos, group), _blocks(mass.to(dtype), group)
        n_loc = pos_l[0].shape[0]
        pm_of = _pm_modules(
            group, box, nmesh, deconvolve_p, grad_order, dtype,
            longrange_split=r_s if split == "gaussian" else 0.0,
            spline_split=r_cut if split == "spline" else 0.0)
        acc_long = _far_field(pos_l, mass_l, group, pm_of, base / a)

        pos_g = group.all_gather(pos_l)
        mass_g = group.all_gather(mass_l)
        n = pos_g[0].shape[0]
        cap = capacity or cell_capacity(n, ncell)
        partial, overflow = [], []
        for d in range(D):
            plane, ov, K, gidx, counts = build_padded_plane(
                pos_g[d], mass_g[d], box, r_cut, ncell, cap)
            local_plane, local_counts = slice_plane(plane, counts, d=d,
                                                    nxl=nxl, ncell=ncell, K=K)
            out = run_cell_plane(local_plane, local_counts, nx=nxl,
                                 ncell=ncell, K=K, eps2=eps2, r_s=r_s,
                                 r_cut=r_cut, split=split,
                                 softening=softening)
            layer = M * M * K
            rel = gidx - d * nxl * layer
            in_slab = (rel >= layer) & (rel < (nxl + 1) * layer)
            rel = torch.where(in_slab, rel, torch.full_like(rel,
                                                            (nxl + 2) * layer))
            buckets = torch.cat([out[:3].T, out.new_zeros((1, 3))])
            partial.append(buckets[rel])
            overflow.append(ov)
        acc_short = group.psum(partial)
        g = _whole([al + s[d * n_loc:(d + 1) * n_loc].to(dtype) * (G / a)
                    for d, (al, s) in enumerate(zip(acc_long, acc_short))],
                   pos)
        if not checked:
            return g
        return g, group.pmax(overflow)[0].to(pos.device)

    return local
