"""Slab domain decomposition: each shard owns the particles of one x-slab.

Counterpart of :mod:`nbody.distributed.domain`, fixed and adaptive
steps.
The box is cut into D x-slabs aligned with the P3M chaining-cell grid
(shard d owns cell layers [d ncell / D, (d + 1) ncell / D)).  Each shard
holds a fixed-capacity block of C particle slots; empty slots carry mass 0
and are parked at the slab centre, so they deposit nothing and never
migrate.  After every drift, :func:`slab_exchange` moves the particles
that crossed a slab boundary to the neighbouring shard.  The short-range
force builds only the shard's own slab of the ghost-padded plane, whose
two boundary layers come from the neighbours (halo exchange); the PM far
field deposits onto the shard's mesh slab (one spill plane to each
neighbour), solves Poisson through the transpose-decomposed FFT
(:mod:`nbody_torch.distributed.fft`) and reads the force back from the
slab plus one halo plane from each side.  With rungs, the interior
sub-ticks kick the active rungs only: on frozen local column plans (K5's
slab site) or on a compact plane of the active targets against the
slab's cell plane (K6's two-plane slab site).  With subcycles, the
short-range force drives several KDKs inside each global step, every
subcycle's drift migrating; on the supercell tier the last subcycle's
short force and the closing far field come from one fused evaluation
(K2 + K3).  With adaptive steps the shards choose one step together (the
least demand over them) and take the rung step of the fixed grid on the
masked cell planes.

One process drives every shard (:class:`ShardGroup`): a shard's arrays
are the entries of Python lists, on the shard's device, and each
collective is a plain function of those lists.  So four shards run on one
card with the arithmetic they would have on four.  The short-range tiers
launch the slab forms of K6 (cells), K4 (columns), and K2 + K3
(supercell) once a shard and force evaluation.
"""

from __future__ import annotations

import itertools
from typing import Callable, NamedTuple

import numpy as np
import torch

from nbody_torch.core import units
from nbody_torch.core.types import ParticleState
from nbody_torch.distributed.collectives import ShardGroup
from nbody_torch.distributed.fft import kvecs_slab, slab_irfftn, slab_rfftn
from nbody_torch.forces.p3m import run_cell_plane, supercell_ncell
from nbody_torch.forces.p3m_columns import (
    _ceil128,
    build_local_column_plane,
    column_window,
    encode_overflow,
    freeze_local_column_plan,
    ghost_slots,
    local_plan_stale,
    p3m_local_columns_frozen_masked,
    p3m_short_columns_local,
    read_back,
)
from nbody_torch.forces.pm import _spline_filter_radial
from nbody_torch.forces.pm_supercell import (
    extract_local_subgrids,
    run_fused_column_plane,
    supercell_deposit_local,
    supercell_geometry,
)
from nbody_torch.mesh.cells import cell_capacity
from nbody_torch.mesh.cic import scatter_sum


# ---------------------------------------------------------------------------
# Decomposition
# ---------------------------------------------------------------------------


def slab_counts(pos, box: float, ncell: int, n_dev: int) -> np.ndarray:
    """Particles per x-slab (slabs aligned to the chaining-cell grid)."""
    x = np.mod(np.asarray(torch.as_tensor(pos).cpu())[:, 0], box)
    cx = np.clip((x * (ncell / box)).astype(np.int64), 0, ncell - 1)
    return np.bincount(cx // (ncell // n_dev), minlength=n_dev)


def _slab_of(x, box: float, ncell: int, nxl: int):
    """Each particle's slab from its x, in x's dtype: the rule that
    :func:`slab_exchange` applies after every drift."""
    x = torch.remainder(x, box)
    return torch.clamp((x * (ncell / box)).to(torch.int32), 0,
                       ncell - 1) // nxl


def domain_decompose(state: ParticleState, group: ShardGroup, box: float,
                     ncell: int, local_capacity: int | None = None,
                     headroom: float = 1.3) -> list:
    """Scatter a state into slab-resident shards: a list of D
    :class:`ParticleState` of C rows each, shard d on its device.  Rows
    with mass 0 are empty slots parked at the slab's centre.  C
    (``local_capacity``) defaults to ``headroom`` x the fullest slab + 8,
    rounded up to a multiple of 8.  The slab of each particle is taken in
    the state's dtype by the exchange's rule (the JAX package takes it in
    float64: for a float32 x within an ulp of a slab cut the two differ,
    and the float32 planes of the first evaluation would leave the
    particle out)."""
    D = group.size
    if ncell % D:
        raise ValueError(f"ncell={ncell} not divisible by {D} devices")
    nxl = ncell // D
    dtype = state.pos.dtype
    slab = _slab_of(state.pos[:, 0].detach().cpu(), box, ncell,
                    nxl).numpy()
    pos = state.pos.detach().cpu().to(torch.float64).numpy()
    vel = state.vel.detach().cpu().to(torch.float64).numpy()
    mass = state.mass.detach().cpu().to(torch.float64).numpy()
    counts = np.bincount(slab, minlength=D)
    C = local_capacity or -(-int(headroom * counts.max() + 8) // 8) * 8
    if counts.max() > C:
        raise ValueError(
            f"local_capacity={C} < max slab occupancy {counts.max()}")
    W = box / D
    shards = []
    for d in range(D):
        sel = slab == d
        nd = int(counts[d])
        pos_b = np.zeros((C, 3))
        vel_b = np.zeros((C, 3))
        mass_b = np.zeros(C)
        pos_b[:nd] = pos[sel]
        vel_b[:nd] = vel[sel]
        mass_b[:nd] = mass[sel]
        pos_b[nd:] = [(d + 0.5) * W, 0.5 * box, 0.5 * box]
        shards.append(ParticleState.create(
            pos_b, vel_b, mass_b, float(state.time), device=group.devices[d],
            dtype=dtype))
    return shards


def domain_gather(shards: list, device=None) -> ParticleState:
    """The dense state of a slab-resident one (empty slots dropped, shards
    in order), on ``device`` (default: shard 0's)."""
    device = shards[0].pos.device if device is None else device
    keep = [s.mass > 0 for s in shards]

    def cat(field):
        return torch.cat([getattr(s, field)[k].to(device)
                          for s, k in zip(shards, keep)])

    return ParticleState(pos=cat("pos"), vel=cat("vel"), mass=cat("mass"),
                         time=shards[0].time.to(device))


# ---------------------------------------------------------------------------
# Particle exchange and the local cell plane
# ---------------------------------------------------------------------------


def _flagged_first(flag):
    """Stable order with the flagged rows first (``argsort(~flag)``)."""
    return torch.argsort((~flag).to(torch.int8), stable=True)


def slab_exchange(pos: list, vel: list, mass: list, *, box: float,
                  ncell: int, group: ShardGroup, exchange_capacity: int,
                  extras: tuple = ()):
    """Move the particles that crossed a slab boundary to the neighbouring
    shard: up to ``exchange_capacity`` (E) each way per shard and call (a
    particle crosses at most one slab a step; more is counted in the
    overflow).  With two shards both neighbours are one shard, so every
    migrant takes the forward hop (two hops would deliver it twice).
    Rows are kept in the JAX package's order: staying rows, then those
    from the left, then those from the right, compacted stably; empty
    slots are re-parked at the slab centre.

    Returns (pos, vel, mass, overflow) lists, or (pos, vel, mass,
    extras_out, overflow) when ``extras`` (a tuple of per-particle lists,
    e.g. a carried force) ride along; a shard's overflow counts the
    migrants beyond E each way, the rows beyond its capacity and those
    that would cross more than one slab."""
    D = group.size
    E = exchange_capacity
    nxl = ncell // D
    packs_r, packs_l, local = [], [], []
    for d in range(D):
        p, v, m = pos[d], vel[d], mass[d]
        ex = tuple(e[d] for e in extras)
        valid = m > 0
        dest = _slab_of(p[:, 0], box, ncell, nxl)
        none = torch.zeros_like(valid)
        go_r = valid & (dest == (d + 1) % D) if D > 1 else none
        # two shards: forward only, or every migrant would arrive twice
        go_l = valid & (dest == (d - 1) % D) if D > 2 else none
        far = valid & (dest != d) & ~go_r & ~go_l if D > 2 else none
        stay = valid & ~go_r & ~go_l & ~far

        def pack(flag):
            sel = _flagged_first(flag)[:E]
            cnt = torch.sum(flag)
            slot = torch.arange(sel.numel(), device=p.device) < cnt
            mm = torch.where(slot, m[sel], torch.zeros_like(m[sel]))
            return ((p[sel], v[sel], mm) + tuple(e[sel] for e in ex),
                    torch.clamp_min(cnt - E, 0))

        pr, ov_r = pack(go_r)
        pl, ov_l = pack(go_l)
        packs_r.append(pr)
        packs_l.append(pl)
        local.append((p, v, torch.where(stay, m, torch.zeros_like(m)), ex,
                      ov_r + ov_l + torch.sum(far)))
    n_fields = 3 + len(extras)
    from_left = [group.ppermute([pk[f] for pk in packs_r], +1)
                 for f in range(n_fields)]
    from_right = [group.ppermute([pk[f] for pk in packs_l], -1)
                  for f in range(n_fields)]
    out_p, out_v, out_m, out_ov = [], [], [], []
    out_ex = [[] for _ in extras]
    for d in range(D):
        p, v, m_stay, ex, ov = local[d]
        C = p.shape[0]
        own = (p, v, m_stay) + ex
        cand = [torch.cat([own[f], from_left[f][d], from_right[f][d]])
                for f in range(n_fields)]
        cand_valid = cand[2] > 0
        order = _flagged_first(cand_valid)[:C]
        new = [c[order] for c in cand]
        ov_cap = torch.clamp_min(torch.sum(cand_valid) - C, 0)
        dtype = p.dtype
        park = torch.stack([
            (torch.tensor(d, dtype=dtype, device=p.device) + 0.5)
            * (box / D),
            torch.tensor(0.5 * box, dtype=dtype, device=p.device),
            torch.tensor(0.5 * box, dtype=dtype, device=p.device)])
        ok = new[2] > 0
        out_p.append(torch.where(ok[:, None], new[0], park[None, :]))
        out_v.append(torch.where(ok[:, None], new[1],
                                 torch.zeros_like(new[1])))
        out_m.append(new[2])
        for t in range(len(extras)):
            out_ex[t].append(new[3 + t])
        out_ov.append((ov + ov_cap).to(torch.int32))
    if extras:
        return out_p, out_v, out_m, tuple(out_ex), out_ov
    return out_p, out_v, out_m, out_ov


def build_local_plane(pos: list, mass: list, *, box: float, r_cut: float,
                      ncell: int, group: ShardGroup, capacity: int,
                      valid: list | None = None):
    """Every shard's slab of the ghost-padded cell plane (cf.
    :func:`nbody_torch.forces.p3m.build_padded_plane`): its particles
    bucketed into the nxl = ncell / D cell layers it owns, y and z ghosts
    the periodic wrap of its own data, and the two x ghost layers its
    neighbours' boundary layers (a ppermute each way; x shifted by -box /
    +box where the ring wraps).  ``valid`` restricts which rows enter.

    Returns one tuple a shard: (plane (8, (nxl + 2) M^2 K) float32,
    overflow (valid rows not stored: bucket spills, and rows outside the
    slab), K, gidx (C,) each row's interior slot or the sentinel
    (nxl + 2) M^2 K, counts ((nxl + 2) M^2,) int32 each padded cell's
    stored particles, where K6 stops).  The first four are the JAX
    package's."""
    D = group.size
    nxl = ncell // D
    M = ncell + 2
    K = _ceil128(capacity)
    C3l = nxl * ncell * ncell
    f32 = torch.float32
    layers, cnt_layers, meta = [], [], []
    for d in range(D):
        p, m = pos[d], mass[d]
        dev = p.device
        C = p.shape[0]
        ok_rows = (m > 0) if valid is None else (valid[d] & (m > 0))
        s = torch.remainder(p, box) * (ncell / box)
        c = torch.clamp(s.to(torch.int32), 0, ncell - 1).to(torch.int64)
        cxl = c[:, 0] - d * nxl
        resident = ok_rows & (cxl >= 0) & (cxl < nxl)
        cid = torch.where(resident, (cxl * ncell + c[:, 1]) * ncell + c[:, 2],
                          torch.full_like(cxl, C3l))
        order = torch.argsort(cid, stable=True)
        cid_s = cid[order]
        counts = torch.bincount(cid, minlength=C3l + 1)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(C, device=dev) - starts[cid_s]
        ok = (rank < K) & (cid_s < C3l)
        overflow = torch.sum(ok_rows) - torch.sum(ok)
        sxl = cid_s // (ncell * ncell)
        sy = (cid_s // ncell) % ncell
        sz = cid_s % ncell
        pad_slot = ((((sxl + 1) * M) + sy + 1) * M + sz + 1) * K + rank
        sentinel = (nxl + 2) * M * M * K
        gidx = torch.full((C,), sentinel, dtype=torch.int64, device=dev)
        gidx[order] = torch.where(ok, pad_slot,
                                  torch.full_like(pad_slot, sentinel))
        slot_l = torch.full((C,), C3l * K, dtype=torch.int64, device=dev)
        slot_l[order] = torch.where(ok, cid_s * K + rank,
                                    torch.full_like(rank, C3l * K))
        data = torch.cat([torch.remainder(p, box).to(f32),
                          m.to(f32)[:, None]], dim=1)
        interior = torch.tensor([-4.0 * r_cut] * 3 + [0.0], dtype=f32,
                                device=dev).repeat(C3l * K + 1, 1)
        interior[slot_l] = data
        interior = interior[:C3l * K].reshape(nxl, ncell, ncell, K, 4)
        wrap = (torch.arange(M, device=dev) - 1) % ncell
        padded = interior[:, wrap][:, :, wrap].clone()
        zero = torch.zeros((), dtype=f32, device=dev)
        for ax in (1, 2):
            for edge, delta in ((0, -box), (M - 1, box)):
                sl = padded[(slice(None),) * ax + (edge,)]
                sl[..., ax] += torch.where(sl[..., 3] > 0, zero + delta,
                                               zero)
        soa = torch.cat([padded.permute(4, 0, 1, 2, 3),
                         torch.zeros((4, nxl, M, M, K), dtype=f32,
                                     device=dev)]).reshape(8, nxl, M * M * K)
        zero_layer = torch.zeros((8, 1, M * M * K), dtype=f32, device=dev)
        layers.append(torch.cat([zero_layer, soa, zero_layer], dim=1))
        stored = torch.clamp_max(counts[:C3l], K).reshape(nxl, ncell, ncell)
        cnt = torch.zeros((nxl + 2, M, M), dtype=torch.int64, device=dev)
        cnt[1:nxl + 1] = stored[:, wrap][:, :, wrap]
        cnt_layers.append(cnt)
        meta.append((overflow, gidx))
    from_left = group.ppermute([p5[:, nxl] for p5 in layers], +1)
    from_right = group.ppermute([p5[:, 1] for p5 in layers], -1)
    cnt_left = group.ppermute([c[nxl] for c in cnt_layers], +1)
    cnt_right = group.ppermute([c[1] for c in cnt_layers], -1)
    out = []
    for d in range(D):
        p5 = layers[d]
        left = from_left[d].clone()
        right = from_right[d].clone()
        if d == 0:
            left[0] -= box
        if d == D - 1:
            right[0] += box
        p5[:, 0] = left
        p5[:, nxl + 1] = right
        cnt = cnt_layers[d]
        cnt[0] = cnt_left[d]
        cnt[nxl + 1] = cnt_right[d]
        overflow, gidx = meta[d]
        out.append((p5.reshape(8, (nxl + 2) * M * M * K), overflow, K, gidx,
                    cnt.reshape(-1).to(torch.int32).contiguous()))
    return out


# ---------------------------------------------------------------------------
# Slab mesh operations
# ---------------------------------------------------------------------------


def slab_deposit(pos: list, mass: list, *, box: float, nmesh: int,
                 group: ShardGroup, shift: float = 0.0) -> list:
    """CIC deposit of each shard's particles onto its (nmesh / D, nmesh,
    nmesh) mesh slab; the planes a particle's cloud reaches in a
    neighbouring slab travel there by one ppermute each way.  ``shift``
    (cells) offsets the grid origin (the second interlacing pass)."""
    D = group.size
    Xl = nmesh // D
    bufs = []
    for d in range(D):
        p, m = pos[d], mass[d]
        s = torch.remainder(p, box) * (nmesh / box) - shift
        i0f = torch.floor(s)
        f = s - i0f
        i0 = i0f.to(torch.int64)
        # planes 1..Xl are the slab's own, 0 and Xl + 1 the spills
        il = torch.clamp(i0[:, 0] - d * Xl + 1, 0, Xl + 1)
        lins, ws = [], []
        for dx, dy, dz in itertools.product((0, 1), repeat=3):
            ws.append((f[:, 0] if dx else 1.0 - f[:, 0])
                      * (f[:, 1] if dy else 1.0 - f[:, 1])
                      * (f[:, 2] if dz else 1.0 - f[:, 2]) * m)
            ix = torch.clamp(il + dx, 0, Xl + 1)
            iy = torch.remainder(i0[:, 1] + dy, nmesh)
            iz = torch.remainder(i0[:, 2] + dz, nmesh)
            lins.append((ix * nmesh + iy) * nmesh + iz)
        flat = scatter_sum((Xl + 2) * nmesh * nmesh, torch.cat(lins),
                           torch.cat(ws))
        bufs.append(flat.reshape(Xl + 2, nmesh, nmesh))
    spill_r = group.ppermute([b[Xl + 1] for b in bufs], +1)
    spill_l = group.ppermute([b[0] for b in bufs], -1)
    out = []
    for b, sr, sl in zip(bufs, spill_r, spill_l):
        g = b[1:Xl + 1].clone()
        g[0] += sr
        g[Xl - 1] += sl
        out.append(g)
    return out


def _bspline_weight(order: int):
    if order == 3:
        def W(u):
            au = torch.abs(u)
            return torch.where(au <= 0.5, 0.75 - u * u,
                               torch.where(au < 1.5, 0.5 * (1.5 - au) ** 2,
                                           torch.zeros_like(u)))
        return W, (-1, 0, 1)
    if order == 4:
        def W(u):
            au = torch.abs(u)
            return torch.where(
                au <= 1.0, (4.0 - 6.0 * au * au + 3.0 * au**3) / 6.0,
                torch.where(au < 2.0, (2.0 - au) ** 3 / 6.0,
                            torch.zeros_like(u)))
        return W, (-1, 0, 1, 2)
    raise ValueError(f"unsupported assignment order {order}")


def slab_bspline_deposit(pos: list, mass: list, *, box: float, nmesh: int,
                         group: ShardGroup, order: int = 2,
                         shift: float = 0.0) -> list:
    """Order-generalised :func:`slab_deposit`: 2 = CIC (delegates), 3 =
    TSC, 4 = PCS.  The wider stencils spill up to two planes into each
    neighbouring slab (needs nmesh / D >= 2)."""
    if order == 2:
        return slab_deposit(pos, mass, box=box, nmesh=nmesh, group=group,
                            shift=shift)
    D = group.size
    Xl = nmesh // D
    if Xl < 2:
        raise ValueError(f"order-{order} slab deposit needs nmesh/n_dev >= 2")
    W, offsets = _bspline_weight(order)
    bufs = []
    for d in range(D):
        p, m = pos[d], mass[d]
        s = torch.remainder(p, box) * (nmesh / box) - shift
        ic = torch.floor(s + 0.5 if order == 3 else s).to(torch.int64)
        il = torch.clamp(ic[:, 0] - d * Xl + 2, 0, Xl + 3)
        wx = {o: W(s[:, 0] - (ic[:, 0] + o)) * m for o in offsets}
        wy = {o: W(s[:, 1] - (ic[:, 1] + o)) for o in offsets}
        wz = {o: W(s[:, 2] - (ic[:, 2] + o)) for o in offsets}
        lins, ws = [], []
        for ox, oy, oz in itertools.product(offsets, repeat=3):
            ix = torch.clamp(il + ox, 0, Xl + 3)
            iy = torch.remainder(ic[:, 1] + oy, nmesh)
            iz = torch.remainder(ic[:, 2] + oz, nmesh)
            lins.append((ix * nmesh + iy) * nmesh + iz)
            ws.append(wx[ox] * wy[oy] * wz[oz])
        flat = scatter_sum((Xl + 4) * nmesh * nmesh, torch.cat(lins),
                           torch.cat(ws))
        bufs.append(flat.reshape(Xl + 4, nmesh, nmesh))
    spill_r = group.ppermute([b[Xl + 2: Xl + 4] for b in bufs], +1)
    spill_l = group.ppermute([b[0:2] for b in bufs], -1)
    out = []
    for b, sr, sl in zip(bufs, spill_r, spill_l):
        g = b[2:Xl + 2].clone()
        g[0:2] += sr
        g[Xl - 2:Xl] += sl
        out.append(g)
    return out


def slab_gather3(grids: list, pos: list, *, box: float, group: ShardGroup,
                 shift: float = 0.0) -> list:
    """Trilinear read of each shard's (C, nmesh / D, nmesh, nmesh) grid
    slab at its particles, with one halo plane from each neighbour
    (``shift``: the half-cell-offset grid of the second interlacing
    pass).  Returns (n, C) per shard."""
    D = group.size
    Xl = grids[0].shape[1]
    nmesh = grids[0].shape[2]
    halo_r = group.ppermute([g[:, 0] for g in grids], -1)
    halo_l = group.ppermute([g[:, Xl - 1] for g in grids], +1)
    out = []
    for d in range(D):
        g, p = grids[d], pos[d]
        nc = g.shape[0]
        ext = torch.cat([halo_l[d][:, None], g, halo_r[d][:, None]], dim=1)
        flat = ext.reshape(nc, -1).T
        s = torch.remainder(p, box) * (nmesh / box) - shift
        i0f = torch.floor(s)
        f = s - i0f
        i0 = i0f.to(torch.int64)
        il = torch.clamp(i0[:, 0] - d * Xl + 1, 0, Xl)
        acc = torch.zeros((p.shape[0], nc), dtype=g.dtype, device=p.device)
        for dx, dy, dz in itertools.product((0, 1), repeat=3):
            w = ((f[:, 0] if dx else 1.0 - f[:, 0])
                 * (f[:, 1] if dy else 1.0 - f[:, 1])
                 * (f[:, 2] if dz else 1.0 - f[:, 2]))
            ix = il + dx
            iy = torch.remainder(i0[:, 1] + dy, nmesh)
            iz = torch.remainder(i0[:, 2] + dz, nmesh)
            acc = acc + w[:, None] * flat[(ix * nmesh + iy) * nmesh + iz]
        out.append(acc)
    return out


def _grad1(k, h: float, order: str):
    if order == "fd2":
        return torch.sin(k * h) / h
    if order == "fd4":
        return (8.0 * torch.sin(k * h) - torch.sin(2.0 * k * h)) / (6.0 * h)
    raise ValueError(f"domain PM supports fd2/fd4 gradients, not {order!r}")


# ---------------------------------------------------------------------------
# The domain-decomposed P3M force
# ---------------------------------------------------------------------------


class DomainP3M(NamedTuple):
    """Static geometry of a domain-decomposed P3M force."""

    box: float
    nmesh: int
    ncell: int
    r_s: float
    r_cut: float
    bucket_capacity: int
    n_dev: int


def domain_p3m_geometry(box: float, nmesh: int, n_dev: int, n_global: int,
                        r_s: float | None = None, r_cut: float | None = None,
                        bucket_capacity: int | None = None) -> DomainP3M:
    """The slab geometry: the P3M split scales and a chaining-cell grid
    whose x-layers divide evenly over the shards."""
    cell = box / nmesh
    if r_s is None:
        r_s = 1.25 * cell
    if r_cut is None:
        r_cut = 4.5 * r_s
    ncell = int(box / float(r_cut))
    ncell -= ncell % n_dev
    if ncell < max(3, n_dev):
        raise ValueError(
            f"box/r_cut={box / r_cut:.1f} cannot host {n_dev} x-slabs")
    if nmesh % n_dev:
        raise ValueError(f"nmesh={nmesh} not divisible by {n_dev} devices")
    cap = bucket_capacity or cell_capacity(n_global, ncell)
    return DomainP3M(box=box, nmesh=nmesh, ncell=ncell, r_s=float(r_s),
                     r_cut=float(r_cut), bucket_capacity=cap, n_dev=n_dev)


def slab_grid(geom: DomainP3M, shortrange: str) -> int:
    """The chaining grid whose x-layers decide which shard owns a
    particle (:func:`domain_decompose`, :func:`slab_exchange`): the
    supercell tier's own grid, else the geometry's.  A shard's column
    plane holds only the particles of its own x-rows, so its grid must be
    the one that placed them: two grids (16 and 20 at cfg64) cut the box
    at the same planes, but in float32 a particle within an ulp or two of
    a cut lands on different sides of it, and the plane would drop it
    (no force and no mass that step) without counting it anywhere."""
    if shortrange == "supercell":
        return supercell_ncell(geom.box, geom.nmesh, geom.r_cut)
    return geom.ncell


def _pmax_word(ovs: list, group: ShardGroup):
    """The largest of the shards' overflow words (pmax: the column tiers'
    word is field-encoded, and a sum could carry the window field into
    the bucket field)."""
    return group.pmax([torch.as_tensor(o).to(torch.int64) for o in ovs])[0]


def make_domain_p3m_local(cosmo, geom: DomainP3M, eps: float, *,
                          group: ShardGroup, deconvolve_p: int = 2,
                          split: str = "spline", softening: str = "plummer",
                          grad_order: str = "fd4", interlace: bool = False,
                          part: str = "both", shortrange: str = "cells",
                          col_capacity: int | None = None,
                          col_window: int | None = None,
                          target_capacity: int = 128) -> Callable:
    """The force on every shard: acc(pos, mass, a) -> (g, overflow), g and
    overflow lists of the shards' canonical-momentum forces -grad(phi)/a
    and overflow words (not yet reduced over the shards).

    ``split="none"`` is the pure domain PM (slab deposit, distributed FFT,
    slab gather; overflow 0).  ``interlace`` adds CONCEPT's half-cell
    shifted second deposit and force pass.  ``part``: "both" (default),
    "long" (the far field alone, returns g), "short" (the short-range
    force alone, returns (g, overflow)), or "split" (the supercell tier's
    fused evaluation: acc(pos, mass, a_s, a_l) -> (g_short, g_long,
    overflow)) or "short_masked" (the rung tier's interior ticks:
    acc(pos, mass, act, a) -> (g, ov_source, ov_target, occupancy_target)
    lists, the short-range force ON the ``act`` rows FROM all by K6's
    two-plane form, a plane of the active rows at ``target_capacity``
    against the slab's cell plane; ``occupancy_target`` is the densest
    active resident cell, the driver's pre-warm signal; it rides the cell
    geometry whatever ``shortrange``).  ``shortrange``: "cells" (K6 on the
    slab's cell plane), "columns" (K4 on its column plane) or "supercell"
    (one column plane for K2's deposit and K3's fused readback + pair
    sum); the column tiers need ``col_capacity`` and give the
    field-encoded word bucket * 65536 + window misses."""
    box, nmesh, ncell = geom.box, geom.nmesh, geom.ncell
    D = group.size
    if D != geom.n_dev:
        raise ValueError(f"geometry for {geom.n_dev} shards, group of {D}")
    nxl = ncell // D
    base = 1.5 * cosmo.Omega_m * cosmo.H0**2
    G = units.COSMO.G
    eps2 = float(eps) ** 2
    h_cell = box / nmesh
    if part not in ("both", "long", "short", "split", "short_masked"):
        raise ValueError(f"unknown part {part!r}")
    if part in ("short", "short_masked") and split == "none":
        raise ValueError(f"part={part!r} is meaningless with split='none'")
    if part == "split" and shortrange != "supercell":
        raise ValueError("part='split' is the fused supercell path")
    if shortrange not in ("cells", "columns", "supercell"):
        raise ValueError(f"unknown domain shortrange {shortrange!r}")
    if shortrange in ("columns", "supercell") and not col_capacity:
        raise ValueError(
            f"shortrange={shortrange!r} needs an explicit col_capacity "
            "(compute it via nbody_torch.forces.p3m_columns.column_params)")
    sc_ncell = None
    if shortrange == "supercell":
        sc_ncell = supercell_ncell(box, nmesh, geom.r_cut)
        if sc_ncell is None or sc_ncell % D:
            raise ValueError(
                f"domain supercell needs a divisor chaining grid that also "
                f"splits over {D} devices (got sc_ncell={sc_ncell}) — use "
                f"shortrange='columns'")
    if split == "spline":
        k_max = float(3.0**0.5 * np.pi * nmesh / box) * 1.0001
        ks_tab, F_tab = _spline_filter_radial(geom.r_cut, k_max)

    kspace = {}

    def kctx(d: int, dtype, device):
        """Shard d's k-space multipliers in the transposed layout (built
        once a shard, dtype and device)."""
        key = (d, dtype, str(device))
        if key not in kspace:
            kx, ky, kz = kvecs_slab(nmesh, box, d, D, dtype, device)
            k2 = kx**2 + ky**2 + kz**2
            if split == "spline":
                km = torch.sqrt(k2).cpu().numpy()
                F = torch.as_tensor(np.interp(km, ks_tab, F_tab), dtype=dtype,
                                    device=device)
            else:
                F = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                                torch.zeros_like(k2))
                if split == "gaussian":
                    F = F * torch.exp(-k2 * geom.r_s**2)
            ctx = dict(F=F, grad=[_grad1(k, h_cell, grad_order)
                                  for k in (kx, ky, kz)])
            if deconvolve_p:
                def sinc(k):
                    return torch.sinc(k * (h_cell / (2.0 * np.pi)))
                W = (sinc(kx) * sinc(ky) * sinc(kz)) ** deconvolve_p
                ctx["W"] = torch.clamp_min(W, 1e-8)
            if interlace:
                arg = (kx + ky + kz) * (h_cell / 2.0)
                ctx["ph_dep"] = torch.exp(-1j * arg)
                ctx["ph_read"] = torch.exp(1j * arg)
            kspace[key] = ctx
        return kspace[key]

    def ctxs(ref: list):
        return [kctx(d, t.dtype, t.device) for d, t in enumerate(ref)]

    def delta_k_of(rhos: list, rhos1, mass: list):
        """The deconvolved density contrast in k of the shards' mass
        slabs (``rhos1``: the half-cell-shifted deposit, or None)."""
        total = group.psum([torch.sum(m) for m in mass])
        cx = ctxs(rhos)
        dk = slab_rfftn(rhos, group)
        if rhos1 is not None:
            dk1 = slab_rfftn(rhos1, group)
            dk = [0.5 * (a + b * c["ph_dep"]) for a, b, c in zip(dk, dk1, cx)]
        dk = [x / (t / nmesh**3) for x, t in zip(dk, total)]
        if deconvolve_p:
            dk = [x / c["W"] for x, c in zip(dk, cx)]
        return dk, cx

    def solve_grids(delta_k: list, cx: list, a: float, phase=None):
        """The (3, nmesh / D, nmesh, nmesh) force grid slabs of the
        potential ``-base/a delta_k F`` (times the read phase of the
        shifted pass when ``phase``)."""
        phi = [-(base / a) * x * c["F"] for x, c in zip(delta_k, cx)]
        if phase:
            phi = [x * c["ph_read"] for x, c in zip(phi, cx)]
        comps = [slab_irfftn([-1j * c["grad"][j] * x
                              for x, c in zip(phi, cx)], nmesh, group)
                 for j in range(3)]
        return [torch.stack([comps[j][d] for j in range(3)])
                for d in range(D)]

    def far_field(pos: list, mass: list, a: float) -> list:
        rhos = slab_deposit(pos, mass, box=box, nmesh=nmesh, group=group)
        rhos1 = (slab_deposit(pos, mass, box=box, nmesh=nmesh, group=group,
                              shift=0.5) if interlace else None)
        dk, cx = delta_k_of(rhos, rhos1, mass)
        acc = slab_gather3(solve_grids(dk, cx, a), pos, box=box, group=group)
        if interlace:
            # the second force pass: the alias-cancelled potential read
            # back from the half-cell-shifted grid too, averaged
            acc1 = slab_gather3(solve_grids(dk, cx, a, phase=True), pos,
                                box=box, group=group, shift=0.5)
            acc = [0.5 * (x + y) for x, y in zip(acc, acc1)]
        return acc

    def supercell_eval(pos: list, mass: list, a_s: float, a_l: float):
        """One local column sort a shard, K2 on it, the distributed FFT
        solve and K3 (PM readback fused with the pair sum, split_out):
        (g_short, g_long, overflow) lists."""
        S, _ = supercell_geometry(nmesh, sc_ncell)
        CK = _ceil128(col_capacity)
        gzs = ghost_slots(CK, (geom.r_cut / box) * CK)
        chunk = 256 if CK % 256 == 0 else 128
        stride = CK + 2 * gzs
        W = min(_ceil128(col_window or column_window(box, geom.r_cut, CK)),
                stride)
        maxch = CK // chunk
        built = build_local_column_plane(
            pos, mass, box=box, r_cut=geom.r_cut, ncell=sc_ncell,
            group=group, col_capacity=CK, window=W, chunk=chunk)
        # the planes keep box coordinates: K2 and K3 take each slab's
        # first x-row and round every CIC weight as on one device
        planes = [b[0] for b in built]
        counts = [b[6] for b in built]
        dkw = dict(box=box, nmesh=nmesh, ncell=sc_ncell, group=group,
                   stride=stride, gz=gzs, chunk=chunk)
        rhos = [r.to(p.dtype) for r, p in zip(
            supercell_deposit_local(planes, counts, **dkw), pos)]
        rhos1 = ([r.to(p.dtype) for r, p in zip(
            supercell_deposit_local(planes, counts, shift=0.5, **dkw), pos)]
            if interlace else None)
        dk, cx = delta_k_of(rhos, rhos1, mass)
        grids = solve_grids(dk, cx, a_l)
        if interlace:
            grids = [torch.cat([g, g1]) for g, g1 in
                     zip(grids, solve_grids(dk, cx, a_l, phase=True))]
        halo = extract_local_subgrids(
            [g.to(torch.float32) for g in grids], group)
        gs, gl, ovs = [], [], []
        for d, (b, plane) in enumerate(zip(built, planes)):
            out = run_fused_column_plane(
                plane, b[1], b[2], halo[d], ncell=sc_ncell, stride=stride,
                W=W, maxch=maxch, gz=gzs, chunk=chunk, eps=float(eps),
                r_s=geom.r_s, r_cut=geom.r_cut, split=split,
                softening=softening, S=S, scale=float(nmesh / box),
                split_out=True, interlaced=interlace, nx=sc_ncell // D,
                row0=d * (sc_ncell // D))
            both = read_back(out, b[5], 6).to(pos[d].dtype)
            gs.append((G / a_s) * both[:, 0:3])
            gl.append(both[:, 3:6])
            ovs.append(encode_overflow(b[3], b[4]))
        return gs, gl, ovs

    def short_range(pos: list, mass: list, a: float):
        if shortrange in ("columns", "supercell"):
            # the supercell tier's short-range half rides its own chaining
            # grid, so the capacity knobs stay one
            acc, ovs = p3m_short_columns_local(
                pos, mass, box=box, eps=float(eps), r_s=geom.r_s,
                r_cut=geom.r_cut, G=G, ncell=sc_ncell or ncell, group=group,
                col_capacity=col_capacity,
                window=col_window or column_window(box, geom.r_cut,
                                                   col_capacity),
                split=split, softening=softening)
            return [x / a for x in acc], ovs
        accs, ovs = [], []
        for p, (plane, ov, K, gidx, counts) in zip(pos, build_local_plane(
                pos, mass, box=box, r_cut=geom.r_cut, ncell=ncell,
                group=group, capacity=geom.bucket_capacity)):
            out = run_cell_plane(plane, counts, nx=nxl, ncell=ncell, K=K,
                                 eps2=eps2, r_s=geom.r_s, r_cut=geom.r_cut,
                                 split=split, softening=softening)
            accs.append(read_back(out, gidx, 3).to(p.dtype) * (G / a))
            ovs.append(ov)
        return accs, ovs

    def short_range_masked(pos: list, mass: list, act: list, a: float):
        src = build_local_plane(pos, mass, box=box, r_cut=geom.r_cut,
                                ncell=ncell, group=group,
                                capacity=geom.bucket_capacity)
        tgt = build_local_plane(pos, mass, box=box, r_cut=geom.r_cut,
                                ncell=ncell, group=group,
                                capacity=target_capacity, valid=act)
        C3l = nxl * ncell * ncell
        accs, ovs_j, ovs_i, occs = [], [], [], []
        for d, (p, m, ac, (plane_j, ov_j, K_j, _, counts_j),
                (plane_i, ov_i, K_i, gidx, counts_i)) in enumerate(
                    zip(pos, mass, act, src, tgt)):
            # the densest active resident cell of the slab
            c = torch.clamp((torch.remainder(p, box) * (ncell / box)).to(
                torch.int32), 0, ncell - 1).to(torch.int64)
            cxl = c[:, 0] - d * nxl
            res = ac & (m > 0) & (cxl >= 0) & (cxl < nxl)
            cid = torch.where(res, (cxl * ncell + c[:, 1]) * ncell + c[:, 2],
                              torch.full_like(cxl, C3l))
            occs.append(torch.bincount(cid, minlength=C3l + 1)[:C3l].max())
            out = run_cell_plane(plane_i, counts_i, nx=nxl, ncell=ncell,
                                 K=K_i, eps2=eps2, r_s=geom.r_s,
                                 r_cut=geom.r_cut, split=split,
                                 softening=softening, plane_j=plane_j,
                                 K_j=K_j, counts_j=counts_j)
            accs.append(read_back(out, gidx, 3).to(p.dtype) * (G / a))
            ovs_j.append(ov_j)
            ovs_i.append(ov_i)
        return accs, ovs_j, ovs_i, occs

    if part == "long":
        return far_field
    if part == "short":
        return short_range
    if part == "short_masked":
        return short_range_masked
    if part == "split":
        return supercell_eval
    if shortrange == "supercell":
        def local_sc(pos, mass, a):
            gs, gl, ovs = supercell_eval(pos, mass, a, a)
            return [x + y for x, y in zip(gl, gs)], ovs
        return local_sc

    def local(pos, mass, a):
        acc_long = far_field(pos, mass, a)
        if split == "none":
            return acc_long, [0] * D
        acc_short, ovs = short_range(pos, mass, a)
        return [x + y for x, y in zip(acc_long, acc_short)], ovs

    return local


def make_domain_p3m_force(cosmo, box: float, nmesh: int, group: ShardGroup,
                          eps: float, n_global: int, **kwargs):
    """(acc_fn, geom): acc_fn(pos, mass, a) -> (g list, overflow) on
    slab-resident shards (see :func:`domain_decompose`), the overflow the
    largest of the shards' words (a 0-d tensor)."""
    geom = domain_p3m_geometry(
        box, nmesh, group.size, n_global, r_s=kwargs.pop("r_s", None),
        r_cut=kwargs.pop("r_cut", None),
        bucket_capacity=kwargs.pop("bucket_capacity", None))
    local = make_domain_p3m_local(cosmo, geom, eps, group=group, **kwargs)

    def acc_fn(pos, mass, a):
        g, ovs = local(pos, mass, a)
        return g, _pmax_word(ovs, group)

    return acc_fn, geom


# ---------------------------------------------------------------------------
# The domain-decomposed cosmological integration
# ---------------------------------------------------------------------------


class DomainRunResult(NamedTuple):
    state: list                  # the shards' ParticleStates at a_grid[-1]
    exchange_overflow: int       # sum over shards of each's max over steps
    bucket_overflow: int         # fixed steps: max over shards and steps
    #                              (field word); rungs: the sum over shards
    #                              of each's max, as the JAX package reduces
    force_evals: int             # force evaluations of this call (with
    #                              rungs: the boundary evaluations; with
    #                              subcycles: the far-field evaluations,
    #                              the fused ones among them)
    # the rung tier only (None otherwise), reduced as the JAX package
    # does: the active-target plane's spills (sum over shards), the
    # densest active cell seen (max), the per-step rung populations
    # (n_steps, n_rungs); the frozen plans' field-encoded word and their
    # staleness count (max over shards, steps and ticks: never summed,
    # the word is field-encoded; 0 on the masked route)
    target_overflow: int | None = None
    target_occupancy: int | None = None
    rung_hists: np.ndarray | None = None
    plan_overflow: int | None = None
    plan_stale: int | None = None
    # the rung tier's interior evaluations (K5 or K6 two-plane, one
    # launch a shard each) and plan freezes of this call; the subcycled
    # tier's short-range evaluations (the first one and those of every
    # subcycle not fused with the far field)
    interior_evals: int = 0
    plan_freezes: int = 0
    # the subcycled tier's fused evaluations (the supercell tier's last
    # subcycle and far field at once: K2 + K3, one launch a shard each)
    fused_evals: int = 0


def run_cosmological_domain(shards: list, cosmo, a_grid, group: ShardGroup,
                            *, box: float, nmesh: int, eps: float,
                            n_global: int,
                            exchange_capacity: int | None = None,
                            geom: DomainP3M | None = None,
                            deconvolve_p: int = 2, split: str = "spline",
                            grad_order: str = "fd4", interlace: bool = False,
                            subcycles: int = 1, softening: str = "plummer",
                            rungs: int = 0, eta_disp: float = 0.25,
                            eta_acc: float = 0.025,
                            target_capacity: int = 128,
                            shortrange: str = "cells",
                            col_capacity: int | None = None,
                            col_window: int | None = None,
                            rung_frozen: bool = False,
                            column_skin: float = 0.0) -> DomainRunResult:
    """Comoving KDK over ``a_grid`` with slab-resident shards: a force
    evaluation at the start, then per step a kick, the drift (+ periodic
    wrap), :func:`slab_exchange` and the closing kick, as a Python loop in
    place of the JAX package's scan.  ``shards`` must come from
    :func:`domain_decompose` on :func:`slab_grid`'s grid, which the
    exchange keeps.  The overflow words are reduced on
    the device (the exchange counts added over shards, the bucket word
    the max of the shards' field-encoded words) and read once, at the
    end.

    ``rungs >= 2`` integrates with per-particle rungs instead
    (:func:`_run_domain_rungs`): the interior sub-ticks kick the active
    rungs through the masked cell planes (K6's two-plane slab site, at
    ``target_capacity``) or, with ``rung_frozen``, on each step's frozen
    local column plans (K5's slab site; needs ``col_capacity`` and
    ``column_skin > 0``); the boundary ticks take the cells tier's full
    short force.

    ``subcycles > 1`` (with a force split and no rungs) runs the
    split-Hamiltonian KDK instead (:func:`_run_domain_subcycled`): the far
    field at the global step and ``subcycles`` short-range KDKs inside it,
    on the ``shortrange`` tier's short force."""
    from nbody_torch.integrate.cosmo_stepping import cosmo_kick_drift_factors

    rung_mode = int(rungs) >= 2
    if rung_mode and split == "none":
        raise ValueError(
            "rungs require a force split (split='none' is a pure PM solver "
            "with no short-range pass to subdivide)")
    D = group.size
    if geom is None:
        geom = domain_p3m_geometry(box, nmesh, D, n_global)
    C = shards[0].pos.shape[0]
    E = exchange_capacity or max(64, C // 8)
    fkw = dict(deconvolve_p=deconvolve_p, split=split, grad_order=grad_order,
               interlace=interlace, softening=softening)
    if rung_mode:
        return _run_domain_rungs(
            shards, cosmo, a_grid, group, box=box, nmesh=nmesh, eps=eps,
            geom=geom, E=E, n_rungs=int(rungs), eta_disp=eta_disp,
            eta_acc=eta_acc, target_capacity=target_capacity,
            col_capacity=col_capacity, col_window=col_window,
            rung_frozen=rung_frozen, column_skin=column_skin, fkw=fkw)
    if int(subcycles) > 1 and split != "none":
        return _run_domain_subcycled(
            shards, cosmo, a_grid, group, eps=eps, geom=geom, E=E,
            n_sub=int(subcycles), shortrange=shortrange,
            col_capacity=col_capacity, col_window=col_window, fkw=fkw)
    xgrid = slab_grid(geom, shortrange)
    local_acc = make_domain_p3m_local(
        cosmo, geom, eps, group=group, shortrange=shortrange,
        col_capacity=col_capacity, col_window=col_window, **fkw)
    a_grid = np.asarray(a_grid, dtype=np.float64)
    K1, Dr, K2, _ = cosmo_kick_drift_factors(cosmo, a_grid)
    pos = [s.pos for s in shards]
    vel = [s.vel for s in shards]
    mass = [s.mass for s in shards]

    g, ovs = local_acc(pos, mass, float(shards[0].time))
    ov_bk = _chan_max(group, _zeros(group), ovs)
    ov_ex = _zeros(group)
    for a1, k1, dr, k2 in zip(a_grid[1:], K1, Dr, K2):
        p_half = [v + x * float(k1) for v, x in zip(vel, g)]
        pos = [torch.remainder(p + ph * float(dr), box)
               for p, ph in zip(pos, p_half)]
        pos, p_half, mass, ov_e = slab_exchange(
            pos, p_half, mass, box=box, ncell=xgrid, group=group,
            exchange_capacity=E)
        g, ovs = local_acc(pos, mass, float(a1))
        vel = [ph + x * float(k2) for ph, x in zip(p_half, g)]
        ov_ex = _chan_max(group, ov_ex, ov_e)
        ov_bk = _chan_max(group, ov_bk, ovs)
    return DomainRunResult(
        state=_states(pos, vel, mass, float(a_grid[-1])),
        exchange_overflow=int(group.psum(ov_ex)[0]),
        bucket_overflow=int(group.pmax(ov_bk)[0]),
        force_evals=len(a_grid))


def _run_domain_subcycled(shards: list, cosmo, a_grid, group: ShardGroup, *,
                          eps: float, geom: DomainP3M, E: int, n_sub: int,
                          shortrange: str, col_capacity: int | None,
                          col_window: int | None,
                          fkw: dict) -> DomainRunResult:
    """The split-Hamiltonian KDK on the slab decomposition (the JAX
    package's ``run_cosmological_domain(subcycles=...)``): per global step
    a long half-kick, ``n_sub`` short-range KDKs and the closing long
    half-kick.  Every subcycle's drift migrates (:func:`slab_exchange`)
    before its short force.  The far field of the opening half-kick is
    not used again before the step's new one is evaluated, so it does
    not ride the exchanges (the JAX scan carries it through them only
    because its carry has a fixed shape).  On the supercell tier one
    fused evaluation (K2 + K3, ``part='split'``) gives the last
    subcycle's short force and the new far field; elsewhere the far
    field is evaluated after the last subcycle.  The run starts with the far field and the short force at
    the shards' positions.  The exchange counts are added over the
    shards, the short-range words reduced with their max (field-encoded
    on the column tiers)."""
    from nbody_torch.integrate.cosmo_stepping import (
        cosmo_kick_drift_factors,
        subcycle_tables,
    )

    box = geom.box
    skw = dict(shortrange=shortrange, col_capacity=col_capacity,
               col_window=col_window, **fkw)
    long_acc = make_domain_p3m_local(cosmo, geom, eps, group=group,
                                     part="long", **fkw)
    short_acc = make_domain_p3m_local(cosmo, geom, eps, group=group,
                                      part="short", **skw)
    both_acc = (make_domain_p3m_local(cosmo, geom, eps, group=group,
                                      part="split", **skw)
                if shortrange == "supercell" else None)
    xgrid = slab_grid(geom, shortrange)
    a_grid = np.asarray(a_grid, dtype=np.float64)
    KL1, _, KL2, _ = cosmo_kick_drift_factors(cosmo, a_grid)
    Ks1, Drs, Ks2, A_sub = subcycle_tables(cosmo, a_grid, n_sub)
    pos = [s.pos for s in shards]
    vel = [s.vel for s in shards]
    mass = [s.mass for s in shards]
    ekw = dict(box=box, ncell=xgrid, group=group, exchange_capacity=E)

    t0 = float(shards[0].time)
    gl = long_acc(pos, mass, t0)
    gs, ovs = short_acc(pos, mass, t0)
    ov_bk = _chan_max(group, _zeros(group), ovs)
    ov_ex = _zeros(group)
    n_long, n_short, n_fused = 1, 1, 0
    for i in range(len(a_grid) - 1):
        a1 = float(a_grid[i + 1])
        p = [v + x * float(KL1[i]) for v, x in zip(vel, gl)]
        for j in range(n_sub):
            p = [q + x * float(Ks1[i, j]) for q, x in zip(p, gs)]
            pos = [torch.remainder(x + q * float(Drs[i, j]), box)
                   for x, q in zip(pos, p)]
            a_s = float(A_sub[i, j])
            pos, p, mass, ov_e = slab_exchange(pos, p, mass, **ekw)
            if both_acc is not None and j == n_sub - 1:
                gs, gl, ovs = both_acc(pos, mass, a_s, a1)
                n_fused += 1
                n_long += 1
            else:
                gs, ovs = short_acc(pos, mass, a_s)
                n_short += 1
            ov_ex = _chan_max(group, ov_ex, ov_e)
            ov_bk = _chan_max(group, ov_bk, ovs)
            p = [q + x * float(Ks2[i, j]) for q, x in zip(p, gs)]
        if both_acc is None:
            gl = long_acc(pos, mass, a1)
            n_long += 1
        vel = [q + x * float(KL2[i]) for q, x in zip(p, gl)]
    return DomainRunResult(
        state=_states(pos, vel, mass, float(a_grid[-1])),
        exchange_overflow=int(group.psum(ov_ex)[0]),
        bucket_overflow=int(group.pmax(ov_bk)[0]),
        force_evals=n_long, interior_evals=n_short, fused_evals=n_fused)


def _zeros(group: ShardGroup) -> list:
    """A 0 overflow word on every shard's device."""
    return [torch.zeros((), dtype=torch.int64, device=dev)
            for dev in group.devices]


def _chan_max(group: ShardGroup, chan: list, new: list) -> list:
    """Each shard's channel word, the max of its word so far and its new
    one (a count or a tensor)."""
    return [torch.maximum(c, torch.as_tensor(x, device=dev).to(torch.int64))
            for c, x, dev in zip(chan, new, group.devices)]


def _states(pos: list, vel: list, mass: list, time: float) -> list:
    return [ParticleState(pos=p, vel=v, mass=m,
                          time=torch.as_tensor(time, dtype=p.dtype,
                                               device=p.device))
            for p, v, m in zip(pos, vel, mass)]


def _rung_kit(cosmo, group: ShardGroup, *, box: float, eps: float,
              geom: DomainP3M, E: int, n_rungs: int, target_capacity: int,
              col_capacity: int | None = None, col_window: int | None = None,
              rung_frozen: bool = False, column_skin: float = 0.0,
              fkw: dict) -> dict:
    """The forces, knobs, overflow channels and counts of the domain rung
    tier: what :func:`_domain_rung_step` takes and updates (the channel
    words stay on the devices; the counts are host ints)."""
    kit = dict(box=box, eps=float(eps), geom=geom, E=E, n_rungs=n_rungs,
               group=group, fkw=fkw, rung_frozen=rung_frozen,
               cosmo=(float(cosmo.H0), float(cosmo.Omega_m),
                      float(cosmo.Omega_L)),
               long_acc=make_domain_p3m_local(cosmo, geom, eps, group=group,
                                              part="long", **fkw),
               short_acc=make_domain_p3m_local(cosmo, geom, eps,
                                               group=group, part="short",
                                               **fkw))
    if rung_frozen:
        if not col_capacity:
            raise ValueError(
                "rung_frozen needs an explicit col_capacity (compute it via "
                "nbody_torch.forces.p3m_columns.column_params)")
        if column_skin <= 0.0:
            raise ValueError(
                "rung_frozen needs column_skin > 0 (the per-step drift "
                "budget the frozen plan is sized for)")
        ck = _ceil128(col_capacity)
        kit["ckw"] = dict(box=box, r_cut=geom.r_cut, ncell=geom.ncell,
                          group=group, col_capacity=ck,
                          window=int(col_window
                                     or column_window(box, geom.r_cut, ck)))
        kit["skin"] = float(column_skin)
    else:
        kit["masked_acc"] = make_domain_p3m_local(
            cosmo, geom, eps, group=group, part="short_masked",
            target_capacity=target_capacity, **fkw)
    zeros = _zeros(group)
    kit.update(ov_ex=zeros, ov_bk=zeros, ov_tg=zeros, occ_tg=zeros,
               ov_pl=zeros, ov_st=zeros, n_boundary=0, n_interior=0,
               n_freeze=0)
    return kit


def _shard_rungs(kit: dict, vel: list, mass: list, gl: list, gs: list,
                 a0: list, dla_step: list, tabs: list):
    """Each shard's rungs from the demand of its carried force at a0 (per
    shard 0-d tensors) against the step ``dla_step``, and the global
    histogram of the resident rows (parked rows binned out), summed over
    the shards on shard 0's device: (rungs, hist tensor)."""
    from nbody_torch.integrate.cosmo_stepping import (
        _assign_rungs,
        _rung_demand,
    )

    n_rungs = kit["n_rungs"]
    rung, counts = [], []
    for d in range(len(vel)):
        tb = tabs[d]
        dla = _rung_demand(vel[d], gl[d], gs[d], a0[d], tb["cell"],
                           tb["eta"], tb["acc"], *kit["cosmo"])
        dla = torch.where(mass[d] > 0, dla, torch.full_like(dla, np.inf))
        r = _assign_rungs(dla, dla_step[d], n_rungs)
        rung.append(r)
        counts.append(torch.bincount(
            torch.where(mass[d] > 0, r, torch.full_like(r, n_rungs)),
            minlength=n_rungs + 1)[:n_rungs])
    return rung, kit["group"].psum(counts)[0]


def _domain_rung_step(kit: dict, pos: list, vel: list, mass: list, gl: list,
                      gs: list, rung: list, hist, tables):
    """One rung block step on the slab-resident shards (the JAX package's
    step body around ``_rung_ticks``): the step of the fixed-grid
    :func:`_run_domain_rungs` and of
    :func:`run_cosmological_domain_adaptive`.  ``tables = (a1, kl1, kl2,
    Fk, Dr, A_sub)``, Fk a list of each shard's (n_sub + 1, n_rungs)
    kick table on its device and the rest host floats; ``hist`` is the
    step's global rung histogram on the host.

    Every sub-tick drifts every shard; the boundary tick migrates
    (:func:`slab_exchange`, with the carried forces and the rungs riding
    along) and takes the full short force of the cells tier, then the far
    field.  A tick whose lowest active rung is above the deepest
    populated rung is skipped on every shard (its kick would add 0).
    Interior ticks kick the active rungs:

    * masked route: every sub-tick migrates too, and K6's two-plane slab
      site evaluates the force on the active rows;
    * frozen route (``kit['rung_frozen']``): the step's local column plans
      are frozen at its start, after the last boundary's exchange, and
      the particles stay on their shard until the boundary; K5's slab
      site evaluates the force on the chunks with an active row, and the
      plans' staleness (drift beyond skin/2) is counted.  A step without
      an active interior tick freezes no plan.

    The channels and counts of ``kit`` are updated in place.  Returns
    (pos, vel, mass, gl, gs)."""
    from nbody_torch.integrate.cosmo_stepping import rung_active_min

    a1, kl1, kl2, Fk, Dr, A_sub = tables
    group, box, geom, n_rungs = (kit["group"], kit["box"], kit["geom"],
                                 kit["n_rungs"])
    n_sub = 2 ** (n_rungs - 1)
    deepest = max((r for r, c in enumerate(hist) if c), default=0)

    def chan_max(key, new):
        kit[key] = _chan_max(group, kit[key], new)

    plans = None
    if kit["rung_frozen"] and deepest >= 1:
        plans = freeze_local_column_plan(pos, mass, skin=kit["skin"],
                                         **kit["ckw"])
        chan_max("ov_pl", [pl.ov for pl in plans])
        kit["n_freeze"] += 1
    p = [v + x * kl1 + y * f[0][r][:, None]
         for v, x, y, r, f in zip(vel, gl, gs, rung, Fk)]
    for j in range(1, n_sub + 1):
        pos = [torch.remainder(x + q * Dr[j - 1], box)
               for x, q in zip(pos, p)]
        a_s = A_sub[j - 1]
        if not kit["rung_frozen"] or j == n_sub:
            pos, p, mass, (gl, gs, rung), ov_e = slab_exchange(
                pos, p, mass, box=box, ncell=geom.ncell, group=group,
                exchange_capacity=kit["E"], extras=(gl, gs, rung))
            chan_max("ov_ex", ov_e)
        if j == n_sub:
            g, ovs = kit["short_acc"](pos, mass, a_s)
            gs = g
            chan_max("ov_bk", ovs)
            kit["n_boundary"] += 1
        elif deepest < rung_active_min(j, n_rungs):
            continue
        else:
            act = [(r >= rung_active_min(j, n_rungs)) & (m > 0)
                   for r, m in zip(rung, mass)]
            if kit["rung_frozen"]:
                fkw = kit["fkw"]
                g, ovs = p3m_local_columns_frozen_masked(
                    pos, mass, act, plans, eps=kit["eps"], r_s=geom.r_s,
                    G=units.COSMO.G, split=fkw["split"],
                    softening=fkw["softening"], **kit["ckw"])
                g = [x / a_s for x in g]
                chan_max("ov_pl", ovs)
                chan_max("ov_st", [local_plan_stale(x, pl, box, kit["skin"])
                                   for x, pl in zip(pos, plans)])
            else:
                g, ov_j, ov_i, occ_i = kit["masked_acc"](pos, mass, act, a_s)
                chan_max("ov_bk", ov_j)
                chan_max("ov_tg", ov_i)
                chan_max("occ_tg", occ_i)
            kit["n_interior"] += 1
        p = [q + x * f[j][r][:, None] for q, x, r, f in zip(p, g, rung, Fk)]
    gl = kit["long_acc"](pos, mass, a1)
    vel = [q + x * kl2 for q, x in zip(p, gl)]
    return pos, vel, mass, gl, gs


def _demand_tables(kit: dict, cell: float, eta_disp: float, eta_acc: float,
                   eps: float, dtype, **extra) -> list:
    """Each shard's device copies of the demand's 0-d factors (one set a
    device; ``extra``: more host arrays to copy)."""
    out, seen = [], {}
    for dev in kit["group"].devices:
        if dev not in seen:
            def t(x):
                return torch.as_tensor(np.asarray(x), dtype=dtype,
                                       device=dev)

            seen[dev] = dict(
                cell=t(cell), eta=t(eta_disp),
                acc=t(2.0 * eta_acc * eps) if eta_acc * eps > 0 else None,
                **{k: t(v) for k, v in extra.items()})
        out.append(seen[dev])
    return out


def _run_domain_rungs(shards: list, cosmo, a_grid, group: ShardGroup, *,
                      box: float, nmesh: int, eps: float, geom: DomainP3M,
                      E: int, n_rungs: int, eta_disp: float, eta_acc: float,
                      target_capacity: int, col_capacity: int | None,
                      col_window: int | None, rung_frozen: bool,
                      column_skin: float, fkw: dict) -> DomainRunResult:
    """The domain rung tier on a fixed grid (CONCEPT's block steps on the
    slab decomposition; the JAX package's
    ``run_cosmological_domain(rungs=...)``).  Each global step assigns
    rungs from the displacement and acceleration demand of the carried
    force and takes :func:`_domain_rung_step`: the far field kicks at the
    half-steps and rung r at every 2^(R - 1 - r)-th of the n_sub = 2^(R -
    1) sub-ticks, the interior ticks on the masked cell planes or, with
    ``rung_frozen``, on each step's frozen local column plans.

    The step's global rung histogram is read on the host once per step
    (the only read before the end); the overflow channels stay on the
    device until the end."""
    from nbody_torch.integrate.cosmo_stepping import (
        cosmo_kick_drift_factors,
        rung_kick_tables,
    )

    kit = _rung_kit(cosmo, group, box=box, eps=eps, geom=geom, E=E,
                    n_rungs=n_rungs, target_capacity=target_capacity,
                    col_capacity=col_capacity, col_window=col_window,
                    rung_frozen=rung_frozen, column_skin=column_skin, fkw=fkw)
    a_grid = np.asarray(a_grid, dtype=np.float64)
    n_steps = len(a_grid) - 1
    KL1, _, KL2, _ = cosmo_kick_drift_factors(cosmo, a_grid)
    Fk, Dr, A_sub = rung_kick_tables(cosmo, a_grid, n_rungs)
    pos = [s.pos for s in shards]
    vel = [s.vel for s in shards]
    mass = [s.mass for s in shards]
    tabs = _demand_tables(kit, box / nmesh, eta_disp, eta_acc, eps,
                          pos[0].dtype, Fk=Fk, a0=a_grid[:-1], a1=a_grid[1:])

    t0 = float(shards[0].time)
    gl = kit["long_acc"](pos, mass, t0)
    gs, ovs = kit["short_acc"](pos, mass, t0)
    kit["ov_bk"] = _chan_max(group, kit["ov_bk"], ovs)
    kit["n_boundary"] = 1
    hists = np.zeros((n_steps, n_rungs), dtype=np.int64)
    for i in range(n_steps):
        rung, hist = _shard_rungs(
            kit, vel, mass, gl, gs, [tb["a0"][i] for tb in tabs],
            [torch.log(tb["a1"][i]) - torch.log(tb["a0"][i]) for tb in tabs],
            tabs)
        hists[i] = hist.tolist()
        tables = (float(a_grid[i + 1]), float(KL1[i]), float(KL2[i]),
                  [tb["Fk"][i] for tb in tabs], Dr[i].tolist(),
                  A_sub[i].tolist())
        pos, vel, mass, gl, gs = _domain_rung_step(kit, pos, vel, mass, gl,
                                                   gs, rung, hists[i], tables)
    return _rung_result(kit, _states(pos, vel, mass, float(a_grid[-1])),
                        rung_hists=hists)


def _rung_result(kit: dict, state: list, **kw) -> DomainRunResult:
    """The run's channels reduced as the JAX package reduces them (one
    host read each) and its counts."""
    group = kit["group"]
    return DomainRunResult(
        state=state,
        exchange_overflow=int(group.psum(kit["ov_ex"])[0]),
        bucket_overflow=int(group.psum(kit["ov_bk"])[0]),
        force_evals=kit["n_boundary"],
        target_overflow=int(group.psum(kit["ov_tg"])[0]),
        target_occupancy=int(group.pmax(kit["occ_tg"])[0]),
        plan_overflow=int(group.pmax(kit["ov_pl"])[0]),
        plan_stale=int(group.pmax(kit["ov_st"])[0]),
        interior_evals=kit["n_interior"], plan_freezes=kit["n_freeze"],
        **kw)


class DomainAdaptiveResult(NamedTuple):
    state: list                  # the shards' ParticleStates
    n_steps: int                 # steps taken by this call
    exchange_overflow: int       # sum over shards of each's max
    bucket_overflow: int         # sum over shards of each's max
    target_overflow: int         # sum over shards of each's max
    target_occupancy: int        # max over shards
    dla_last: float              # the last chosen background step
    rung_hist: list              # (rungs,) populations of the last step
    force_evals: int = 0         # boundary evaluations (far field and
    #                              short force each) of this call
    interior_evals: int = 0      # masked interior evaluations (K6's
    #                              two-plane slab site, one launch a shard)
    step_reads: int = 0          # host reads of the step and histogram


def run_cosmological_domain_adaptive(
        shards: list, cosmo, a_end: float, group: ShardGroup, *, box: float,
        nmesh: int, eps: float, n_global: int,
        exchange_capacity: int | None = None, geom: DomainP3M | None = None,
        deconvolve_p: int = 2, split: str = "spline",
        grad_order: str = "fd4", interlace: bool = False,
        softening: str = "plummer", rungs: int = 1, dla_max: float = 0.03,
        eta_disp: float = 0.25, eta_acc: float = 0.025,
        target_capacity: int = 128,
        max_steps: int | None = None) -> DomainAdaptiveResult:
    """The adaptive background step times per-particle rungs on the slab
    domain (the JAX package's ``run_cosmological_domain_adaptive``): per
    step, each shard's demand of its resident rows (parked rows count as
    inf), the global step

        dla = min(dla_max, 2^(rungs - 1) min over the shards of the
                  demand, ln a_end - ln a0),

    floored at 1e-8 (the last step ends exactly at a_end), the kick tables
    of the chosen step on the device (:func:`_rung_tables_device` in the
    state's dtype, on shard 0's device, copied to the others) and the rung
    step of the fixed grid, :func:`_domain_rung_step`, on the masked cell
    planes (every tick migrates).  ``rungs=1`` takes boundary ticks only:
    a plain adaptive KDK.  The chosen step, its tables and the histogram
    summed over the shards come to the host in one read a step.

    The call starts with the far field and the short force at the
    shards' positions and steps until a_end, or ``max_steps`` steps (the
    caller's stretch); the channels are read once, at the end."""
    from nbody_torch.integrate.cosmo_stepping import (
        _end_of,
        _host_read,
        _rung_demand,
        _rung_tables_device,
        _step_end,
        _time_of,
    )

    D = group.size
    if geom is None:
        geom = domain_p3m_geometry(box, nmesh, D, n_global)
    C = shards[0].pos.shape[0]
    E = exchange_capacity or max(64, C // 8)
    n_rungs = int(rungs)
    n_sub = 2 ** (n_rungs - 1)
    depth = float(n_sub)
    fkw = dict(deconvolve_p=deconvolve_p, split=split, grad_order=grad_order,
               interlace=interlace, softening=softening)
    kit = _rung_kit(cosmo, group, box=box, eps=eps, geom=geom, E=E,
                    n_rungs=n_rungs, target_capacity=target_capacity,
                    fkw=fkw)
    H0, Om, OL = kit["cosmo"]
    pos = [s.pos for s in shards]
    vel = [s.vel for s in shards]
    mass = [s.mass for s in shards]
    dtype, dev0 = pos[0].dtype, pos[0].device
    tabs = _demand_tables(kit, box / nmesh, eta_disp, eta_acc, eps, dtype)
    t, t_h = _time_of(shards[0])
    a_end_t, a_end_h = _end_of(a_end, pos[0])
    dla_max_t = torch.full((), float(dla_max), dtype=dtype, device=dev0)

    gl = kit["long_acc"](pos, mass, t_h)
    gs, ovs = kit["short_acc"](pos, mass, t_h)
    kit["ov_bk"] = _chan_max(group, kit["ov_bk"], ovs)
    kit["n_boundary"] = 1
    steps, reads, dla_h, hist = 0, 0, float(dla_max), [0] * n_rungs
    while t_h < a_end_h and (max_steps is None or steps < max_steps):
        demand = []
        for d in range(D):
            tb = tabs[d]
            dla = _rung_demand(vel[d], gl[d], gs[d], t.to(pos[d].device),
                               tb["cell"], tb["eta"], tb["acc"], H0, Om, OL)
            demand.append(torch.min(torch.where(mass[d] > 0, dla,
                                                torch.full_like(dla,
                                                                np.inf))))
        dla_min = group.pmin(demand)[0]
        dla = torch.minimum(torch.minimum(dla_max_t, depth * dla_min),
                            torch.log(a_end_t) - torch.log(t))
        dla = torch.clamp_min(dla, 1e-8)
        a1 = _step_end(t, dla, a_end_t)
        kl1, kl2, Fk, Dr, A_sub = _rung_tables_device(t, a1, n_rungs, H0, Om,
                                                      OL)
        rung, hist_t = _shard_rungs(
            kit, vel, mass, gl, gs, [t.to(x.device) for x in pos],
            [dla.to(x.device) for x in pos], tabs)
        vals = _host_read(dla, a1, kl1, kl2, Dr, A_sub, hist_t)
        reads += 1
        dla_h, a1_h = vals[0], vals[1]
        hist = [int(x) for x in vals[4 + 2 * n_sub:]]
        tables = (a1_h, vals[2], vals[3], [Fk.to(x.device) for x in pos],
                  vals[4:4 + n_sub], vals[4 + n_sub:4 + 2 * n_sub])
        pos, vel, mass, gl, gs = _domain_rung_step(kit, pos, vel, mass, gl,
                                                   gs, rung, hist, tables)
        t, t_h = a1, a1_h
        steps += 1
    res = _rung_result(kit, _states(pos, vel, mass, t_h))
    return DomainAdaptiveResult(
        state=res.state, n_steps=steps,
        exchange_overflow=res.exchange_overflow,
        bucket_overflow=res.bucket_overflow,
        target_overflow=res.target_overflow,
        target_occupancy=res.target_occupancy, dla_last=dla_h,
        rung_hist=hist, force_evals=res.force_evals,
        interior_evals=res.interior_evals, step_reads=reads)
