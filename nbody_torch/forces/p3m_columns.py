"""Column-packed short-range P3M tier: z-sorted (x, y) cell columns with
per-chunk z-windows.

Counterpart of :mod:`nbody.forces.p3m_columns`: the fresh plane and the
frozen column plans of the rung tier (:class:`ColumnPlan`).
Particles are sorted once into z-ordered (x, y) chaining columns of side
>= r_cut; each column is one contiguous bucket of capacity CK with a
ghost band of ``gz`` slots at each z end (the wrap partners, +-box baked
into z) and one ring of ghost columns around the grid (+-box baked into
x and y), so the pair sum needs no minimum image.  Each 256-slot chunk of
targets interacts only with the z-window of its 9 neighbour columns that
its z-range +- r_cut can reach; the window starts come from the plane
build.  Bucket, ghost and window overflow are counted and returned in one
field-encoded word, so the driver's self-heal can grow the right knob.

A frozen plan keeps everything about a plane that does not depend on the
positions (the sort composed into per-slot gather indices, skin-widened
window tables, the slot map), so that the plane at positions within
skin/2 of the freeze positions is one row gather.

The slab tier of the domain decomposition builds the same plane over a
shard's own x-rows (:func:`build_local_column_plane`, K4's slab site),
and freezes it for the domain rung tier (:class:`LocalColumnPlan`,
:func:`p3m_local_columns_frozen_masked`, K5's slab site).

The plane build is PyTorch.  The pair sum is K4, a CUDA kernel
(``forces/csrc/p3m_columns.cu``) on a CUDA tensor, and its plain PyTorch
version :func:`column_plane_plain` on a CPU tensor; K5, in the same
source, is K4 restricted to a table of active chunks
(:func:`run_column_plane_masked`).  Each block of the kernels visits only
the slots of its chunk's windows that its targets can reach, by the rule
that :func:`column_reach` states in plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nbody_torch.forces.p3m import _SOFTENINGS, _SPLITS, _weight_fn

_ZBITS = 21


def _ceil128(x: int) -> int:
    return -(-int(x) // 128) * 128


def ghost_slots(col_capacity: int, rc_slots: float | None = None) -> int:
    """z-ghost capacity per column end: 2.2x the z-extent of r_cut in
    slots at capacity density, 128-aligned (CK/4 without ``rc_slots``).
    Demand beyond it is counted as overflow and heals via the capacity."""
    if rc_slots is not None:
        return max(128, -(-int(2.2 * rc_slots) // 128) * 128)
    return max(128, (col_capacity // 4 // 128) * 128)


def column_window(box: float, r_cut: float, col_capacity: int) -> int:
    """Auto z-window for a column capacity: a 256-slot chunk's z-span + 2
    r_cut of margin in slots at capacity density + 127 slots of start
    alignment, clamped to the column stride.  Window misses are counted
    as overflow, so this sets only the work/robustness trade."""
    rc_slots = (r_cut / box) * col_capacity
    span = 256.0 + 2.2 * rc_slots + 127.0
    window = max(384, -(-int(span) // 128) * 128)
    return min(window, col_capacity + 2 * ghost_slots(col_capacity, rc_slots))


def column_params(box: float, nmesh: int, n: int):
    """(r_s, r_cut, ncell, col_capacity, window) defaults for the column
    tier: the mean column + 6 sigma Poisson tail, 128-aligned."""
    from nbody_torch.forces.p3m import auto_column_capacity, p3m_short_params

    r_s, r_cut, ncell, _ = p3m_short_params(box, nmesh, n)
    col_capacity = auto_column_capacity(n, ncell)
    return r_s, r_cut, ncell, col_capacity, column_window(
        box, r_cut, col_capacity
    )


def _col_z_order(col, z, box: float):
    """Stable argsort by (column id, z): one int64 key (col << 21) | zq,
    the order of the JAX package's int32 two-pass sort."""
    zq = torch.clamp(
        (z * ((1 << _ZBITS) / box)).to(torch.int32), 0, (1 << _ZBITS) - 1
    )
    key = (col.to(torch.int64) << _ZBITS) | zq.to(torch.int64)
    return torch.argsort(key, stable=True)


def _slot_sources(starts, counts, CK: int, gz: int, stride: int):
    """Per-slot source index into the sorted particle rows plus the band
    masks.  Slot layout per column (ascending z): [0, gz) front ghosts
    (the last reals, z - box), [gz, gz + cnt) reals, [gz + cnt,
    gz + cnt + gz) back ghosts (the first reals, z + box), then padding."""
    cnt = torch.clamp_max(counts, CK)[:, None]
    r = (torch.arange(stride, device=starts.device) - gz)[None, :]
    is_front = r < 0
    is_interior = (r >= 0) & (r < cnt)
    g_b = r - cnt
    is_back = (r >= cnt) & (g_b < gz)
    st = starts[:, None]
    src = torch.where(is_front, st + cnt + r,
                      torch.where(is_back, st + g_b, st + r))
    src_ok = (src >= st) & (src < st + cnt)
    return src, src_ok, is_front, is_interior, is_back


def _rows_to_buf(rows, src_ok, is_front, is_interior, is_back,
                 box: float, r_cut: float, zmargin: float):
    """(ncol, stride, 4) buffer from the gathered rows: ghost validity on
    the rows' z, +-box z shifts applied, invalid slots parked at sentinels
    that keep each column ascending in z.  Returns (buf, z_raw)."""
    z_pad = box + 3.0 * r_cut
    z_raw = rows[..., 2]
    valid = (
        is_interior
        | (is_front & src_ok & (z_raw >= box - zmargin))
        | (is_back & src_ok & (z_raw <= zmargin))
    )
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    shift = torch.where(is_front, zero - box, torch.where(is_back, zero + box,
                                                          zero))
    default_z = torch.where(is_front, zero - 2.0 * box, zero + z_pad)
    xy = torch.where(valid[..., None], rows[..., 0:2], zero - 8.0 * r_cut)
    zf = torch.where(valid, z_raw + shift, default_z)
    mf = torch.where(valid, rows[..., 3], zero)
    return torch.cat([xy, zf[..., None], mf[..., None]], dim=-1), z_raw


def _plane_from_buf(buf, box: float, ncell: int, stride: int):
    """The xy ghost ring (+-box baked into x and y of the massive slots)
    and the (8, P2 * stride) SoA plane: rows x, y, z, m, then four zero
    rows; a buffer with a leading member axis (B, ncol, stride, 4) gives
    (B, 8, P2 * stride)."""
    P = ncell + 2
    P2 = P * P
    lead = buf.shape[:-3]
    grid4 = buf.reshape((-1, ncell, ncell, stride, 4))
    wrap = (torch.arange(P, device=buf.device) - 1) % ncell
    padded = grid4[:, wrap][:, :, wrap].clone()
    zero = torch.zeros((), dtype=buf.dtype, device=buf.device)
    for ax in range(2):
        for edge, delta in ((0, -box), (P - 1, box)):
            sl = (slice(None),) * (ax + 1) + (edge,)
            lo = padded[sl]
            lo[..., ax] += torch.where(lo[..., 3] > 0, zero + delta, zero)
    soa = padded.reshape(-1, P2 * stride, 4).transpose(1, 2)
    plane = torch.cat([soa, torch.zeros_like(soa)], dim=1).contiguous()
    return plane.reshape(lead + (8, P2 * stride))


class ColumnPlan(NamedTuple):
    """A frozen column bucketing, valid for positions within skin/2
    (minimum image) of ``pos0``: a pair within r_cut then has frozen xy
    separation <= r_cut + skin <= the column side, the window thresholds
    were widened by the skin, and the ghost demand was counted with a
    skin/2 wider wrap margin.  ``ov`` is the freeze-time overflow word;
    the frozen evaluations return it as it is."""

    pos0: torch.Tensor    # (n, 3) float32 wrapped positions at freeze
    src_g: torch.Tensor   # (ncol, stride) int64 slot -> particle row
    starts: torch.Tensor  # (ncol,) int64
    counts: torch.Tensor  # (ncol,) int64 raw (may exceed CK)
    ws: torch.Tensor      # (ncol * 9 * maxch,) int32 frozen window starts
    nch: torch.Tensor     # (ncol,) int32
    gidx: torch.Tensor    # (n,) int64 particle -> padded slot
    ov: torch.Tensor      # 0-d int64 field-encoded freeze-time overflow


def build_column_plane(pos, mass, box: float, r_cut: float, ncell: int,
                       col_capacity: int, window: int, chunk: int = 256,
                       skin: float = 0.0, with_plan: bool = False):
    """Sort particles into z-ordered (x, y)-column buckets and assemble
    the ghost-padded float32 SoA plane plus the per-chunk window tables.

    Returns (plane (8, P2 * stride) float32, ws (ncol * 9 * maxch,) int32,
    nch (ncol,) int32, overflow_bucket, overflow_window, gidx (n,) int64,
    counts (ncol,) int32 = min(raw, CK)): P2 = (ncell + 2)^2 padded
    columns of stride = CK + 2 gz slots; ``ws`` holds each (column,
    neighbour, chunk)'s 128-aligned window start; ``gidx`` maps each
    particle to its padded slot (P2 * stride if its bucket was full).
    The two overflow counts are 0-d int64 tensors on the device.

    B members at once, ``pos`` (B, n, 3) and ``mass`` (B, n), give each
    of these with a leading member axis (the overflow counts (B,)), each
    member's equal to its own build: one sort of all members' keys (a
    member's columns after the previous member's) and one gather.  One
    particle set is a batch of one.

    ``skin`` widens the window thresholds and the ghost margins as
    :func:`freeze_column_plan` does (the extra sources lie beyond r_cut
    and weigh nothing now); ``with_plan=True`` (one particle set) appends
    the :class:`ColumnPlan` of the same sort."""
    one = pos.ndim == 2
    if one:
        pos, mass = pos[None], mass[None]
    elif with_plan:
        raise ValueError("build_column_plane: a frozen plan holds one "
                         "particle set")
    B, n = pos.shape[0], pos.shape[1]
    dev = pos.device
    f32 = torch.float32
    CK = _ceil128(col_capacity)
    gz = ghost_slots(CK, (float(r_cut) / box) * CK)
    stride = CK + 2 * gz
    W = _ceil128(window)
    maxch = CK // chunk
    ncol = ncell * ncell
    P = ncell + 2
    P2 = P * P
    zmargin = 1.0001 * r_cut + 0.5 * skin

    posw = torch.remainder(pos, box).to(f32).reshape(B * n, 3)
    massf = mass.to(f32).reshape(B * n)
    cx = torch.clamp((posw[:, 0] * (ncell / box)).to(torch.int32), 0,
                     ncell - 1).to(torch.int64)
    cy = torch.clamp((posw[:, 1] * (ncell / box)).to(torch.int32), 0,
                     ncell - 1).to(torch.int64)
    member = torch.arange(B, device=dev).repeat_interleave(n)
    # a member's columns follow the previous member's, so one stable sort
    # orders each member as its own sort does
    col = member * ncol + cx * ncell + cy
    order = _col_z_order(col, posw[:, 2], box)
    pos_s = posw[order]
    mass_s = massf[order]
    col_s = col[order]

    cols = torch.arange(B * ncol, device=dev)
    starts = torch.searchsorted(col_s, cols, right=False)
    ends = torch.searchsorted(col_s, cols, right=True)
    counts = ends - starts
    rank = torch.arange(B * n, device=dev) - starts[col_s]
    ok = rank < CK
    overflow_b = torch.sum((~ok).reshape(B, n), dim=1)
    # the member's rows of the sorted arrays, for clamped gathers
    row_lo = (cols // ncol) * n
    row_hi = row_lo + max(n - 1, 0)

    # interior + z-ghost assembly: one gather from the sorted rows
    src, src_ok, is_front, is_interior, is_back = _slot_sources(
        starts, counts, CK, gz, stride)
    src_c = torch.clamp(src, row_lo[:, None], row_hi[:, None])
    rows = torch.cat([pos_s, mass_s[:, None]], dim=1)[src_c]
    buf, z_raw = _rows_to_buf(rows, src_ok, is_front, is_interior, is_back,
                              box, r_cut, zmargin)

    # ghost demand: stored reals in the wrap margins beyond gz would miss
    # their wrap partners; counted on the bucket field (heal = capacity)
    nb = torch.sum(is_interior & (z_raw <= zmargin), dim=1)
    nf = torch.sum(is_interior & (z_raw >= box - zmargin), dim=1)
    ov_g = torch.sum((torch.clamp_min(nb - gz, 0)
                      + torch.clamp_min(nf - gz, 0)).reshape(B, ncol), dim=1)

    # window tables.  Each column's z is ascending up to the 2^-21 box
    # quantum of the sort key, so the counts of slots below a threshold
    # are taken on a fully sorted copy: the same counts as a comparison
    # over every slot, in O(stride) memory per column.
    zsorted = torch.sort(buf[:, :, 2], dim=1).values
    ch = torch.arange(maxch, device=dev)
    cnt_ck = torch.clamp_max(counts, CK)
    nch = -(-cnt_ck // chunk)
    idx0 = starts[:, None] + ch[None, :] * chunk
    last = starts[:, None] + cnt_ck[:, None] - 1
    lo_r, hi_r = row_lo[:, None], row_hi[:, None]
    zmin = pos_s[torch.clamp(idx0, lo_r, hi_r), 2]
    zmax = pos_s[torch.clamp(torch.minimum(idx0 + chunk - 1, last), lo_r,
                             hi_r), 2]
    chunk_ok = ch[None, :] < nch[:, None]
    qlo = (zmin - r_cut - skin).contiguous()
    qhi = (zmax + r_cut + skin).contiguous()

    ic = cols % ncol
    ic_x = ic // ncell
    ic_y = ic % ncell
    ws_list = []
    miss = torch.zeros_like(qlo, dtype=torch.int64)
    for o2 in range(9):
        dxo, dyo = o2 // 3 - 1, o2 % 3 - 1
        nc = (cols - ic + ((ic_x + dxo) % ncell) * ncell
              + (ic_y + dyo) % ncell)
        zj = zsorted[nc]
        lo_exact = torch.searchsorted(zj, qlo, right=False)
        start = torch.clamp((lo_exact // 128) * 128, 0, stride - W)
        hi_exact = torch.searchsorted(zj, qhi, right=False)
        miss = miss + torch.where(
            chunk_ok, torch.clamp_min(hi_exact - (start + W), 0), 0)
        ws_list.append(start)
    ov_w = torch.sum(miss.reshape(B, -1), dim=1)
    ws = torch.stack(ws_list, dim=1).reshape(B, ncol * 9 * maxch)
    overflow_b = overflow_b + ov_g

    plane = _plane_from_buf(buf.reshape(B, ncol, stride, 4), box, ncell,
                            stride)

    pc = ((cx + 1) * P + (cy + 1))[order]
    gidx_s = torch.where(ok, pc * stride + gz + rank,
                         torch.full_like(rank, P2 * stride))
    gidx = torch.empty(B * n, dtype=torch.int64, device=dev)
    gidx[order] = gidx_s
    base = (plane, ws.to(torch.int32), nch.to(torch.int32).reshape(B, ncol),
            overflow_b, ov_w, gidx.reshape(B, n),
            cnt_ck.to(torch.int32).reshape(B, ncol))
    if one:
        base = tuple(t[0] for t in base)
    if not with_plan:
        return base
    plan = ColumnPlan(pos0=posw, src_g=order[src_c], starts=starts,
                      counts=counts, ws=base[1], nch=base[2], gidx=base[5],
                      ov=encode_overflow(base[3], base[4]))
    return base + (plan,)


# Largest column stride (slots) the JAX package's column kernels afford in
# the TPU's scoped VMEM.  The CUDA kernels stream the window through
# shared memory and have no such limit, but the port keeps the value so
# that both packages resolve the same tier for a config (p3m_acc).
_STRIDE_MAX = 49152


def columns_stride_ok(box: float, r_cut: float, col_capacity: int) -> bool:
    """True when the column stride at this capacity is within
    `_STRIDE_MAX`."""
    CK = _ceil128(col_capacity)
    gz = ghost_slots(CK, (float(r_cut) / box) * CK)
    return CK + 2 * gz <= _STRIDE_MAX


def encode_overflow(ov_b, ov_w):
    """One overflow word: bucket/ghost spills * 65536 + window misses
    (each field saturated), zero iff no force was dropped.  Counts of B
    members ((B,) each) give the batch's word: each field the largest
    member's (never the sum), so a heal grows the knob each field names
    to what the neediest member asks."""
    return (torch.clamp_max(torch.amax(ov_b), 32767) * 65536
            + torch.clamp_max(torch.amax(ov_w), 65535))


def interior_slots(ncell: int, stride: int, gz: int, chunk: int, nch,
                   device=None, cht=None, maxch: int = 0, nx: int | None = None):
    """(column id, chunk index, first padded slot) of every occupied chunk
    of the interior columns, as int64 tensors: the targets of K3/K4.  With
    a chunk table ``cht`` (ncol * maxch), column ic's chunks are the first
    nch[ic] entries of its row instead (K5's active chunks).  ``nx`` is
    the plane's count of interior x-rows (ncell, or a slab's ncell / D)."""
    ncol = (ncell if nx is None else nx) * ncell
    P = ncell + 2
    nch = nch.to(torch.int64)
    ic = torch.repeat_interleave(torch.arange(ncol, device=device), nch)
    first = torch.cumsum(nch, 0) - nch
    k = torch.arange(ic.numel(), device=device) - first[ic]
    if cht is not None:
        k = cht.to(torch.int64).reshape(ncol, maxch)[ic, k]
    pcol = (ic // ncell + 1) * P + (ic % ncell + 1)
    return ic, k, pcol * stride + gz + k * chunk


def column_pair_sums(plane, ws, nch, *, ncell: int, stride: int, W: int,
                     maxch: int, gz: int, chunk: int, eps: float, r_s: float,
                     r_cut: float, split: str, softening: str,
                     max_pairs: int = 1 << 24, cht=None,
                     nx: int | None = None):
    """The short-range sums of every occupied chunk's targets over its 9
    neighbour windows, in the plane's dtype: (targets (B, chunk) slot
    indices, sums (3, B, chunk)); with a chunk table ``cht``, of the
    chunks it lists (see :func:`interior_slots`); ``nx`` interior x-rows.

    Targets go in tiles of 32 slots and each window in tiles of 64; a
    tile pair whose z ranges lie more than r_cut apart holds no pair
    inside r_cut and is skipped (the sentinel slots' far-off z makes most
    of a sparse column's window such tiles).  The weight is evaluated
    only for the visits inside r_cut (it is 0 beyond).  Chunked over the
    B occupied chunks so that no more than ``max_pairs`` visits are
    materialized at once."""
    wfn = _weight_fn(split, softening)
    dev = plane.device
    P = ncell + 2
    tt_n, ts_n = 32, 64  # chunk and W are multiples of 128
    ic, k, first = interior_slots(ncell, stride, gz, chunk, nch, dev,
                                  cht=cht, maxch=maxch, nx=nx)
    tgt = first[:, None] + torch.arange(chunk, device=dev)[None, :]
    jw = torch.arange(W, device=dev)
    nb = ic.numel()
    sums = torch.zeros((3, nb * chunk), dtype=plane.dtype, device=dev)
    step = max(1, max_pairs // (chunk * W))
    ws64 = ws.to(torch.int64).reshape(-1, 9, maxch)
    eps2 = float(eps) ** 2
    rc2 = float(r_cut) ** 2
    reach = float(r_cut) * (1.0 + 1e-5)  # above float32 rounding of |dz|
    for b0 in range(0, nb, step):
        bi, bk = ic[b0:b0 + step], k[b0:b0 + step]
        tiles = tgt[b0:b0 + step].reshape(bi.numel(), -1, tt_n)
        rows = (b0 * chunk + torch.arange(tiles.numel(), device=dev)
                ).reshape(tiles.shape)
        zt = plane[2][tiles]
        t_lo, t_hi = zt.amin(-1) - reach, zt.amax(-1) + reach
        for o2 in range(9):
            jcol = (bi // ncell + o2 // 3) * P + (bi % ncell + o2 % 3)
            src = ((jcol * stride + ws64[bi, o2, bk])[:, None] + jw[None, :]
                   ).reshape(bi.numel(), -1, ts_n)
            zs = plane[2][src]
            near = ((zs.amin(-1)[:, None, :] < t_hi[:, :, None])
                    & (zs.amax(-1)[:, None, :] > t_lo[:, :, None]))
            pb, pt, ps = torch.nonzero(near, as_tuple=True)
            ti, sj = tiles[pb, pt], src[pb, ps]  # (tile pairs, 32 / 64)
            d = plane[0:3, sj][:, :, None, :] - plane[0:3, ti][:, :, :, None]
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            hit = torch.clamp_min(r2, 1e-30) < rc2
            p, a, c = torch.nonzero(hit, as_tuple=True)
            w = plane[3][sj[p, c]] * wfn(r2[p, a, c], eps2, r_s, r_cut)
            sums.index_add_(1, rows[pb[p], pt[p], a], w * d[:, p, a, c])
    return tgt, sums.reshape(3, nb, chunk)


def column_plane_plain(plane, ws, nch, *, ncell: int, stride: int, W: int,
                       maxch: int, gz: int, chunk: int, eps: float,
                       r_s: float, r_cut: float, split: str, softening: str,
                       cht=None, nx: int | None = None):
    """Plain PyTorch version of K4 (and, with the chunk table ``cht``, of
    K5): the output plane, shaped like ``plane``, with rows 0-2 the
    short-range sums at the slots of the occupied (listed) chunks of the
    interior columns and zeros everywhere else.  ``nx`` is the count of
    interior x-rows: ncell for the whole box's (8, P2 * stride) plane, a
    slab's ncell / D for its (8, (nx + 2) * P * stride) plane.  B members'
    planes (B, 8, ...) with their tables (B, ...) give B output planes,
    each member alone."""
    if plane.ndim == 3:
        return torch.stack([column_plane_plain(
            plane[b], ws[b], nch[b], ncell=ncell, stride=stride, W=W,
            maxch=maxch, gz=gz, chunk=chunk, eps=eps, r_s=r_s, r_cut=r_cut,
            split=split, softening=softening,
            cht=None if cht is None else cht[b], nx=nx)
            for b in range(plane.shape[0])])
    tgt, sums = column_pair_sums(
        plane, ws, nch, ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
        chunk=chunk, eps=eps, r_s=r_s, r_cut=r_cut, split=split,
        softening=softening, cht=cht, nx=nx)
    out = torch.zeros_like(plane)
    out[0:3, tgt.reshape(-1)] = sums.reshape(3, -1)
    return out


# The column kernels' block of targets and the spacing of their reach
# search's probes (kColTargets and kColFence in csrc/column_pairs.cuh;
# :func:`column_info` reads them from a built library).
REACH_TARGETS = 128
REACH_FENCE = 32


def column_info(lib) -> tuple[int, int, bool]:
    """(targets a block, slots between probes, whether they search) of the
    column kernels in the kernel library ``lib``: the ``group`` and
    ``fence`` of :func:`column_reach` for that build, and False for a
    build that visits the whole windows."""
    import ctypes

    out = [ctypes.c_int() for _ in range(3)]
    lib.column_pairs_info(*map(ctypes.byref, out))
    return out[0].value, out[1].value, bool(out[2].value)


def column_reach(plane, ws, nch, *, ncell: int, stride: int, W: int,
                 maxch: int, gz: int, chunk: int, r_cut: float, box: float,
                 drift=None, cht=None, nx: int | None = None,
                 group: int = REACH_TARGETS, fence: int = REACH_FENCE):
    """The reach rule of the column kernels (K3, K4, K5), plain: for each
    block of ``group`` targets of each occupied (with ``cht``: listed)
    chunk, the slots [lo, hi) of each of its 9 neighbour windows that it
    visits, as offsets into the window.  Returns (first (B,) the block's
    first target slot, lo (B, 9), hi (B, 9)); lo >= hi visits nothing.

    The block's targets, less the sentinels (z < -box: invalid front
    ghosts; z > box + 2 r_cut: padding and invalid back ghosts), span
    [tmin, tmax]; every ``fence``-th slot of a window is a probe.  The
    start moves up to the last probe whose z lies below tmin - reach -
    slack (a front sentinel counts as z = -1.0001 r_cut), the end down to
    the first probe above tmax + reach + slack (a back sentinel counts as
    z = box + 1.0001 r_cut); reach is r_cut (1 + 1e-5) and slack twice
    the ``drift`` (None for a fresh plane; for a frozen one the largest
    |z drift| of its particles since the freeze, :func:`frozen_plane`'s),
    each plus 4 quanta of the sort key (box / 2^21).  So every source of
    nonzero mass within r_cut of a target lies inside (the kernel's
    comment in csrc/column_pairs.cuh says why).  Thresholds are taken in
    the plane's dtype, as the kernel does in float32."""
    dev, dt = plane.device, plane.dtype
    P = ncell + 2
    ic, k, cfirst = interior_slots(ncell, stride, gz, chunk, nch, dev,
                                   cht=cht, maxch=maxch, nx=nx)
    per = chunk // group
    first = (cfirst[:, None] + group * torch.arange(per, device=dev)
             ).reshape(-1)
    ic, k = ic.repeat_interleave(per), k.repeat_interleave(per)
    quantum = box / (1 << 21)
    c = {key: torch.tensor(v, dtype=dt, device=dev) for key, v in dict(
        reach=r_cut * (1.0 + 1e-5) + 4.0 * quantum, slack=4.0 * quantum,
        zlow=-box, zhigh=box + 2.0 * r_cut, key_lo=-1.0001 * r_cut,
        key_hi=box + 1.0001 * r_cut).items()}
    if drift is not None:
        c["slack"] = c["slack"] + 2.0 * torch.as_tensor(
            drift, device=dev).to(dt).reshape(())
    tz = plane[2][first[:, None] + torch.arange(group, device=dev)]
    real = (tz >= c["zlow"]) & (tz <= c["zhigh"])
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    tmin = torch.where(real, tz, inf).amin(1)
    tmax = torch.where(real, tz, -inf).amax(1)
    below = (tmin - c["reach"]) - c["slack"]
    above = (tmax + c["reach"]) + c["slack"]
    nf = -(-W // fence)
    f = torch.arange(nf, device=dev)
    ws64 = ws.to(torch.int64).reshape(-1, 9, maxch)
    lo, hi = [], []
    for o2 in range(9):
        jcol = (ic // ncell + o2 // 3) * P + (ic % ncell + o2 % 3)
        z = plane[2][(jcol * stride + ws64[ic, o2, k])[:, None]
                     + fence * f[None, :]]
        low, high = z < c["zlow"], z > c["zhigh"]
        up = ~high & (torch.where(low, c["key_lo"], z) < below[:, None])
        down = ~low & (torch.where(high, c["key_hi"], z) > above[:, None])
        lo.append(torch.where(up, f, 0).amax(1) * fence)
        hi.append(torch.clamp_max(torch.where(down, f, nf).amin(1) * fence,
                                  W))
    lo, hi = torch.stack(lo, 1), torch.stack(hi, 1)
    empty = ~real.any(1)[:, None]
    return first, torch.where(empty, 0, lo), torch.where(empty, 0, hi)


def plane_members(plane) -> int:
    """The members of a plane: B for B members' planes (B, 8, ...), 1 for
    one plane (8, ...)."""
    return plane.shape[0] if plane.ndim == 3 else 1


def check_plane_args(name: str, plane, ints: dict, *, maxch: int,
                     ncell: int, stride: int, nx: int | None = None) -> int:
    """Raise on what the column kernels do not take: a float32 contiguous
    (8, (nx + 2) * (ncell + 2) * stride) plane, or B members' (B, 8, ...),
    and int32 contiguous tables on its device, a member's after another's
    (nx = ncell unless given).  Returns the members."""
    nx = ncell if nx is None else nx
    if not 1 <= nx <= ncell:
        raise ValueError(f"{name}: nx={nx} outside 1..ncell={ncell}")
    P2 = (nx + 2) * (ncell + 2)
    if plane.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes a float32 plane, "
                        f"got {plane.dtype}")
    members = plane_members(plane)
    if (tuple(plane.shape[-2:]) != (8, P2 * stride) or plane.ndim not in (2, 3)
            or members < 1 or not plane.is_contiguous()):
        raise ValueError(f"{name}: plane {tuple(plane.shape)}, expected a "
                         f"contiguous (8, {P2 * stride}) or (B, 8, "
                         f"{P2 * stride})")
    ncol = nx * ncell
    sizes = {"ws": ncol * 9 * maxch, "nch": ncol, "counts": ncol,
             "cht": ncol * maxch}
    for key, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32, got {t.dtype}")
        if t.device != plane.device or not t.is_contiguous() \
                or t.numel() != members * sizes[key]:
            raise ValueError(f"{name}: {key} must be a contiguous int32 "
                             f"tensor of {members} x {sizes[key]} on "
                             f"{plane.device}")
    return members


def launch_columns(lib, plane, ws, nch, cht, *, ncell: int, stride: int,
                   W: int, maxch: int, gz: int, chunk: int, eps: float,
                   r_s: float, r_cut: float, split: str, softening: str,
                   nx: int, box: float, drift):
    """One launch of K4 (``cht`` None) or K5 from the kernel library
    ``lib`` on checked arguments, over every member of a batched plane ->
    the output plane; raises if the launch fails.  The wrappers call it with the port's library, the ablation
    with its variants'."""
    out = torch.zeros_like(plane)
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    head = (plane.data_ptr(), ws.data_ptr(), nch.data_ptr())
    if cht is not None:
        head = head + (cht.data_ptr(),)
    fn = lib.p3m_columns_f32 if cht is None else lib.p3m_columns_masked_f32
    with torch.cuda.device(plane.device):
        err = fn(*head, plane_members(plane), nx, ncell, stride, W, maxch, gz, chunk, float(eps),
                 float(r_s), float(r_cut), float(box),
                 None if drift is None else drift.data_ptr(),
                 _SPLITS[split], _SOFTENINGS[softening], out.data_ptr(),
                 stream)
    if err != 0:
        name = "run_column_plane" + ("" if cht is None else "_masked")
        raise RuntimeError(f"{name}: CUDA launch failed (error {err})")
    return out


def reach_args(name: str, plane, box, drift) -> dict:
    """The box and drift the column kernels' reach search takes, checked:
    a positive box (the plane's sentinels and its sort key's quantum) and
    a frozen plane's drift, one float32 a member on the plane's device
    (:func:`frozen_plane`), or None for a fresh plane."""
    if box is None or not float(box) > 0.0:
        raise ValueError(f"{name}: the kernel needs the box (> 0), got "
                         f"{box}")
    if drift is not None and (
            not isinstance(drift, torch.Tensor)
            or drift.dtype != torch.float32
            or drift.numel() != plane_members(plane)
            or not drift.is_contiguous() or drift.device != plane.device):
        raise ValueError(f"{name}: drift must be one float32 a member on "
                         f"{plane.device} (frozen_plane's), got {drift!r}")
    return dict(box=float(box), drift=drift)


def run_column_plane(plane, ws, nch, *, ncell: int, stride: int, W: int,
                     maxch: int, gz: int, chunk: int, eps: float, r_s: float,
                     r_cut: float, split: str, softening: str,
                     nx: int | None = None, box: float | None = None,
                     drift=None):
    """K4: the short-range column pair sum over a plane from
    :func:`build_column_plane` (or, with ``nx`` = ncell / D, a slab's plane
    from :func:`build_local_column_plane`) -> the output plane (see
    :func:`column_plane_plain`).  A CUDA plane launches the kernel or
    raises; a CPU plane takes the plain version.  The kernel takes the
    ``box`` and, for a frozen plane, its ``drift`` (:func:`frozen_plane`):
    each block visits only the slots of its targets' reach
    (:func:`column_reach`).  ``run_column_plane.launches`` counts kernel
    launches."""
    if split not in _SPLITS or softening not in _SOFTENINGS:
        raise ValueError(f"unknown split/softening {split!r}/{softening!r}")
    nx = ncell if nx is None else nx
    kw = dict(ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
              chunk=chunk, eps=eps, r_s=r_s, r_cut=r_cut, split=split,
              softening=softening, nx=nx)
    if plane.device.type == "cpu":
        return column_plane_plain(plane, ws, nch, **kw)
    if plane.device.type != "cuda":
        raise ValueError(f"run_column_plane: no kernel for {plane.device}")
    check_plane_args("run_column_plane", plane, {"ws": ws, "nch": nch},
                     maxch=maxch, ncell=ncell, stride=stride, nx=nx)
    from nbody_torch._kernels import load_library

    out = launch_columns(load_library(), plane, ws, nch, None,
                         **reach_args("run_column_plane", plane, box, drift),
                         **kw)
    run_column_plane.launches += 1
    return out


run_column_plane.launches = 0


def run_column_plane_masked(plane, ws, nch_act, cht, *, ncell: int,
                            stride: int, W: int, maxch: int, gz: int,
                            chunk: int, eps: float, r_s: float, r_cut: float,
                            split: str, softening: str,
                            nx: int | None = None, box: float | None = None,
                            drift=None):
    """K5: K4 restricted to the active chunks, ``nch_act[ic]`` of them in
    column ic, their indices the first entries of row ic of the chunk
    table ``cht`` (ncol * maxch) -> the output plane, zeros at the slots
    of chunks not listed; ``nx`` = ncell / D for a slab's frozen plane
    (:func:`p3m_local_columns_frozen_masked`); ``box`` and ``drift`` as in
    :func:`run_column_plane`.  A CUDA plane launches the kernel or raises;
    a CPU plane takes :func:`column_plane_plain` with the table.
    ``run_column_plane_masked.launches`` counts kernel launches."""
    if split not in _SPLITS or softening not in _SOFTENINGS:
        raise ValueError(f"unknown split/softening {split!r}/{softening!r}")
    nx = ncell if nx is None else nx
    kw = dict(ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
              chunk=chunk, eps=eps, r_s=r_s, r_cut=r_cut, split=split,
              softening=softening, nx=nx)
    if plane.device.type == "cpu":
        return column_plane_plain(plane, ws, nch_act, cht=cht, **kw)
    if plane.device.type != "cuda":
        raise ValueError(f"run_column_plane_masked: no kernel for "
                         f"{plane.device}")
    check_plane_args("run_column_plane_masked", plane,
                     {"ws": ws, "nch": nch_act, "cht": cht}, maxch=maxch,
                     ncell=ncell, stride=stride, nx=nx)
    from nbody_torch._kernels import load_library

    out = launch_columns(load_library(), plane, ws, nch_act, cht,
                         **reach_args("run_column_plane_masked", plane, box,
                                      drift), **kw)
    run_column_plane_masked.launches += 1
    return out


run_column_plane_masked.launches = 0


def plane_geometry(box: float, r_cut: float, col_capacity: int,
                   window: int, chunk: int = 256):
    """(CK, gz, stride, W, maxch, chunk) of a column plane: the chunk
    drops to 128 when it does not divide CK; W is clamped to the stride."""
    CK = _ceil128(col_capacity)
    gz = ghost_slots(CK, (float(r_cut) / box) * CK)
    if CK % chunk:
        chunk = 128
    stride = CK + 2 * gz
    W = min(_ceil128(window), stride)
    return CK, gz, stride, W, CK // chunk, chunk


def read_back(out, gidx, rows: int):
    """Per-particle values of the first ``rows`` plane rows at each
    particle's slot (zeros for an overflowed particle): (n, rows); with
    ``gidx`` None the slot table itself, a zero row appended.  B members'
    output planes (B, 8, ...) and slots (B, n) give (B, n, rows)."""
    flat = out[..., :rows, :].transpose(-1, -2)
    pad = torch.zeros(flat.shape[:-2] + (1, rows), dtype=out.dtype,
                      device=out.device)
    table = torch.cat([flat, pad], dim=-2)
    if gidx is None or table.ndim == 2:
        return table if gidx is None else table[gidx]
    member = torch.arange(table.shape[0], device=out.device)[:, None]
    return table[member, gidx]


def p3m_short_columns(pos, mass, box: float, eps: float, r_s: float,
                      r_cut: float, G: float = 1.0, *, ncell: int,
                      col_capacity: int, window: int,
                      split: str = "gaussian", softening: str = "plummer",
                      chunk: int = 256):
    """Short-range P3M force via the column-packed pair sum (K4).

    Returns (acc (N, 3) in ``pos``'s dtype, overflow 0-d tensor): overflow
    is 0 iff no force was dropped, else bucket/ghost spills * 65536 +
    z-window misses, so the driver's self-heal can tell col_capacity (high
    field) from column_window (low field).  B members, ``pos`` (B, N, 3),
    share one capacity and window: one plane build, one K4 launch, acc
    (B, N, 3) and the batch's word (:func:`encode_overflow`)."""
    if box / ncell < r_cut - 1e-9:
        raise ValueError(f"column size {box / ncell:.3f} < r_cut {r_cut:.3f}")
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut,
                                                     col_capacity, window,
                                                     chunk)
    plane, ws, nch, ov_b, ov_w, gidx, _ = build_column_plane(
        pos, mass, box, float(r_cut), ncell, CK, W, chunk=chunk)
    out = run_column_plane(
        plane, ws, nch, ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
        chunk=chunk, eps=eps, r_s=r_s, r_cut=r_cut, split=split,
        softening=softening, box=box)
    acc = read_back(out, gidx, 3)
    return G * acc.to(pos.dtype), encode_overflow(ov_b, ov_w)


# ---------------------------------------------------------------------------
# Frozen column plans (the rung tier's interior ticks)
# ---------------------------------------------------------------------------


def freeze_column_plan(pos, mass, box: float, r_cut: float, ncell: int,
                       col_capacity: int, window: int, chunk: int = 256,
                       skin: float = 0.0) -> ColumnPlan:
    """Sort, buckets and window tables at the current positions, packaged
    for reuse at positions within skin/2 of them (:class:`ColumnPlan`,
    :func:`plan_drift_ok`)."""
    if box / ncell < r_cut - 1e-9:
        raise ValueError(f"column size {box / ncell:.3f} < r_cut {r_cut:.3f}")
    if skin > 0.0 and (box / ncell) < r_cut + 2.0 * skin:
        raise ValueError(
            f"column side {box / ncell:.3f} < r_cut + 2 skin "
            f"{r_cut + 2.0 * skin:.3f}: frozen xy bucketing would miss "
            f"drifted pairs")
    CK, _, _, W, _, chunk = plane_geometry(box, r_cut, col_capacity, window,
                                           chunk)
    return build_column_plane(pos, mass, box, r_cut, ncell, CK, W,
                              chunk=chunk, skin=skin, with_plan=True)[-1]


def plan_drift(pos, plan: ColumnPlan, box: float):
    """(n,) squared minimum-image drift of each particle from its freeze
    position, in the plan's float32."""
    d = torch.remainder(pos, box).to(plan.pos0.dtype) - plan.pos0
    d = d - box * torch.round(d * (1.0 / box))
    return torch.sum(d * d, dim=1)


def plan_drift_ok(pos, plan: ColumnPlan, box: float, skin: float):
    """0-d bool tensor: every particle is within skin/2 of its freeze
    position, the validity predicate of a :class:`ColumnPlan`."""
    return torch.max(plan_drift(pos, plan, box)) <= (0.5 * skin) ** 2


def _frozen_buf(pos, mass, plan, box: float, r_cut: float, CK: int,
                gz: int, stride: int):
    """The (ncol, stride, 4) column buffer of a frozen plan (whole-box or
    slab) at the current positions: one row gather by ``plan.src_g`` of
    the positions unwrapped against the freeze positions (within skin/2 of
    them, so possibly just outside [0, box)).  Returns (buf, is_interior
    (ncol, stride), drift): ``drift`` is the largest |z drift| of the
    particles from their freeze positions, a 0-d float32 tensor (the
    column kernels widen their reach search by it; no host sync)."""
    posw = torch.remainder(pos, box).to(torch.float32)
    d = posw - plan.pos0
    d = d - box * torch.round(d * (1.0 / box))
    drift = (torch.amax(torch.abs(d[:, 2])) if d.shape[0]
             else d.new_zeros(()))
    rows = torch.cat([plan.pos0 + d, mass.to(torch.float32)[:, None]],
                     dim=1)[plan.src_g]
    _, src_ok, is_front, is_interior, is_back = _slot_sources(
        plan.starts, plan.counts, CK, gz, stride)
    buf, _ = _rows_to_buf(rows, src_ok, is_front, is_interior, is_back, box,
                          r_cut, 1.0001 * r_cut)
    return buf, is_interior, drift


def frozen_plane(pos, mass, plan: ColumnPlan, box: float, r_cut: float,
                 ncell: int, CK: int, gz: int, stride: int):
    """The plan's plane at the current positions (:func:`_frozen_buf`).
    Returns (plane, is_interior (ncol, stride), drift): the column
    kernels take ``drift`` with the plane."""
    buf, is_interior, drift = _frozen_buf(pos, mass, plan, box, r_cut, CK,
                                          gz, stride)
    return _plane_from_buf(buf, box, ncell, stride), is_interior, drift


def p3m_short_columns_frozen(pos, mass, plan: ColumnPlan, box: float,
                             eps: float, r_s: float, r_cut: float,
                             G: float = 1.0, *, ncell: int, col_capacity: int,
                             window: int, split: str = "gaussian",
                             softening: str = "plummer", chunk: int = 256):
    """Short-range column force (K4) on a frozen plan: no sort and no
    window tables.  Returns (acc (N, 3), plan.ov)."""
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut,
                                                     col_capacity, window,
                                                     chunk)
    plane, _, drift = frozen_plane(pos, mass, plan, box, r_cut, ncell, CK,
                                   gz, stride)
    out = run_column_plane(
        plane, plan.ws, plan.nch, ncell=ncell, stride=stride, W=W,
        maxch=maxch, gz=gz, chunk=chunk, eps=eps, r_s=r_s, r_cut=r_cut,
        split=split, softening=softening, box=box, drift=drift)
    return G * read_back(out, plan.gidx, 3).to(pos.dtype), plan.ov


def active_chunk_table(act, plan: ColumnPlan, is_interior, *, ncell: int,
                       CK: int, gz: int, maxch: int, chunk: int,
                       nx: int | None = None):
    """(nch_act (ncol,) int32, cht (ncol * maxch,) int32): the number of
    256-slot chunks of each column that hold an ``act`` particle, and
    their indices, ascending, at the front of each column's row (the rest
    of the row holds maxch).  ``nx`` interior x-rows (ncell, or a slab's
    ncell / D with a :class:`LocalColumnPlan`)."""
    ncol = (ncell if nx is None else nx) * ncell
    act_slot = act[plan.src_g] & is_interior
    act_chunk = torch.any(
        act_slot[:, gz:gz + CK].reshape(ncol, maxch, chunk), dim=-1)
    nch_act = torch.sum(act_chunk, dim=1).to(torch.int32)
    iota = torch.arange(maxch, device=act.device)[None, :]
    cht = torch.sort(torch.where(act_chunk, iota, maxch), dim=1).values
    return nch_act, cht.reshape(ncol * maxch).to(torch.int32)


def p3m_short_columns_frozen_masked(pos, mass, act, plan: ColumnPlan,
                                    box: float, eps: float, r_s: float,
                                    r_cut: float, G: float = 1.0, *,
                                    ncell: int, col_capacity: int,
                                    window: int, split: str = "gaussian",
                                    softening: str = "plummer",
                                    chunk: int = 256,
                                    return_buckets: bool = False):
    """Short-range column force ON the chunks that hold an ``act``
    particle FROM all, on a frozen plan (K5): the rung tier's interior
    tick.  Rows of other chunks come back 0; the other rows of a visited
    chunk come back with their force, which the integrator's rung kick
    factors zero.  Returns (acc (N, 3), plan.ov); with ``return_buckets``
    the slot table (slots + 1, 3) before the gather (its last row 0, the
    slot of an overflowed particle), which the compact kicks gather at
    ``plan.gidx`` of their active rows only."""
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut,
                                                     col_capacity, window,
                                                     chunk)
    plane, is_interior, drift = frozen_plane(pos, mass, plan, box, r_cut,
                                             ncell, CK, gz, stride)
    nch_act, cht = active_chunk_table(act, plan, is_interior, ncell=ncell,
                                      CK=CK, gz=gz, maxch=maxch, chunk=chunk)
    out = run_column_plane_masked(
        plane, plan.ws, nch_act, cht, ncell=ncell, stride=stride, W=W,
        maxch=maxch, gz=gz, chunk=chunk, eps=eps, r_s=r_s, r_cut=r_cut,
        split=split, softening=softening, box=box, drift=drift)
    if return_buckets:
        return G * read_back(out, None, 3).to(pos.dtype), plan.ov
    return G * read_back(out, plan.gidx, 3).to(pos.dtype), plan.ov


# ---------------------------------------------------------------------------
# The slab tier of the domain decomposition
# ---------------------------------------------------------------------------




def _local_column_buf(pos, mass, d: int, *, box: float, r_cut: float,
                      ncell: int, nxl: int, CK: int, gz: int, stride: int,
                      zmargin: float):
    """Shard d's z-sorted (x, y) columns of the nxl x-rows it owns, in the
    slot layout of :func:`build_column_plane`: the (nxl * ncell, stride,
    4) buffer before the y ring and the halo exchange, and what the window
    tables, the slot map and a frozen plan take from the sort.  ``zmargin``
    is the wrap margin of the ghost bands and their demand (a frozen plan
    widens it by skin/2)."""
    C = pos.shape[0]
    dev = pos.device
    f32 = torch.float32
    ncol_l = nxl * ncell
    posw = torch.remainder(pos, box).to(f32)
    massf = mass.to(f32)
    valid = massf > 0
    cx = torch.clamp((posw[:, 0] * (ncell / box)).to(torch.int32), 0,
                     ncell - 1).to(torch.int64)
    cy = torch.clamp((posw[:, 1] * (ncell / box)).to(torch.int32), 0,
                     ncell - 1).to(torch.int64)
    cxl = cx - d * nxl
    resident = valid & (cxl >= 0) & (cxl < nxl)
    col = torch.where(resident, cxl * ncell + cy,
                      torch.full_like(cxl, ncol_l))
    order = _col_z_order(col, posw[:, 2], box)
    pos_s = posw[order]
    mass_s = massf[order]
    col_s = col[order]

    cols = torch.arange(ncol_l, device=dev)
    starts = torch.searchsorted(col_s, cols, right=False)
    ends = torch.searchsorted(col_s, cols, right=True)
    counts = ends - starts
    rank = torch.arange(C, device=dev) - starts[torch.clamp(col_s, 0,
                                                            ncol_l - 1)]
    ok = (rank < CK) & (col_s < ncol_l)
    overflow_b = torch.sum(resident) - torch.sum(ok)

    src, src_ok, is_front, is_interior, is_back = _slot_sources(
        starts, counts, CK, gz, stride)
    src_c = torch.clamp(src, 0, max(C - 1, 0))
    rows = torch.cat([pos_s, mass_s[:, None]], dim=1)[src_c]
    buf, z_raw = _rows_to_buf(rows, src_ok, is_front, is_interior, is_back,
                              box, r_cut, zmargin)
    nb = torch.sum(is_interior & (z_raw <= zmargin), dim=1)
    nf = torch.sum(is_interior & (z_raw >= box - zmargin), dim=1)
    ov_g = (torch.sum(torch.clamp_min(nb - gz, 0))
            + torch.sum(torch.clamp_min(nf - gz, 0)))
    return dict(buf=buf, posw=posw, pos_s=pos_s, starts=starts,
                counts=counts, order=order, src_c=src_c, ok=ok, rank=rank,
                cxl=cxl, cy=cy, overflow_b=overflow_b + ov_g,
                nonresident=torch.sum(valid) - torch.sum(resident))


def _local_plane_from_buf(bufs: list, *, box: float, r_cut: float,
                          ncell: int, group, stride: int) -> list:
    """Every shard's (8, (nxl + 2) * P * stride) SoA plane from its column
    buffer: the y ghost ring (local wrap, +-box baked into y), then the
    two ghost x-rows, the neighbours' edge rows, whole y-padded rows moved
    by a ppermute each way with -box / +box added to x where the ring
    wraps.  The routing is fixed: only the rows' data depend on the
    positions, so a frozen plan re-assembles its plane with it every tick.
    Returns one (plane, plane4 ((nxl + 2) * P * stride, 4)) a shard."""
    D = group.size
    nxl = ncell // D
    P = ncell + 2
    p5s = []
    for buf in bufs:
        dev, f32 = buf.device, buf.dtype
        grid4 = buf.reshape(nxl, ncell, stride, 4)
        wrap = (torch.arange(P, device=dev) - 1) % ncell
        padded = grid4[:, wrap].clone()
        zero = torch.zeros((), dtype=f32, device=dev)
        for edge, delta in ((0, -box), (P - 1, box)):
            lo = padded[:, edge]
            lo[..., 1] += torch.where(lo[..., 3] > 0, zero + delta, zero)
        defaults = torch.tensor([-8.0 * r_cut, -8.0 * r_cut,
                                 box + 3.0 * r_cut, 0.0], dtype=f32,
                                device=dev)
        zero_row = defaults.expand(1, P, stride, 4)
        p5s.append(torch.cat([zero_row, padded, zero_row], dim=0))
    from_left = group.ppermute([p5[nxl] for p5 in p5s], +1)
    from_right = group.ppermute([p5[1] for p5 in p5s], -1)
    out = []
    for d, p5 in enumerate(p5s):
        p5 = p5.clone()
        for row, halo, delta in ((0, from_left[d], -box if d == 0 else 0.0),
                                 (nxl + 1, from_right[d],
                                  box if d == D - 1 else 0.0)):
            h = halo.clone()
            h[..., 0] += torch.where(h[..., 3] > 0, delta, 0.0)
            p5[row] = h
        plane4 = p5.reshape((nxl + 2) * P * stride, 4)
        plane = torch.cat([plane4.T, torch.zeros_like(plane4.T)],
                          dim=0).contiguous()
        out.append((plane, plane4))
    return out


def _local_windows(plane4, q: dict, *, r_cut: float, ncell: int, nxl: int,
                   CK: int, stride: int, W: int, maxch: int, chunk: int,
                   skin: float = 0.0):
    """(ws (nxl * ncell * 9 * maxch,) int32, nch int32, window misses) of
    a slab's plane: a window starts one 128-slot fence below the first
    fence above the chunk's reach (z - r_cut - skin), read from the padded
    plane after the halo exchange, as in the JAX package."""
    dev = plane4.device
    P = ncell + 2
    ncol_l = nxl * ncell
    zcols = plane4[:, 2].reshape((nxl + 2) * P, stride)
    fence = zcols[:, ::128]
    starts, counts, pos_s = q["starts"], q["counts"], q["pos_s"]
    C = pos_s.shape[0]
    cnt_ck = torch.clamp_max(counts, CK)
    ch = torch.arange(maxch, device=dev)
    nch = -(-cnt_ck // chunk)
    idx0 = starts[:, None] + ch[None, :] * chunk
    last = starts[:, None] + cnt_ck[:, None] - 1
    hi_n = max(C - 1, 0)
    zmin = pos_s[torch.clamp(idx0, 0, hi_n), 2]
    zmax = pos_s[torch.clamp(torch.minimum(idx0 + chunk - 1, last), 0,
                             hi_n), 2]
    chunk_ok = ch[None, :] < nch[:, None]
    qlo = (zmin - r_cut - skin)[:, :, None]
    qhi = (zmax + r_cut + skin)[:, :, None]
    cols = torch.arange(ncol_l, device=dev)
    ic_x, ic_y = cols // ncell, cols % ncell
    ws_list = []
    ov_w = torch.zeros((), dtype=torch.int64, device=dev)
    for o2 in range(9):
        nc = (ic_x + 1 + o2 // 3 - 1) * P + (ic_y + 1 + o2 % 3 - 1)
        cnt_lo = torch.sum(fence[nc][:, None, :] <= qlo, dim=-1)
        start = torch.clamp(torch.clamp_min(cnt_lo - 1, 0) * 128, 0,
                            stride - W)
        hi_exact = torch.sum(zcols[nc][:, None, :] < qhi, dim=-1)
        ov_w = ov_w + torch.sum(torch.where(
            chunk_ok, torch.clamp_min(hi_exact - (start + W), 0), 0))
        ws_list.append(start)
    ws = torch.stack(ws_list, dim=1).reshape(ncol_l * 9 * maxch)
    return ws.to(torch.int32), nch.to(torch.int32), ov_w


def _local_gidx(q: dict, *, ncell: int, nxl: int, gz: int, stride: int):
    """(C,) int64 each row's padded slot; the sentinel (nxl + 2) * P *
    stride for rows not stored (non-resident or beyond CK)."""
    P = ncell + 2
    pc = (torch.clamp(q["cxl"], 0, nxl - 1) + 1) * P + (q["cy"] + 1)
    sentinel = (nxl + 2) * P * stride
    order = q["order"]
    gidx_s = torch.where(q["ok"], pc[order] * stride + gz + q["rank"],
                         torch.full_like(q["rank"], sentinel))
    gidx = torch.empty(order.numel(), dtype=torch.int64, device=order.device)
    gidx[order] = gidx_s
    return gidx


def build_local_column_plane(pos: list, mass: list, *, box: float,
                             r_cut: float, ncell: int, group,
                             col_capacity: int, window: int,
                             chunk: int = 256):
    """Slab sibling of :func:`build_column_plane` for the domain
    decomposition, on every shard of ``group``: shard d owns the nxl =
    ncell / D x-rows [d nxl, (d + 1) nxl) of full-height z columns.  z
    (ghost copies at each column end) and y (the local wrap ring) are
    periodic as in the whole-box plane; the two ghost x-rows are the
    neighbours' edge rows (:func:`_local_plane_from_buf`).  The window
    starts are taken after the halo exchange, from the 128-slot fences of
    the padded columns, as in the JAX package.

    Returns one tuple a shard: (plane (8, (nxl + 2) * P * stride), ws
    (nxl * ncell * 9 * maxch,) int32, nch (nxl * ncell,) int32,
    overflow_bucket, overflow_window, gidx (C,) int64, counts (nxl *
    ncell,) int32): overflow_bucket counts resident particles beyond CK
    and z-ghost demand beyond gz, overflow_window the window misses;
    ``gidx`` maps resident rows to their padded slot and every other row
    to the sentinel; ``counts`` is min(raw, CK), the slab deposit's mask."""
    D = group.size
    if ncell % D:
        raise ValueError(f"ncell={ncell} does not split over {D} shards")
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut,
                                                     col_capacity, window,
                                                     chunk)
    nxl = ncell // D
    geo = dict(ncell=ncell, nxl=nxl, CK=CK, stride=stride)
    parts = [_local_column_buf(p, m, d, box=box, r_cut=float(r_cut), gz=gz,
                               zmargin=1.0001 * float(r_cut), **geo)
             for d, (p, m) in enumerate(zip(pos, mass))]
    planes = _local_plane_from_buf([q["buf"] for q in parts], box=box,
                                   r_cut=float(r_cut), ncell=ncell,
                                   group=group, stride=stride)
    out = []
    for q, (plane, plane4) in zip(parts, planes):
        ws, nch, ov_w = _local_windows(plane4, q, r_cut=float(r_cut), W=W,
                                       maxch=maxch, chunk=chunk, **geo)
        gidx = _local_gidx(q, ncell=ncell, nxl=nxl, gz=gz, stride=stride)
        out.append((plane, ws, nch, q["overflow_b"], ov_w, gidx,
                    torch.clamp_max(q["counts"], CK).to(torch.int32)))
    return out


def p3m_short_columns_local(pos: list, mass: list, *, box: float, eps: float,
                            r_s: float, r_cut: float, G: float = 1.0,
                            ncell: int, group, col_capacity: int,
                            window: int, split: str = "gaussian",
                            softening: str = "plummer", chunk: int = 256):
    """The column tier's short-range force on every shard's slab: K4 on
    each local plane of :func:`build_local_column_plane` (nx = ncell / D
    interior x-rows).  Returns (acc list (C, 3), overflow list): each
    shard's field-encoded word (bucket/ghost * 65536 + window misses),
    not yet reduced over the shards."""
    if box / ncell < r_cut - 1e-9:
        raise ValueError(f"column size {box / ncell:.3f} < r_cut {r_cut:.3f}")
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut,
                                                     col_capacity, window,
                                                     chunk)
    nxl = ncell // group.size
    accs, ovs = [], []
    for p, (plane, ws, nch, ov_b, ov_w, gidx, _) in zip(
            pos, build_local_column_plane(
                pos, mass, box=box, r_cut=float(r_cut), ncell=ncell,
                group=group, col_capacity=CK, window=W, chunk=chunk)):
        out = run_column_plane(
            plane, ws, nch, ncell=ncell, stride=stride, W=W, maxch=maxch,
            gz=gz, chunk=chunk, eps=eps, r_s=r_s, r_cut=r_cut, split=split,
            softening=softening, nx=nxl, box=box)
        accs.append(G * read_back(out, gidx, 3).to(p.dtype))
        ovs.append(encode_overflow(ov_b, ov_w))
    return accs, ovs


# ---------------------------------------------------------------------------
# Frozen local column plans (the domain rung tier's interior ticks)
# ---------------------------------------------------------------------------


class LocalColumnPlan(NamedTuple):
    """Slab sibling of :class:`ColumnPlan`: everything about one shard's
    local column plane that does not depend on the positions, from
    :func:`freeze_local_column_plan`.  It stays valid while every local
    particle is within skin/2 (minimum image) of ``pos0`` and the shard's
    particle set is the one it was frozen with (no :func:`slab_exchange
    <nbody_torch.distributed.domain.slab_exchange>` in between: the domain
    rung tier freezes at the step boundary, right after the exchange, and
    migrates again only at the next boundary).  The x-halo rows are
    re-assembled from the neighbours' current positions each tick by the
    fixed ppermutes of :func:`_local_plane_from_buf`.

    ``ov`` is the freeze-time field-encoded word.  Unlike the JAX
    package's, its bucket field also counts the shard's massive rows that
    lie outside its slab: such a row has no slot and would get no force
    (an exchange that disagrees with the freeze's cut)."""

    pos0: torch.Tensor    # (C, 3) float32 wrapped positions at freeze
    src_g: torch.Tensor   # (nxl * ncell, stride) int64 slot -> local row
    starts: torch.Tensor  # (nxl * ncell,) int64 into the frozen sort order
    counts: torch.Tensor  # (nxl * ncell,) int64 raw per-column counts
    ws: torch.Tensor      # (nxl * ncell * 9 * maxch,) int32 window starts
    nch: torch.Tensor     # (nxl * ncell,) int32
    gidx: torch.Tensor    # (C,) int64 local row -> padded slot
    ov: torch.Tensor      # 0-d int64 field-encoded freeze-time overflow


def freeze_local_column_plan(pos: list, mass: list, *, box: float,
                             r_cut: float, ncell: int, group,
                             col_capacity: int, window: int,
                             chunk: int = 256,
                             skin: float = 0.0) -> list:
    """Every shard's :class:`LocalColumnPlan` at the current positions:
    the sort of :func:`build_local_column_plane`, its ghost bands and
    their demand with the wrap margin widened by skin/2 and its window
    tables with the thresholds widened by the skin (on the table plane,
    after the halo exchange).  One plan a shard."""
    if box / ncell < r_cut - 1e-9:
        raise ValueError(f"column size {box / ncell:.3f} < r_cut {r_cut:.3f}")
    if skin > 0.0 and (box / ncell) < r_cut + 2.0 * skin:
        raise ValueError(
            f"column side {box / ncell:.3f} < r_cut + 2 skin "
            f"{r_cut + 2.0 * skin:.3f}: frozen xy bucketing would miss "
            f"drifted pairs")
    D = group.size
    if ncell % D:
        raise ValueError(f"ncell={ncell} does not split over {D} shards")
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut,
                                                     col_capacity, window,
                                                     chunk)
    nxl = ncell // D
    geo = dict(ncell=ncell, nxl=nxl, CK=CK, stride=stride)
    parts = [_local_column_buf(p, m, d, box=box, r_cut=float(r_cut), gz=gz,
                               zmargin=1.0001 * float(r_cut) + 0.5 * skin,
                               **geo)
             for d, (p, m) in enumerate(zip(pos, mass))]
    tables = _local_plane_from_buf([q["buf"] for q in parts], box=box,
                                   r_cut=float(r_cut), ncell=ncell,
                                   group=group, stride=stride)
    plans = []
    for q, (_, plane4) in zip(parts, tables):
        ws, nch, ov_w = _local_windows(plane4, q, r_cut=float(r_cut), W=W,
                                       maxch=maxch, chunk=chunk, skin=skin,
                                       **geo)
        ov_b = q["overflow_b"] + q["nonresident"]
        plans.append(LocalColumnPlan(
            pos0=q["posw"], src_g=q["order"][q["src_c"]], starts=q["starts"],
            counts=q["counts"], ws=ws, nch=nch,
            gidx=_local_gidx(q, ncell=ncell, nxl=nxl, gz=gz, stride=stride),
            ov=encode_overflow(ov_b, ov_w)))
    return plans


def local_plan_stale(pos, plan: LocalColumnPlan, box: float, skin: float):
    """0-d count of one shard's particles beyond skin/2 (minimum image) of
    their freeze positions: the plan-staleness channel (callers take the
    max over shards and ticks)."""
    return torch.sum(plan_drift(pos, plan, box) > (0.5 * skin) ** 2)


def p3m_local_columns_frozen_masked(pos: list, mass: list, act: list,
                                    plans: list, *, box: float, eps: float,
                                    r_s: float, r_cut: float, G: float = 1.0,
                                    ncell: int, group, col_capacity: int,
                                    window: int, split: str = "gaussian",
                                    softening: str = "plummer",
                                    chunk: int = 256):
    """The domain rung tier's interior tick on the shards' frozen plans
    (K5's slab site): one row gather a shard and the fixed halo
    ppermutes re-assemble each plane at the current positions (no sort,
    no window tables, no exchange), the chunks that hold an ``act``
    target make each shard's chunk table, and K5 runs once a shard with
    nx = ncell / D.  Returns (acc list (C, 3), the plans' words): rows of
    chunks without an active target come back 0, and the other rows of a
    visited chunk with their force, which the rung kick factors zero."""
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut,
                                                     col_capacity, window,
                                                     chunk)
    nxl = ncell // group.size
    frozen = [_frozen_buf(p, m, plan, box, float(r_cut), CK, gz, stride)
              for p, m, plan in zip(pos, mass, plans)]
    planes = _local_plane_from_buf([b for b, _, _ in frozen], box=box,
                                   r_cut=float(r_cut), ncell=ncell,
                                   group=group, stride=stride)
    # a slab's plane holds its neighbours' edge rows: the largest drift
    # of the shards
    drifts = group.pmax([dr for _, _, dr in frozen])
    accs = []
    for p, a, plan, (_, interior, _), (plane, _), drift in zip(
            pos, act, plans, frozen, planes, drifts):
        nch_act, cht = active_chunk_table(a, plan, interior, ncell=ncell,
                                          CK=CK, gz=gz, maxch=maxch,
                                          chunk=chunk, nx=nxl)
        out = run_column_plane_masked(
            plane, plan.ws, nch_act, cht, ncell=ncell, stride=stride, W=W,
            maxch=maxch, gz=gz, chunk=chunk, eps=eps, r_s=r_s, r_cut=r_cut,
            split=split, softening=softening, nx=nxl, box=box, drift=drift)
        accs.append(G * read_back(out, plan.gidx, 3).to(p.dtype))
    return accs, [plan.ov for plan in plans]
