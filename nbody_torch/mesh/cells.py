"""Cell lists: fixed-capacity spatial buckets for short-range pair sums.

Counterpart of :mod:`nbody.mesh.cells`: particle -> cell id -> stable
argsort by cell -> rank within the cell -> an (ncell^3, capacity) bucket
table.  Padding slots hold the sentinel index ``n``; ``overflow`` counts
the particles whose cell was full (their short-range force would be
dropped, which the driver's capacity heal repairs).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CellList(NamedTuple):
    indices: torch.Tensor  # (ncell^3, capacity) int64; padding slots hold n
    counts: torch.Tensor  # (ncell^3,) int64 true occupancy
    overflow: torch.Tensor  # 0-d int64: particles that did not fit
    # (n,) int64 bucket slot of each particle (cid * capacity + rank);
    # overflowed and excluded particles hold ncell^3 * capacity
    slots: torch.Tensor


def cell_capacity(n: int, ncell: int, headroom: float = 1.0,
                  minimum: int = 8) -> int:
    """Static cell-list capacity: mean occupancy + 5 sigma Poisson tail
    (x headroom), rounded up to a multiple of 8."""
    mean = n / ncell**3
    cap = max(minimum, int(headroom * (mean + 5.0 * mean**0.5) + 2))
    return -(-cap // 8) * 8


def cell_ids(pos, box: float, ncell: int):
    """(n,) int64 cell id (cx * ncell + cy) * ncell + cz of the positions
    folded into [0, box), in ``pos``'s dtype."""
    s = torch.remainder(pos, box) * (ncell / box)
    c = torch.clamp(s.to(torch.int32), 0, ncell - 1).to(torch.int64)
    return (c[:, 0] * ncell + c[:, 1]) * ncell + c[:, 2]


def build_cell_list(pos, box: float, ncell: int, capacity: int,
                    valid=None) -> CellList:
    """Bucket particles into an (ncell,)^3 grid of side box/ncell.

    ``pos`` may be unwrapped.  ``valid`` (n,) bool excludes particles
    entirely (sentinel slot, no bucket space, not counted as overflow):
    the rung tier's active-target planes.  The sort is stable, as
    ``jnp.argsort`` is, so slots equal the JAX package's.  B members at
    once, ``pos`` (B, n, 3) (``valid`` (B, n)), give each field with a
    leading member axis (``overflow`` (B,)), each member's equal to its
    own list: one stable sort of all members' keys, a member's cells
    after the previous member's."""
    one = pos.ndim == 2
    if one:
        pos = pos[None]
        valid = None if valid is None else valid[None]
    B, n = pos.shape[0], pos.shape[1]
    dev = pos.device
    C3 = ncell**3
    cid = cell_ids(pos.reshape(B * n, 3), box, ncell)
    if valid is not None:
        # excluded particles sort past every real cell and never fit
        cid = torch.where(valid.reshape(-1), cid, torch.full_like(cid, C3))
    member = torch.arange(B * n, device=dev) // max(n, 1)
    key = member * (C3 + 1) + cid
    order = torch.argsort(key, stable=True)
    cid_s = cid[order]
    counts = torch.bincount(key, minlength=B * (C3 + 1)).reshape(
        B, C3 + 1)[:, :C3]
    starts = (torch.cumsum(counts, 1) - counts).reshape(-1)
    # the sorted rows of member b are rows b n .. b n + n - 1
    rank = (torch.arange(B * n, device=dev) - member * n
            - starts[member * C3 + torch.clamp_max(cid_s, C3 - 1)])
    real = cid_s < C3
    ok = (rank < capacity) & real
    slot_s = torch.where(ok, cid_s * capacity + rank,
                         torch.full_like(rank, C3 * capacity))
    table = torch.full((B, C3 * capacity), n, dtype=torch.int64, device=dev)
    table[member[ok], slot_s[ok]] = (order - member * n)[ok]
    slots = torch.empty(B * n, dtype=torch.int64, device=dev)
    slots[order] = slot_s
    out = CellList(indices=table.reshape(B, C3, capacity), counts=counts,
                   overflow=torch.sum((~ok & real).reshape(B, n), dim=1),
                   slots=slots.reshape(B, n))
    return CellList(*(t[0] for t in out)) if one else out
