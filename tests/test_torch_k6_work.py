"""K6's deal of the work, on the CPU: the plain counterparts of the rules
the redesigned kernel follows (nbody_torch/forces/csrc/p3m_cells.cu).

* ``k6_geometry``: the warps a block at the four sites' shapes on a card
  of 132 SMs;
* ``k6_work`` / ``k6_items``: a target cell's targets over the lanes and
  warps of its block lose no target and name none twice in a share, and
  the shares' partial sums fit the block's W x 32 slots;
* ``cell_plane_ordered``: the sum dealt out as the kernel deals it (tiles
  of 32 sources of one cell to the shares in turn, a target's L lanes
  taking every L-th source) equals ``cell_plane_plain`` and the JAX
  package's cell kernel (interpret mode) on float64 copies of one plane,
  to KERNEL_REL_L2, as tests/test_torch_cells.py holds the plain version:
  on uniform and clustered sets, a cell filled to its capacity and a
  two-plane set of a few targets scattered over many cells.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.forces import p3m as jp3m
from nbody_torch.forces import p3m as tp3m

# float64 sums of the same pairs in another order
KERNEL_REL_L2 = 1e-9
BOX, EPS, R_S = 100.0, 0.3, 4.0
NCELL = 4
R_CUT = 0.999 * BOX / NCELL
# p3m_cells_info of a card of 132 SMs: tile, SMs, resident blocks an SM
# at 1, 2, 4, 8 and 16 warps a block (the H100's 32 blocks an SM, and 32
# warps at 64 registers a thread)
INFO_132 = (32, 132, 32, 16, 8, 4, 2)


@pytest.mark.parametrize("nx,ncell,warps", [
    (2, 8, 16),    # the slab site: 4 shards of 2 x 8^2 cells (32^3)
    (5, 20, 8),    # the replicated-grid site: 4 shards of 5 x 20^2 (64^3)
    (11, 11, 8),   # the one-device site at 32^3 (and its two-plane form)
    (22, 22, 1),   # the one-device site at 64^3
])
def test_k6_geometry_at_the_sites(nx, ncell, warps):
    geo = tp3m.k6_geometry(nx, ncell, INFO_132)
    assert geo.blocks == nx * ncell * ncell and geo.warps == warps
    assert geo.sms == 132
    assert geo.blocks_per_sm == INFO_132[2 + tp3m.K6_WARPS.index(warps)]
    # the rule: the most warps whose blocks make at most K6_WAVES waves
    fit = [w for w, b in zip(tp3m.K6_WARPS, INFO_132[2:])
           if geo.blocks <= tp3m.K6_WAVES * 132 * b]
    assert warps == (fit[-1] if fit else tp3m.K6_WARPS[0])


@pytest.mark.parametrize("warps", tp3m.K6_WARPS)
def test_k6_items_lose_no_target(warps):
    for count in range(0, 257):
        target, sub, share = tp3m.k6_items(count, warps)
        work = tp3m.k6_work(count, warps)
        if count == 0:
            assert target.shape[0] == 0
            continue
        assert int(target.max()) == count - 1
        assert bool((target >= -1).all())
        for s in range(work.shares):
            held = target[share == s]
            lanes = sub[share == s]
            live = held >= 0
            # each target held by exactly L lanes of the share, once each
            pairs = held[live] * work.lanes + lanes[live]
            assert pairs.numel() == count * work.lanes
            assert torch.unique(pairs).numel() == pairs.numel()
            assert bool((lanes[live] < work.lanes).all())
        # several shares: every item's partial sums have a slot of the
        # block's W x 32
        if work.shares > 1:
            assert target.shape[0] <= warps
        if count <= 32:
            assert count * work.lanes <= 32 < count * (work.lanes + 1)


def _plane(kind: str, seed: int, capacity: int = 96, valid=None):
    rng = np.random.default_rng(seed)
    n = 900
    pos = rng.uniform(0.0, BOX, (n, 3))
    if kind == "clustered":
        pos[: n // 2] = rng.normal(0.6 * BOX, 3.0, (n // 2, 3))
    elif kind == "full":
        # cell (0, 0, 0) filled to its capacity, the rest outside it
        c = BOX / NCELL
        pos[(pos < c).all(axis=1), 0] += c
        pos[:capacity] = rng.uniform(0.3 * c, 0.7 * c, (capacity, 3))
    mass = rng.uniform(0.5, 2.0, n)
    out = tp3m.build_padded_plane(
        torch.tensor(pos, dtype=torch.float32),
        torch.tensor(mass, dtype=torch.float32), BOX, R_CUT, NCELL,
        capacity, valid=None if valid is None else torch.tensor(valid))
    assert int(out[1]) == 0
    return out


def _real_slots(K):
    cells = tp3m._real_cells(NCELL, NCELL, "cpu")
    return (cells[:, None] * K + torch.arange(K)[None, :]).reshape(-1)


@pytest.mark.parametrize("kind,warps", [("uniform", 1), ("uniform", 4),
                                        ("clustered", 16), ("full", 8),
                                        ("sparse two-plane", 8),
                                        ("sparse two-plane", 2)])
def test_kernel_order_matches_plain_and_jax(kind, warps):
    kw = dict(nx=NCELL, ncell=NCELL, eps2=EPS**2, r_s=R_S, r_cut=R_CUT,
              split="spline", softening="spline")
    if kind == "sparse two-plane":
        plane, _, K, _, counts = _plane("uniform", 11)
        act = np.zeros(900, bool)
        act[np.random.default_rng(12).choice(900, 9, replace=False)] = True
        plane_i, _, K_i, _, counts_i = _plane("uniform", 11, 32, act)
        real = counts_i[tp3m._real_cells(NCELL, NCELL, "cpu")]
        assert int(real.max()) <= 3 and int((real > 0).sum()) >= 6
        two = dict(plane_j=plane.double(), K_j=K, counts_j=counts)
        got = tp3m.cell_plane_ordered(plane_i.double(), counts_i, K=K_i,
                                      warps=warps, **two, **kw)
        plain = tp3m.cell_plane_plain(plane_i.double(), counts_i, K=K_i,
                                      **two, **kw)
        want = jp3m.run_cell_plane(jnp.asarray(plane_i.double().numpy()),
                                   K=K_i, plane_j=jnp.asarray(
                                       plane.double().numpy()), K_j=K, **kw)
        slots = _real_slots(K_i)
    else:
        cap = {"full": 128, "clustered": 512}.get(kind, 96)
        plane, _, K, _, counts = _plane(kind, 13, cap)
        if kind == "full":
            assert int(counts.max()) == cap == K
        got = tp3m.cell_plane_ordered(plane.double(), counts, K=K,
                                      warps=warps, **kw)
        plain = tp3m.cell_plane_plain(plane.double(), counts, K=K, **kw)
        want = jp3m.run_cell_plane(jnp.asarray(plane.double().numpy()), K=K,
                                   **kw)
        slots = _real_slots(K)
    g = got[:3, slots].numpy()
    assert float(plain.norm()) > 0
    assert np.linalg.norm(g - plain[:3, slots].numpy()) <= (
        KERNEL_REL_L2 * np.linalg.norm(plain[:3, slots].numpy()))
    w = np.asarray(want)[:3, slots.numpy()]
    assert np.linalg.norm(g - w) <= KERNEL_REL_L2 * np.linalg.norm(w)
    assert float(got[3:].abs().max()) == 0.0
