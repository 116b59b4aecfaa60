"""K1's spatial order and cull (nbody_torch.forces.p3m.k1_plan), on the CPU.

The CUDA kernel sorts the particles along a Hilbert curve, gives each
32-source tile a bounding box and visits only the tiles within reach of a
target group's box, taking one image a tile where only one is in reach.
Its plain counterpart computes the same order, boxes, visit mask and
images with the device code's arithmetic (float32).  Here: the mask misses
no pair inside r_cut and names the right image on uniform, clustered
(Plummer-like) and periodic-edge-straddling sets; the sum over the listed
tile pairs alone equals p3m_short_plain in float64 and the JAX K1 in
interpret mode; a cull narrowed by r_cut / 2 loses pairs; the launch
shape of both forms on the card's 132 SMs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.forces import p3m as jp3m
from nbody_torch.forces import p3m as tp3m

VARIANTS = [(s, k) for s in ("gaussian", "spline") for k in ("plummer", "spline")]
# float64 against float64 with the same algebra: only summation order
# differs (tests/test_torch_p3m.py)
F64_RTOL = 1e-10
# the sum over the listed tiles against the dense sum, both in torch
# float64: the same pairs, in the same order, masked by a multiply
CULL_RTOL = 1e-12
# a dropped pair inside r_cut moves its target's force by O(1e-2) of the
# RMS force: chip_smoke.py's per-target limit
TARGET_TOL = 1e-3


def _set(kind: str, n: int, box: float, seed: int = 0):
    """Positions (float32, as the card holds them) and masses."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pos = rng.uniform(0.0, box, (n, 3))
    elif kind == "clustered":
        # Plummer spheres of scale radius 0.02 box around 6 centres
        c = rng.uniform(0.0, box, (6, 3))
        u = rng.uniform(1e-3, 0.999, n)
        r = 0.02 * box / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pos = (c[rng.integers(0, 6, n)] + np.minimum(r, 0.3 * box)[:, None]
               * v) % box
    else:  # a slab and a clump across the periodic edges, and at box
        pos = rng.uniform(0.0, box, (n, 3))
        pos[: n // 2, 0] = rng.normal(0.0, 0.02 * box, n // 2) % box
        pos[n // 2:, :] = rng.normal(0.0, 0.05 * box, (n - n // 2, 3)) % box
        pos[:8] = box * np.array([1.0, 0.0, 1.0 - 1e-7])
    pos = pos.astype(np.float32).astype(np.float64)
    return pos, rng.uniform(0.5, 1.5, n)


def _inside_pairs(plan, n: int, box: float, r_cut: float):
    """(i, j, image) of every sorted pair closer than r_cut: the image k of
    j (x_j + k box) that is the nearest, per axis."""
    p = plan.pos[:n].double()
    d = p[None, :, :] - p[:, None, :]
    k = -torch.round(d / box)
    d = d + box * k
    i, j = torch.nonzero((d * d).sum(-1) < r_cut**2, as_tuple=True)
    return i, j, k[i, j]


@pytest.mark.parametrize("kind", ["uniform", "clustered", "edge"])
@pytest.mark.parametrize("r_frac", [0.02, 0.088, 0.25, 0.4999])
def test_cull_misses_no_pair(kind, r_frac):
    """Every pair inside r_cut lies in a visited (group, tile) pair, and
    where the tile takes one image that image is the pair's nearest; at
    r_cut / box 0.02, the P3M site's (0.088), the slices' threshold (0.25)
    and the Ewald site's (0.4999).  Below the P3M site's r_cut the plan
    visits under half the pairs even at this small N."""
    n, box = 2500, 100.0
    r_cut = r_frac * box
    pos, mass = _set(kind, n, box)
    plan = tp3m.k1_plan(torch.tensor(pos, dtype=torch.float32),
                        torch.tensor(mass, dtype=torch.float32), box, r_cut)
    i, j, k = _inside_pairs(plan, n, box, r_cut)
    g, t = i // 32, j // tp3m.K1_TILE
    assert bool(plan.visit[g, t].all())
    ok = plan.rint[g, t] | (plan.image[g, t].double() == k).all(dim=-1)
    assert bool(ok.all())
    if r_frac < 0.1 and kind == "uniform":
        assert tp3m.k1_visits(plan) < 0.5 * n * n


def test_cull_at_the_default_run_shape():
    """At [3]'s shape (32,768 uniform particles, box 500, r_cut 43.95) the
    plan's visits are a few percent of the dense pairs, no tile needs rint
    and the worst group visits under 10% of the tiles."""
    n, box = 32768, 500.0
    r_cut = 4.5 * 1.25 * box / 64
    g = torch.Generator().manual_seed(1)
    pos = (torch.rand((n, 3), generator=g, dtype=torch.float64) * box).float()
    plan = tp3m.k1_plan(pos, torch.ones(n), box, r_cut)
    assert tp3m.k1_visits(plan) < 0.07 * n * n
    assert not bool(plan.rint.any())
    assert int(plan.visit.sum(dim=1).max()) < 0.1 * plan.visit.shape[1]


@pytest.mark.parametrize("split,softening", VARIANTS)
@pytest.mark.parametrize("kind", ["clustered", "edge"])
def test_culled_sum_is_the_dense_sum(split, softening, kind):
    """The sum over the listed tile pairs alone (plan from float32
    positions, sum in float64) equals the dense plain version."""
    n, box, eps = 3001, 100.0, 0.3
    r_cut = 0.088 * box
    r_s = r_cut / 4.5
    pos, mass = _set(kind, n, box, seed=1)
    plan = tp3m.k1_plan(torch.tensor(pos, dtype=torch.float32),
                        torch.tensor(mass, dtype=torch.float32), box, r_cut)
    tpos, tmass = torch.tensor(pos), torch.tensor(mass)
    want = tp3m.p3m_short_plain(tpos, tmass, box, eps, r_s, r_cut, G=2.0,
                                split=split, softening=softening)
    got = tp3m.p3m_short_culled_plain(tpos, tmass, box, eps, r_s, r_cut,
                                      plan, G=2.0, split=split,
                                      softening=softening)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= CULL_RTOL, err


@pytest.mark.parametrize("split,softening", VARIANTS)
def test_culled_and_plain_match_jax_kernel(split, softening):
    """The culled sum and the plain version against the JAX Pallas K1 in
    interpret mode (N = 1,200, not a multiple of any tile)."""
    box, eps = 100.0, 0.3
    r_cut = 13.5
    r_s = 3.0
    pos, mass = _set("clustered", 1200, box, seed=2)
    want = jp3m.p3m_short_acc(jnp.asarray(pos), jnp.asarray(mass), box, eps,
                              r_s, r_cut, G=2.0, split=split,
                              softening=softening)
    want = np.asarray(want)
    tpos, tmass = torch.tensor(pos), torch.tensor(mass)
    plan = tp3m.k1_plan(tpos.float(), tmass.float(), box, r_cut)
    for got in (tp3m.p3m_short_culled_plain(tpos, tmass, box, eps, r_s,
                                            r_cut, plan, G=2.0, split=split,
                                            softening=softening),
                tp3m.p3m_short_acc(tpos, tmass, box, eps, r_s, r_cut, G=2.0,
                                   split=split, softening=softening)):
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= F64_RTOL, err


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
def test_planted_narrow_cull_is_caught(kind):
    """A cull narrowed by r_cut / 2 (the ablation's planted fault) drops
    pairs inside r_cut, and the per-target error it leaves is far above
    the per-target limit; the relative L2 over all targets is smaller."""
    n, box, eps = 2500, 100.0, 0.3
    r_cut = 0.088 * box
    r_s = r_cut / 4.5
    pos, mass = _set(kind, n, box, seed=3)
    fpos, fmass = (torch.tensor(pos, dtype=torch.float32),
                   torch.tensor(mass, dtype=torch.float32))
    plan = tp3m.k1_plan(fpos, fmass, box, r_cut,
                        reach=tp3m.k1_reach(box, r_cut) - r_cut / 2)
    i, j, _ = _inside_pairs(plan, n, box, r_cut)
    assert not bool(plan.visit[i // 32, j // tp3m.K1_TILE].all())
    tpos, tmass = torch.tensor(pos), torch.tensor(mass)
    want = tp3m.p3m_short_plain(tpos, tmass, box, eps, r_s, r_cut,
                                split="spline", softening="spline")
    got = tp3m.p3m_short_culled_plain(tpos, tmass, box, eps, r_s, r_cut,
                                      plan, split="spline",
                                      softening="spline")
    per_target = float((got - want).norm(dim=1).max()
                       / want.norm(dim=1).square().mean().sqrt())
    assert per_target > TARGET_TOL, per_target


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_hilbert_keys_walk_neighbouring_cells(bits):
    """The sort key is a Hilbert curve: one key a cell, and cells of
    consecutive keys share a face (no jumps, unlike a Morton order)."""
    s = 1 << bits
    g = np.stack(np.meshgrid(*(np.arange(s),) * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    pos = torch.tensor((g + 0.5) * (100.0 / s), dtype=torch.float32)
    key = tp3m.hilbert_keys(pos, 100.0, bits).numpy()
    assert sorted(key.tolist()) == list(range(s**3))
    walk = g[np.argsort(key)]
    assert np.abs(np.diff(walk, axis=0)).sum(axis=1).max() == 1


def test_wrap_and_keys_take_the_box_edge():
    """Positions outside [0, box) wrap as the kernels wrap them; a position
    that rounds onto the box side keeps the last cell."""
    box = 500.0
    pos = torch.tensor([[-1e-6, 0.0, 499.99997], [500.0, 1000.5, -250.0]],
                       dtype=torch.float32)
    w = tp3m.k1_wrap(pos, box)
    assert float(w.min()) >= 0.0 and float(w.max()) <= box
    assert float(w[1, 1]) == pytest.approx(0.5, abs=1e-4)
    key = tp3m.hilbert_keys(pos, box)
    assert int(key.max()) < 2**(3 * tp3m.K1_KEY_BITS)


# the library's info on an H100 (132 SMs): tile, warps, chunk, resident
# blocks per SM, SMs
_INFO = (32, 8, 1024, 4, 132)


@pytest.mark.parametrize("n", [5, 3001, 32768, 65536])
def test_k1_geometry(n):
    """One slice below r_cut = box / 4; from there the sources are cut into
    slices that cover the tiles, none empty, for about K1_WAVES waves of
    the card."""
    box = 500.0
    tiles = -(-n // 32)
    cull = tp3m.k1_geometry(n, box, 0.088 * box, _INFO)
    assert cull.slices == 1
    assert cull.slice_tiles == tiles and cull.groups == -(-n // 32)
    sliced = tp3m.k1_geometry(n, box, 0.4999 * box, _INFO)
    assert sliced.groups == -(-n // 32)
    assert sliced.slice_tiles * sliced.slices >= tiles
    assert sliced.slice_tiles * (sliced.slices - 1) < tiles
    if n == 32768:
        assert sliced.slices > 1
        assert sliced.groups * sliced.slices >= tp3m.K1_WAVES * 132 * 4
