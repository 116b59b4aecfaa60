"""The column kernels' reach rule (``nbody_torch.forces.p3m_columns.
column_reach``, the plain form of the search in csrc/column_pairs.cuh)
against brute force, on the CPU: every pair of a block's target with a
source of nonzero mass in its chunk's window [ws, ws + W) whose
separation is below r_cut lies in the slots the block visits.

The planes: the JAX package's fresh plane of a uniform and of a
clustered state (its clumps straddle the box's z edges, so the ghost
bands fill and hold sentinels among their copies), a frozen plane (the
JAX package's plan at drift 0.999 skin/2, where slots leave their sorted
order, and with a few stale particles far past skin/2, as the driver
keeps them), and a slab plane of the domain decomposition (nx = ncell /
4).
A reach narrowed by r_cut / 2 must miss pairs on each, and the reach must
be well inside the window, or the check would say nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.forces import p3m_columns as jc
from nbody_torch.convert import plan_from_numpy
from nbody_torch.distributed.collectives import ShardGroup
from nbody_torch.forces import p3m_columns as tc

# columns of ~375 particles, a block of 128 targets a third of one
BOX, N, NCELL, R_CUT = 100.0, 6000, 4, 10.0
CK, WINDOW = 640, 640
# a plan's skin: at most (box / ncell - r_cut) / 2 = 7.5
SKIN = 3.0
# pairs below r_cut in float64 from the float32 plane, a hair wide of the
# kernel's float32 test
R2_WIDE = R_CUT**2 * (1.0 + 1e-6)


def _uniform(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, BOX, (N, 3)).astype(np.float32),
            rng.uniform(0.5, 2.0, N).astype(np.float32))


def _clustered(seed=2):
    """Half the particles in 12 clumps of width 3, their centres near the
    box's z edges for four of them, the rest uniform."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.0, BOX, (12, 3))
    centres[:4, 2] = [0.5, 1.5, BOX - 1.0, BOX - 0.2]
    clump = centres[rng.integers(0, 12, N // 2)] + rng.normal(
        0.0, 3.0, (N // 2, 3))
    pos = np.concatenate([clump, rng.uniform(0.0, BOX, (N - N // 2, 3))])
    return (np.mod(pos, BOX).astype(np.float32),
            rng.uniform(0.5, 2.0, N).astype(np.float32))


def _geometry(ck=CK, window=WINDOW):
    CKq, gz, stride, W, maxch, chunk = tc.plane_geometry(BOX, R_CUT, ck,
                                                         window)
    return dict(ncell=NCELL, stride=stride, W=W, maxch=maxch, gz=gz,
                chunk=chunk), CKq


def _jax_plane(pos, mass, ck, geo):
    build = jax.jit(jc.build_column_plane, static_argnums=(2, 3, 4, 5, 6),
                    static_argnames=("chunk",))
    out = build(jnp.asarray(pos), jnp.asarray(mass), BOX, R_CUT, NCELL, ck,
                geo["W"], chunk=geo["chunk"])
    plane, ws, nch, ov_b, ov_w = (np.asarray(x) for x in out[:5])
    assert int(ov_b) == 0 and int(ov_w) == 0
    return (torch.tensor(plane), torch.tensor(ws), torch.tensor(nch))


def _missed(plane, ws, nch, geo, *, r_cut, drift=None, cht=None, nx=None):
    """(pairs below r_cut outside the reach of ``r_cut``, pairs below
    r_cut, slots visited, window slots) over every block and
    neighbour."""
    first, lo, hi = tc.column_reach(plane, ws, nch, r_cut=r_cut, box=BOX,
                                    drift=drift, cht=cht, nx=nx, **geo)
    assert ((lo % tc.REACH_FENCE == 0) & (lo >= 0)).all()
    assert (hi <= geo["W"]).all()
    ncell, stride, W = geo["ncell"], geo["stride"], geo["W"]
    P = ncell + 2
    ic, k, _ = tc.interior_slots(ncell, stride, geo["gz"], geo["chunk"], nch,
                                 cht=cht, maxch=geo["maxch"], nx=nx)
    per = geo["chunk"] // tc.REACH_TARGETS
    ic, k = ic.repeat_interleave(per), k.repeat_interleave(per)
    ws64 = ws.to(torch.int64).reshape(-1, 9, geo["maxch"])
    x = plane[:4].double()
    tgt = first[:, None] + torch.arange(tc.REACH_TARGETS)
    off = torch.arange(W)
    missed = pairs = 0
    for o2 in range(9):
        jcol = (ic // ncell + o2 // 3) * P + (ic % ncell + o2 % 3)
        src = (jcol * stride + ws64[ic, o2, k])[:, None] + off
        for b0 in range(0, first.numel(), 16):
            t, s = tgt[b0:b0 + 16], src[b0:b0 + 16]
            d = x[0:3, s][:, :, None, :] - x[0:3, t][:, :, :, None]
            near = ((d * d).sum(0) < R2_WIDE) & (x[3, s] > 0)[:, None, :]
            inside = ((off >= lo[b0:b0 + 16, o2, None])
                      & (off < hi[b0:b0 + 16, o2, None]))
            pairs += int(near.sum())
            missed += int((near & ~inside[:, None, :]).sum())
    visited = int(torch.clamp_min(hi - lo, 0).sum())
    return missed, pairs, visited, first.numel() * 9 * W


def _check(plane, ws, nch, geo, **kw):
    missed, pairs, visited, slots = _missed(plane, ws, nch, geo,
                                            r_cut=R_CUT, **kw)
    assert pairs > 0 and missed == 0, (missed, pairs)
    # the reach is a fraction of the windows, and one narrowed by r_cut / 2
    # (and no drift) misses pairs: the check has teeth
    assert visited < 0.75 * slots, (visited, slots)
    narrowed, _, _, _ = _missed(plane, ws, nch, geo, r_cut=0.5 * R_CUT,
                                **dict(kw, drift=None))
    assert narrowed > 0
    print(f"reach: {visited / slots:.3f} of the window slots, {pairs} pairs")
    return visited / slots


@pytest.mark.parametrize("state", ["uniform", "clustered"])
def test_reach_holds_every_pair_of_a_fresh_plane(state):
    pos, mass = _uniform() if state == "uniform" else _clustered()
    geo, CKq = _geometry(ck=CK if state == "uniform" else 2048,
                         window=WINDOW if state == "uniform" else 1280)
    plane, ws, nch = _jax_plane(pos, mass, CKq, geo)
    if state == "clustered":
        # wrap ghosts: a ghost band full of the clumps at the z edges, and
        # sentinels behind it
        z = plane[2].reshape(-1, geo["stride"])
        assert ((z[:, :geo["gz"]] < -BOX).any(1)
                & (z[:, :geo["gz"]] > -R_CUT).any(1)).any()
    _check(plane, ws, nch, geo)


def _frozen(seed=3, stale=0):
    """The JAX package's plan frozen at a uniform state, the plane at a
    drift of 0.999 skin/2 in random directions and, with ``stale``, that
    many particles moved a column side down in z beyond it: (plane,
    drift, plan, geometry)."""
    pos, mass = _uniform(seed=seed)
    geo, CKq = _geometry()
    jplan = jc.freeze_column_plan(jnp.asarray(pos), jnp.asarray(mass), BOX,
                                  R_CUT, NCELL, CKq, geo["W"], skin=SKIN)
    plan = plan_from_numpy(*[np.asarray(f) for f in jplan], device="cpu")
    assert int(plan.ov) == 0
    rng = np.random.default_rng(seed + 1)
    u = rng.normal(size=pos.shape)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    moved = pos + 0.999 * 0.5 * SKIN * u
    moved[rng.choice(N, stale, replace=False), 2] -= BOX / NCELL
    plane, _, drift = tc.frozen_plane(
        torch.tensor(moved.astype(np.float32)), torch.tensor(mass), plan,
        BOX, R_CUT, NCELL, CKq, geo["gz"], geo["stride"])
    return plane, drift, plan, geo


def test_reach_holds_every_pair_of_a_frozen_plane():
    """The frozen plane at a drift of 0.999 skin/2: slots leave their
    sorted order by up to skin/2, and some ghosts turn into sentinels."""
    plane, drift, plan, geo = _frozen()
    z = plane[2].reshape(-1, geo["stride"])
    assert (z[:, 1:] < z[:, :-1] - 1e-3).any()  # out of the sorted order
    assert 0.99 * 0.5 * SKIN < float(drift) <= 0.5 * SKIN
    _check(plane, plan.ws, plan.nch, geo, drift=drift)
    # the active-chunk table of K5: every other chunk
    ncol, maxch = NCELL * NCELL, geo["maxch"]
    nch = plan.nch.to(torch.int64)
    act = torch.arange(maxch)[None, :] % 2 == 0
    act = act & (torch.arange(maxch)[None, :] < nch[:, None])
    nch_act = act.sum(1).to(torch.int32)
    cht = torch.sort(torch.where(act, torch.arange(maxch), maxch), 1).values
    _check(plane, plan.ws, nch_act, geo, drift=drift,
           cht=cht.reshape(ncol * maxch).to(torch.int32))


def test_reach_holds_every_pair_with_stale_particles():
    """16 particles far past skin/2 (the driver keeps up to that many
    stale particles in a segment): the reach widened by the measured drift
    holds every pair (here nearly the whole window), and one widened by
    the largest skin a plan of the grid takes (what a drift within skin/2
    needs) misses pairs."""
    plane, drift, plan, geo = _frozen(stale=16)
    assert float(drift) > 0.9 * BOX / NCELL
    missed, pairs, _, _ = _missed(plane, plan.ws, plan.nch, geo, r_cut=R_CUT,
                                  drift=drift)
    assert pairs > 0 and missed == 0, (missed, pairs)
    skin_max = 0.5 * (BOX / NCELL - R_CUT)
    missed, _, _, _ = _missed(plane, plan.ws, plan.nch, geo, r_cut=R_CUT,
                              drift=0.5 * skin_max)
    assert missed > 0


def test_reach_holds_every_pair_of_a_slab_plane():
    """Four shards' planes of the domain decomposition (nx = ncell / 4
    interior x-rows, the neighbours' edge rows as ghost x-rows)."""
    pos, mass = _clustered(seed=5)
    geo, CKq = _geometry(ck=2048, window=2048)
    D = 4
    group = ShardGroup(["cpu"] * D)
    slab = np.minimum((pos[:, 0] * (NCELL / BOX)).astype(np.int64),
                      NCELL - 1) // (NCELL // D)
    pos_l = [torch.tensor(pos[slab == d]) for d in range(D)]
    mass_l = [torch.tensor(mass[slab == d]) for d in range(D)]
    built = tc.build_local_column_plane(pos_l, mass_l, box=BOX, r_cut=R_CUT,
                                        ncell=NCELL, group=group,
                                        col_capacity=CKq, window=geo["W"],
                                        chunk=geo["chunk"])
    for plane, ws, nch, ov_b, ov_w, _, _ in built:
        assert int(ov_b) == 0 and int(ov_w) == 0
        _check(plane, ws, nch, geo, nx=NCELL // D)
