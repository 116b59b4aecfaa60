"""K2's atomics, on the CPU: the plain counterpart of what the deposit
issues (nbody_torch/forces/csrc/pm_supercell.cu): a thread a real slot,
its 8 corner masses scaled by 2^e, rounded to 64-bit integers and added
with integer atomics (``pm_supercell.deposit_atomics``), each node's sum
then rounded once to float32 (``pm_supercell.deposit_fixed``).

* every corner of every real slot is added exactly once, by one of 8
  atomics a slot, and no real slot's masses can overflow the sums;
* added as the kernel adds them, in two orders, the corners give the same
  integer sums, and the plain version's mesh on a fresh plane at both
  shifts, on the whole box (the 64^3 supercell plane's shapes, 16 x 16
  columns of 8^2 mesh cells) and on a slab of four (4 x 16 columns, the
  haloed slab, corners outside its halo dropped), and the CIC deposit of
  the plane's real slots on a plane whose slots drifted a column away
  (past the plain version's node grid).

The plane: 262,144 particles uniform in a 500 Mpc box on the supercell
geometry of mesh 128 (cfg64's shapes), built by the port; the slab
planes are four x-slices of it (box coordinates, as a slab's plane keeps
them).
"""

import numpy as np
import pytest
import torch

from nbody_torch.forces import p3m_columns as tc
from nbody_torch.forces import pm_supercell as ps

BOX, NMESH, N = 500.0, 128, 262144
SHARDS = 4


@pytest.fixture(scope="module")
def whole():
    rng = np.random.default_rng(3)
    pos = torch.tensor(rng.uniform(0, BOX, (N, 3)), dtype=torch.float32)
    r_s, r_cut, ncell, ck, w = ps.supercell_params(BOX, NMESH, N)
    CK, gz, stride, W, _, chunk = tc.plane_geometry(BOX, r_cut, ck, w)
    plane, _, _, ovb, _, _, counts = tc.build_column_plane(
        pos, torch.ones(N), BOX, r_cut, ncell, CK, W, chunk=chunk)
    assert int(ovb) == 0
    return dict(plane=plane, counts=counts, ncell=ncell, stride=stride,
                gz=gz, S=NMESH // ncell)


def _site(whole, site, d=0):
    """(plane, counts, nx, row0) of the whole-box site or shard d's slab."""
    if site == "cfg64":
        return whole["plane"], whole["counts"], whole["ncell"], 0
    ncell, stride = whole["ncell"], whole["stride"]
    nx = ncell // SHARDS
    row = (ncell + 2) * stride
    plane = whole["plane"][:, d * nx * row:(d * nx + nx + 2) * row]
    counts = whole["counts"][d * nx * ncell:(d + 1) * nx * ncell]
    return plane.contiguous(), counts.contiguous(), nx, d * nx


def _drifted(plane, counts, *, ncell, nx, stride, gz, S):
    """The plane with 64 real slots moved S + 3 mesh cells up in x (into
    the next column) and 64 more 40 cells down in z."""
    out = plane.clone()
    P = ncell + 2
    c = torch.arange(nx * ncell)
    first = ((c // ncell + 1) * P + c % ncell + 1) * stride + gz
    slots = torch.cat([first[i] + torch.arange(int(counts[i]))
                       for i in range(c.numel())])
    g = torch.Generator().manual_seed(5)
    pick = slots[torch.randperm(slots.numel(), generator=g)[:128]]
    cell = BOX / NMESH
    out[0, pick[:64]] += (S + 3) * cell
    out[2, pick[64:]] -= 40 * cell
    return out


def _add(atomics, size):
    """The mesh the atomics give (float64, from the kernel's float32 node
    masses), and the count of atomics."""
    node, w, e = atomics
    _, rho = ps.deposit_fixed(size, node, w, e)
    return rho.double(), int((node >= 0).sum())


@pytest.mark.parametrize("shift", [0.0, 0.5])
@pytest.mark.parametrize("site", ["cfg64", "slab"])
def test_each_corner_added_once(whole, site, shift):
    ncell, stride, gz, S = (whole[k] for k in ("ncell", "stride", "gz",
                                               "S"))
    plane, counts, nx, row0 = _site(whole, site)
    node, w, e = ps.deposit_atomics(
        plane, counts, ncell=ncell, S=S, nmesh=NMESH, stride=stride, gz=gz,
        scale=NMESH / BOX, shift=shift, nx=nx, row0=row0)
    CK = stride - 2 * gz
    live = (torch.arange(CK)[None, :]
            < counts.to(torch.int64)[:, None])[..., None].expand_as(node)
    if nx == ncell:
        assert torch.equal(node >= 0, live)
    assert bool((node[~live] == -1).all())
    # a slot's 8 corners are 8 different nodes
    ok = live[..., 0] & (node >= 0).all(-1)
    srt = node[ok].sort(dim=-1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())
    # the weights of a slot's 8 corners sum to its mass
    m = w.sum(-1)
    P = ncell + 2
    c = torch.arange(nx * ncell)
    slots = (((c // ncell + 1) * P + c % ncell + 1) * stride + gz)[:, None] \
        + torch.arange(CK)[None, :]
    mass = plane[3][slots]
    live1 = live[..., 0]
    assert float((m[live1] - mass[live1]).abs().max()) <= \
        1e-6 * float(mass.max())
    # 8 atomics a slot on the whole box
    if nx == ncell:
        assert int((node >= 0).sum()) == 8 * int(counts.sum())
    # the scaled masses of the plane's real slots stay below 2^62, e from
    # their count (not the capacity's slots)
    nreal = int(counts.sum())
    assert float(mass[live1].abs().max()) * 2.0**e * nreal < 2.0**62
    assert e == ps.deposit_fixed_exponent(float(mass[live1].max()), nreal)


@pytest.mark.parametrize("site,shift", [("cfg64", 0.5), ("slab", 0.0),
                                        ("slab", 0.5)])
def test_atomics_give_the_plain_deposit(whole, site, shift):
    ncell, stride, gz, S = (whole[k] for k in ("ncell", "stride", "gz",
                                               "S"))
    d = 1 if site == "slab" else 0
    plane, counts, nx, row0 = _site(whole, site, d)
    kw = dict(ncell=ncell, S=S, stride=stride, gz=gz, scale=NMESH / BOX,
              shift=shift, nx=nx, row0=row0)
    atomics = ps.deposit_atomics(plane, counts, nmesh=NMESH, **kw)
    slab = nx != ncell
    shape = (nx * S + 3 if slab else NMESH, NMESH, NMESH)
    size = shape[0] * NMESH * NMESH
    got, _ = _add(atomics, size)
    # the integer sums do not depend on the order of the atomics
    node, w, e = atomics
    perm = torch.randperm(node.numel(),
                          generator=torch.Generator().manual_seed(1))
    sums, _ = ps.deposit_fixed(size, node, w, e)
    again, _ = ps.deposit_fixed(size, node.reshape(-1)[perm],
                                w.reshape(-1)[perm], e)
    assert torch.equal(sums, again)
    _, ZP = ps.supercell_geometry(NMESH, ncell)
    # the float32 plain version: the same coordinates, rounded op by op
    nodes = ps.deposit_node_masses_plain(plane, counts, ZP=ZP, **kw)
    fold = dict(ncell=ncell, S=S, ZP=ZP, nmesh=NMESH)
    want = (ps.fold_slab_node_masses(nodes, nx=nx, **fold) if slab
            else ps.fold_node_masses(nodes, **fold)).reshape(-1).double()
    # float32 sums of the same weights in another order (chip_smoke.py's
    # NODE_MASS_TOL)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.max())


@pytest.mark.parametrize("site", ["cfg64", "slab"])
def test_atomics_reach_any_drift(whole, site):
    """Slots moved a column away: their atomics land where the CIC
    deposit of the plane's real slots puts them (a slab drops the corners
    outside its halo), and the mass is the plane's on the whole box."""
    ncell, stride, gz, S = (whole[k] for k in ("ncell", "stride", "gz",
                                               "S"))
    plane, counts, nx, row0 = _site(whole, site, 2 if site == "slab" else 0)
    plane = _drifted(plane, counts, ncell=ncell, nx=nx, stride=stride,
                     gz=gz, S=S)
    atomics = ps.deposit_atomics(plane, counts, ncell=ncell, S=S,
                                 nmesh=NMESH, stride=stride, gz=gz,
                                 scale=NMESH / BOX, shift=0.5, nx=nx,
                                 row0=row0)
    slab = nx != ncell
    size = (nx * S + 3 if slab else NMESH) * NMESH * NMESH
    got, _ = _add(atomics, size)
    P = ncell + 2
    c = torch.arange(nx * ncell)
    CK = stride - 2 * gz
    slots = (((c // ncell + 1) * P + c % ncell + 1) * stride + gz)[:, None] \
        + torch.arange(CK)[None, :]
    live = torch.arange(CK)[None, :] < counts.to(torch.int64)[:, None]
    real = slots[live]
    s = plane[0:3, real].double().T * (NMESH / BOX) - 0.5
    i0 = torch.floor(s).to(torch.int64)
    f = s - torch.floor(s)
    m = plane[3, real].double()
    want = torch.zeros(size, dtype=torch.float64)
    for k in range(8):
        d = (k // 4, k // 2 % 2, k % 2)
        wk = m.clone()
        for ax in range(3):
            wk = wk * (f[:, ax] if d[ax] else 1.0 - f[:, ax])
        ix = i0[:, 0] + d[0] - row0 * S
        if slab:
            px = ix + 1
            ok = (px >= 0) & (px < nx * S + 3)
        else:
            px = ix % NMESH
            ok = torch.ones_like(px, dtype=torch.bool)
        node = (px * NMESH + (i0[:, 1] + d[1]) % NMESH) * NMESH \
            + (i0[:, 2] + d[2]) % NMESH
        want.index_add_(0, node[ok], wk[ok])
    # the kernel's coordinates are float32 (relative to the column's
    # origin); float64 ones move a weight by up to ~1e-5 of a mass
    # (chip_smoke.py's FROZEN_NODE_TOL reasoning)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.max())
    if not slab:
        assert float(got.sum()) == pytest.approx(float(m.sum()), rel=1e-9)


def test_fixed_point_does_not_depend_on_the_capacity():
    """K2's rounding on the planes of one particle set at a column
    capacity and at twice it: the same exponent and the same integer
    sums.  The exponent from the plane's slot count (the rule before:
    nx * ncell * CK slots) moves by one between the two, and with it the
    rounding of the small corner weights, so two runs of one config from
    other capacities parted."""
    # a lattice of 32^3 particles a little off the 64^3 mesh's nodes, as
    # the Zel'dovich ICs sit: their small corner weights round
    rng = np.random.default_rng(11)
    n, nmesh = 32768, 64
    q = (np.indices((32,) * 3).reshape(3, -1).T + 0.5) * (BOX / 32)
    pos = torch.tensor(q + rng.normal(0, 1e-3 * BOX / nmesh, q.shape),
                       dtype=torch.float32)
    _, r_cut, ncell, ck, w = ps.supercell_params(BOX, nmesh, n)
    got = []
    for cap in (ck, 2 * ck):
        CK, gz, stride, W, _, chunk = tc.plane_geometry(BOX, r_cut, cap, w)
        plane, _, _, ovb, _, _, counts = tc.build_column_plane(
            pos, torch.ones(n), BOX, r_cut, ncell, CK, W, chunk=chunk)
        assert int(ovb) == 0
        node, wt, e = ps.deposit_atomics(
            plane, counts, ncell=ncell, S=nmesh // ncell, nmesh=nmesh,
            stride=stride, gz=gz, scale=nmesh / BOX)
        old = ps.deposit_fixed_exponent(1.0, ncell * ncell * CK)
        got.append((e, ps.deposit_fixed(nmesh**3, node, wt, e)[0],
                    old, ps.deposit_fixed(nmesh**3, node, wt, old)))
    (e1, s1, old1, (q1, rho1)), (e2, s2, old2, (q2, rho2)) = got
    assert e1 == e2 and torch.equal(s1, s2)
    # the slot count's exponents: the exact sums differ (one a half step
    # finer), and so does the float32 mesh
    assert old1 == old2 + 1 and not torch.equal(q1, 2 * q2)
    assert not torch.equal(rho1, rho2)
