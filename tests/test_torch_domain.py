"""The torch port's slab domain decomposition against the JAX package, on
the CPU: the collectives against numpy, the slab FFT, decomposition,
particle exchange, the local cell and column planes, the slab mesh
operations, the plain versions of the four slab kernel sites (K2, K3, K4,
K6), the domain force of each short-range tier, steps of the domain
runner, the sharded P(k) and energies, the driver's domain branch and its
refusals.

Inputs are made with numpy from a seed.  The JAX side runs on the
8-device CPU mesh of tests/conftest.py (its Pallas kernels in interpret
mode); the port drives D shards from one process, all on the CPU.
Mesh-side arrays are float64 in both packages and held to 1e-9; the
short-range planes are float32 in both, so what passes through them is
held to float32 tolerances.
"""

import functools

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import jax
import jax.numpy as jnp
from nbody.core.types import ParticleState as JState
from nbody.distributed import domain as jd
from nbody.distributed import fft as jfft
from nbody.distributed.sharding import device_mesh as j_mesh
from nbody.driver.config import SimulationConfig as JConfig
from nbody_torch.convert import (
    domain_state_from_numpy,
    domain_state_to_numpy,
    state_from_numpy,
)
from nbody_torch.distributed import collectives as tcoll
from nbody_torch.distributed import domain as td
from nbody_torch.distributed import fft as tfft
from nbody_torch.distributed.sharding import device_mesh as t_mesh

BOX, NMESH, N = 500.0, 32, 2000
F64 = torch.float64
# float64 mesh-side arithmetic in both packages, summed in other orders
TIGHT = 1e-9


def _jmap(fn, mesh, n_in, n_out):
    """shard_map over the JAX mesh with every argument and result split
    over the shards (a result of rank 0 comes back one a shard)."""
    spec = P("shard")
    return jax.jit(jd._shard_map(
        fn, mesh=mesh, in_specs=(spec,) * n_in,
        out_specs=(spec,) * n_out if n_out > 1 else spec, check_vma=False))


def _state(seed=0, n=N):
    """Uniform particles plus two clumps (planes with full and empty
    cells), unit masses, random velocities, as numpy float64."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, BOX, (n, 3))
    pos[: n // 5] = np.mod(rng.normal(0.0, 6.0, (n // 5, 3))
                           + [62.0, 190.0, 440.0], BOX)
    pos[n // 5: n // 3] = np.mod(rng.normal(0.0, 8.0, (n // 3 - n // 5, 3))
                                 + [376.0, 3.0, 260.0], BOX)
    vel = rng.normal(0.0, 1.0, (n, 3))
    return pos, vel, np.full(n, 1.0), 0.5


def _jstate(arrs):
    pos, vel, mass, t = arrs
    return JState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                  mass=jnp.asarray(mass), time=jnp.asarray(t))


_DOMS = {}


def _dom(D):
    """The same decomposed state in both packages, D shards (built once a
    module)."""
    if D in _DOMS:
        return _DOMS[D]
    arrs = _state()
    geom = jd.domain_p3m_geometry(BOX, NMESH, D, N)
    mesh = j_mesh(D)
    js = jd.domain_decompose(_jstate(arrs), mesh, BOX, ncell=geom.ncell)
    group = t_mesh(D, device="cpu")
    ts = td.domain_decompose(state_from_numpy(*arrs, device="cpu",
                                              dtype=F64), group, BOX,
                             ncell=geom.ncell)
    _DOMS[D] = dict(D=D, mesh=mesh, group=group, geom=geom, js=js, ts=ts)
    return _DOMS[D]


@pytest.fixture(scope="module", params=[2, 4])
def dom(request):
    return _dom(request.param)


@pytest.fixture(scope="module")
def dom4():
    return _dom(4)


def _lists(shards):
    return ([s.pos for s in shards], [s.vel for s in shards],
            [s.mass for s in shards])


def _cat(xs):
    return np.concatenate([np.asarray(x) for x in xs])


# ---------------------------------------------------------------------------
# collectives and the FFT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["ppermute+1", "ppermute-1", "psum", "pmax",
                                "all_gather", "all_to_all"])
@pytest.mark.parametrize("D", [1, 3, 4])
def test_collectives_match_numpy(op, D):
    rng = np.random.default_rng(D)
    xs = [rng.normal(size=(4 * D, 2 * D)) for _ in range(D)]
    group = tcoll.ShardGroup(["cpu"] * D)
    ts = [torch.as_tensor(x) for x in xs]
    if op.startswith("ppermute"):
        shift = int(op[-2:])
        got = group.ppermute(ts, shift)
        want = [xs[(d - shift) % D] for d in range(D)]
    elif op == "psum":
        got = group.psum(ts)
        want = [np.sum(xs, axis=0)] * D
    elif op == "pmax":
        got = group.pmax(ts)
        want = [np.max(xs, axis=0)] * D
    elif op == "all_gather":
        got = group.all_gather(ts, dim=1)
        want = [np.concatenate(xs, axis=1)] * D
    else:
        got = group.all_to_all(ts, split_dim=0, concat_dim=1)
        want = [np.concatenate([np.split(x, D, axis=0)[j] for x in xs], axis=1)
                for j in range(D)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-14, atol=1e-14)


def test_shard_state_blocks_rows():
    from nbody_torch.distributed.sharding import shard_state

    arrs = _state(n=12)
    st = state_from_numpy(*arrs, device="cpu", dtype=F64)
    shards = shard_state(st, t_mesh(3, device="cpu"))
    assert [s.n for s in shards] == [4, 4, 4]
    np.testing.assert_array_equal(torch.cat([s.pos for s in shards]).numpy(),
                                  arrs[0])
    with pytest.raises(ValueError, match="divisible"):
        shard_state(st, t_mesh(5, device="cpu"))


def test_psum_adds_in_shard_order():
    """A psum is the same sum on every shard, taken in shard order."""
    vals = [1e16, 1.0, -1e16, 1.0]
    group = tcoll.ShardGroup(["cpu"] * 4)
    got = group.psum([torch.tensor(v, dtype=F64) for v in vals])
    assert [float(g) for g in got] == [((1e16 + 1.0) - 1e16) + 1.0] * 4


@pytest.mark.parametrize("D", [2, 4])
def test_slab_fft_matches_rfftn_and_jax(D):
    rng = np.random.default_rng(D)
    grid = rng.normal(size=(16, 16, 16))
    group = tcoll.ShardGroup(["cpu"] * D)
    slabs = [torch.as_tensor(s) for s in np.split(grid, D, axis=0)]
    hk = tfft.slab_rfftn(slabs, group)
    full = torch.fft.rfftn(torch.as_tensor(grid))
    np.testing.assert_allclose(torch.cat(hk, dim=1).numpy(), full.numpy(),
                               rtol=0, atol=TIGHT * float(full.abs().max()))
    back = tfft.slab_irfftn(hk, 16, group)
    np.testing.assert_allclose(torch.cat(back).numpy(), grid, atol=TIGHT)
    mesh = j_mesh(D)
    jhk = jax.jit(jd._shard_map(
        lambda g: jfft.slab_rfftn(g, "shard"), mesh=mesh, in_specs=P("shard"),
        out_specs=P(None, "shard"), check_vma=False))(jnp.asarray(grid))
    np.testing.assert_allclose(torch.cat(hk, dim=1).numpy(), np.asarray(jhk),
                               rtol=0, atol=TIGHT * float(full.abs().max()))
    for d in range(D):
        jk = [np.asarray(k) for k in jfft.kvecs_slab(16, BOX, d, D,
                                                     jnp.float64)]
        tk = tfft.kvecs_slab(16, BOX, d, D, F64)
        for a, b in zip(jk, tk):
            np.testing.assert_array_equal(a, b.numpy())
        np.testing.assert_allclose(
            tfft.slab_filter(lambda k2: torch.exp(-k2), 16, BOX, d, D,
                             F64).numpy(),
            np.asarray(jfft.slab_filter(lambda k2: jnp.exp(-k2), 16, BOX, d,
                                        D, jnp.float64)), rtol=1e-14)


# ---------------------------------------------------------------------------
# decomposition, exchange and the local planes
# ---------------------------------------------------------------------------


def test_domain_decompose_matches_jax(dom):
    got = domain_state_to_numpy(dom["ts"])
    for g, w in zip(got, (dom["js"].pos, dom["js"].vel, dom["js"].mass,
                          dom["js"].time)):
        np.testing.assert_array_equal(g, np.asarray(w))
    back = domain_state_from_numpy(*got, n_dev=dom["D"],
                                   devices=dom["group"].devices, dtype=F64)
    for a, b in zip(back, dom["ts"]):
        assert torch.equal(a.pos, b.pos) and torch.equal(a.mass, b.mass)
    dense = td.domain_gather(dom["ts"])
    jdense = jd.domain_gather(dom["js"])
    np.testing.assert_array_equal(dense.pos.numpy(), np.asarray(jdense.pos))
    np.testing.assert_array_equal(
        td.slab_counts(dense.pos, BOX, dom["geom"].ncell, dom["D"]),
        jd.slab_counts(np.asarray(jdense.pos), BOX, dom["geom"].ncell,
                       dom["D"]))


def _drifted(dom, scale=30.0):
    """Each shard's particles displaced by up to ``scale`` Mpc (about a
    quarter of a slab at D = 4), so that some cross each boundary."""
    rng = np.random.default_rng(5)
    js = dom["js"]
    shift = rng.uniform(-scale, scale, np.asarray(js.pos).shape)
    shift *= (np.asarray(js.mass) > 0)[:, None]
    pos = np.mod(np.asarray(js.pos) + shift, BOX)
    return pos, np.asarray(js.vel), np.asarray(js.mass)


@pytest.mark.parametrize("E", [512, 8])
def test_slab_exchange_matches_jax(dom, E):
    """The migrated shards equal the JAX package's slot for slot, with an
    extra per-particle array riding along; E = 8 forces overflow."""
    D, geom = dom["D"], dom["geom"]
    pos, vel, mass = _drifted(dom)
    extra = np.arange(len(mass), dtype=np.float64)[:, None] * [1.0, -1.0]

    def body(p, v, m, e):
        p2, v2, m2, (e2,), ov = jd.slab_exchange(
            p, v, m, box=BOX, ncell=geom.ncell, n_dev=D,
            exchange_capacity=E, axis_name="shard", extras=(e,))
        return p2, v2, m2, e2, ov[None]

    jout = _jmap(body, dom["mesh"], 4, 5)(*map(jnp.asarray,
                                               (pos, vel, mass, extra)))
    split = [np.split(a, D) for a in (pos, vel, mass, extra)]
    tl = [[torch.as_tensor(np.array(x)) for x in s] for s in split]
    p2, v2, m2, (e2,), ov = td.slab_exchange(
        tl[0], tl[1], tl[2], box=BOX, ncell=geom.ncell, group=dom["group"],
        exchange_capacity=E, extras=(tl[3],))
    for got, want in zip((p2, v2, m2, e2, ov), jout):
        np.testing.assert_array_equal(
            _cat([g.numpy() for g in got]) if got is not ov
            else np.array([int(o) for o in ov]), np.asarray(want))
    if E == 8:
        assert sum(int(o) for o in ov) > 0
    else:
        assert sum(int(o) for o in ov) == 0
        assert float(sum(m.sum() for m in m2)) == N


def test_build_local_plane_matches_jax(dom):
    """Plane, overflow, K and gidx equal the JAX package's; the port's
    per-cell counts are the stored particles of each padded cell."""
    D, geom = dom["D"], dom["geom"]
    js = dom["js"]
    cap = 48

    def body(p, m):
        plane, ov, K, gidx = jd.build_local_plane(
            p, m, box=BOX, r_cut=geom.r_cut, ncell=geom.ncell, n_dev=D,
            capacity=cap, axis_name="shard")
        return plane.reshape(1, *plane.shape), ov[None], gidx

    jplane, jov, jgidx = _jmap(body, dom["mesh"], 2, 3)(js.pos, js.mass)
    pos, _, mass = _lists(dom["ts"])
    got = td.build_local_plane(pos, mass, box=BOX, r_cut=geom.r_cut,
                               ncell=geom.ncell, group=dom["group"],
                               capacity=cap)
    M = geom.ncell + 2
    jg = np.split(np.asarray(jgidx), D)
    for d, (plane, ov, K, gidx, counts) in enumerate(got):
        assert K == 128
        np.testing.assert_array_equal(plane.numpy(), np.asarray(jplane[d]))
        assert int(ov) == int(jov[d])
        np.testing.assert_array_equal(gidx.numpy(), jg[d])
        m = plane[3].reshape(-1, K)
        np.testing.assert_array_equal(counts.numpy(),
                                      (m > 0).sum(dim=1).numpy())
        assert counts.numel() == (geom.ncell // D + 2) * M * M
    assert sum(int(g[1]) for g in got) > 0  # the clumps overflow 48


def test_build_local_column_plane_matches_jax(dom):
    D, geom = dom["D"], dom["geom"]
    js = dom["js"]
    ck, w = 256, 384

    def body(p, m):
        out = jd_cols.build_local_column_plane(
            p, m, box=BOX, r_cut=geom.r_cut, ncell=geom.ncell, n_dev=D,
            col_capacity=ck, window=w, axis_name="shard")
        return tuple(o.reshape(1, *o.shape) if o.ndim != 1 or o.shape[0] !=
                     p.shape[0] else o for o in out)

    from nbody.forces import p3m_columns as jd_cols

    jout = _jmap(body, dom["mesh"], 2, 7)(js.pos, js.mass)
    pos, _, mass = _lists(dom["ts"])
    got = td.build_local_column_plane(
        pos, mass, box=BOX, r_cut=geom.r_cut, ncell=geom.ncell,
        group=dom["group"], col_capacity=ck, window=w)
    jgidx = np.split(np.asarray(jout[5]), D)
    for d, b in enumerate(got):
        for i in (0, 1, 2, 6):
            np.testing.assert_array_equal(b[i].numpy(), np.asarray(jout[i][d]))
        assert int(b[3]) == int(np.asarray(jout[3][d]))
        assert int(b[4]) == int(np.asarray(jout[4][d]))
        np.testing.assert_array_equal(b[5].numpy(), jgidx[d])


def test_supercell_slabs_are_cut_on_the_plane_grid():
    """At cfg64's geometry the domain cell grid (20) and the supercell grid
    (16) cut the box at the same planes, but a float32 x within an ulp of
    a cut falls on different sides of it in the two: an exchange on the
    cell grid moves such a particle to a shard whose supercell plane
    leaves it out (no force, no mass, no overflow), one on slab_grid's
    grid does not."""
    from nbody.forces.p3m import supercell_ncell

    geom = td.domain_p3m_geometry(500.0, 128, 4, 20000)
    sc = supercell_ncell(500.0, 128, geom.r_cut)
    assert (geom.ncell, sc, td.slab_grid(geom, "supercell")) == (20, 16, 16)
    assert td.slab_grid(geom, "columns") == td.slab_grid(geom, "cells") == 20
    rng = np.random.default_rng(2)
    pos = rng.uniform(0.0, 500.0, (2000, 3)).astype(np.float32)
    # one float32 ulp below the cuts: x * (20/500) stays below 5, 10, 15,
    # x * (16/500) rounds up to 4, 8, 12
    pos[:3, 0] = [124.99999237060547, 249.99998474121094, 374.9999694824219]
    group = t_mesh(4, device="cpu")
    st = state_from_numpy(pos, np.zeros_like(pos), np.ones(2000), 0.5,
                          device="cpu")
    shards = td.domain_decompose(st, group, 500.0,
                                 td.slab_grid(geom, "supercell"))
    for grid, dropped in ((geom.ncell, 3), (td.slab_grid(geom, "supercell"),
                                            0)):
        pos_l, _, mass_l, ov = td.slab_exchange(
            *_lists(shards), box=500.0, ncell=grid, group=group,
            exchange_capacity=64)
        assert sum(int(o) for o in ov) == 0
        built = td.build_local_column_plane(
            pos_l, mass_l, box=500.0, r_cut=geom.r_cut, ncell=sc,
            group=group, col_capacity=512, window=512)
        lost = sum(int(((m > 0) & (b[5] >= b[0].shape[1])).sum())
                   for m, b in zip(mass_l, built))
        assert lost == dropped
        assert sum(int(b[3]) for b in built) == 0  # and nothing counts it


# ---------------------------------------------------------------------------
# slab mesh operations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order,shift", [(2, 0.0), (2, 0.5), (3, 0.0),
                                         (4, 0.5)])
def test_slab_deposits_match_jax(dom, order, shift):
    D = dom["D"]
    js = dom["js"]
    jgrid = _jmap(lambda p, m: jd.slab_bspline_deposit(
        p, m, box=BOX, nmesh=NMESH, n_dev=D, axis_name="shard", order=order,
        shift=shift), dom["mesh"], 2, 1)(js.pos, js.mass)
    pos, _, mass = _lists(dom["ts"])
    got = td.slab_bspline_deposit(pos, mass, box=BOX, nmesh=NMESH,
                                  group=dom["group"], order=order,
                                  shift=shift)
    np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(jgrid),
                               rtol=0, atol=TIGHT)
    assert abs(float(sum(g.sum() for g in got)) - N) < 1e-9 * N


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_slab_gather3_matches_jax(dom, shift):
    D = dom["D"]
    js = dom["js"]
    rng = np.random.default_rng(3)
    grids = rng.normal(size=(3, NMESH, NMESH, NMESH))
    jacc = jax.jit(jd._shard_map(
        lambda g, p: jd.slab_gather3(g, p, box=BOX, n_dev=D,
                                     axis_name="shard", shift=shift),
        mesh=dom["mesh"], in_specs=(P(None, "shard"), P("shard")),
        out_specs=P("shard"), check_vma=False))(jnp.asarray(grids), js.pos)
    pos, _, _ = _lists(dom["ts"])
    got = td.slab_gather3([torch.as_tensor(g) for g in
                           np.split(grids, D, axis=1)], pos, box=BOX,
                          group=dom["group"], shift=shift)
    np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(jacc),
                               rtol=0, atol=TIGHT)


# ---------------------------------------------------------------------------
# the plain versions of the four slab kernel sites
# ---------------------------------------------------------------------------

# float32 planes and sums in both packages, in another order: relative to
# the largest value (the tolerance of the column and cell tiers' tests)
F32_TOL = 2e-5
EPS, SPLIT, SOFT = 0.5, "spline", "spline"


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_k6_slab_plain_matches_jax_kernel(dom4):
    """K6 on each shard's slab plane (nx = ncell / D): the port's plain
    version against the JAX kernel (interpret mode) on float64 copies of
    the same plane, to 1e-9."""
    from nbody.forces import p3m as jp3m
    from nbody_torch.forces import p3m as tp3m

    geom = dom4["geom"]
    nxl = geom.ncell // 4
    pos, _, mass = _lists(dom4["ts"])
    kw = dict(eps2=EPS**2, r_s=geom.r_s, r_cut=geom.r_cut, split=SPLIT,
              softening=SOFT)
    jkernel = None
    for plane, _, K, _, counts in td.build_local_plane(
            pos, mass, box=BOX, r_cut=geom.r_cut, ncell=geom.ncell,
            group=dom4["group"], capacity=512):
        p64 = plane.double()
        got = tp3m.run_cell_plane(p64, counts, nx=nxl, ncell=geom.ncell,
                                  K=K, **kw)
        if jkernel is None:
            jkernel = jax.jit(functools.partial(
                jp3m.run_cell_plane, nx=nxl, ncell=geom.ncell, K=K,
                interpret=True, **kw))
        want = np.asarray(jkernel(jnp.asarray(p64.numpy())))
        # the real cells' slots (the JAX kernel leaves the ghost cells
        # unwritten)
        cells = tp3m._real_cells(nxl, geom.ncell, "cpu")
        slots = (cells[:, None] * K + torch.arange(K)[None, :]).reshape(-1)
        assert _rel(got[:3, slots].numpy(), want[:3, slots.numpy()]) < TIGHT
        assert float(got[:3].abs().max()) > 0.0
        assert float(got[3:].abs().max()) == 0.0


def test_k4_slab_matches_jax(dom4):
    """K4 on the slab planes: p3m_short_columns_local in both packages
    (float32 planes), with the overflow words of each shard."""
    from nbody.forces import p3m_columns as jcols
    from nbody_torch.forces import p3m_columns as tcols

    geom = dom4["geom"]
    js = dom4["js"]
    kw = dict(box=BOX, eps=EPS, r_s=geom.r_s, r_cut=geom.r_cut, G=1.0,
              ncell=geom.ncell, col_capacity=640, window=512, split=SPLIT,
              softening=SOFT)

    def body(p, m):
        acc, ov = jcols.p3m_short_columns_local(p, m, n_dev=4,
                                                axis_name="shard", **kw)
        return acc, ov[None]

    jacc, jov = _jmap(body, dom4["mesh"], 2, 2)(js.pos, js.mass)
    pos, _, mass = _lists(dom4["ts"])
    acc, ovs = tcols.p3m_short_columns_local(pos, mass, group=dom4["group"],
                                             **kw)
    assert _rel(torch.cat(acc).numpy(), jacc) < F32_TOL
    assert [int(o) for o in ovs] == [int(o) for o in np.asarray(jov)]


def _sc_planes(dom):
    """The supercell tier's local column planes of the port (box
    coordinates; its K2 and K3 take each slab's first x-row), with their
    geometry."""
    from nbody.forces import p3m_columns as jcols
    from nbody.forces.p3m import supercell_ncell
    from nbody.forces.pm_supercell import supercell_geometry

    D, geom = dom["D"], dom["geom"]
    sc = supercell_ncell(BOX, NMESH, geom.r_cut)
    S, ZP = supercell_geometry(NMESH, sc)
    ck, w = 640, 512
    gz = jcols.ghost_slots(ck, (geom.r_cut / BOX) * ck)
    g = dict(sc=sc, S=S, ZP=ZP, CK=ck, W=w, gz=gz, stride=ck + 2 * gz,
             chunk=128, maxch=ck // 128)
    pos, _, mass = _lists(dom["ts"])
    built = td.build_local_column_plane(
        pos, mass, box=BOX, r_cut=geom.r_cut, ncell=sc, group=dom["group"],
        col_capacity=ck, window=w, chunk=128)
    return g, built, [b[0] for b in built]


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_k2_slab_matches_jax(dom4, shift):
    """K2's slab form (supercell_deposit_local): the port's plain deposit
    + slab fold + halo exchange against the JAX kernel's, on the same
    particles (the JAX plane shifted to the slab's origin, the port's in
    box coordinates; the two round the CIC weights differently, within
    float32); a halo plane left unsent must break the agreement."""
    from nbody.forces import p3m_columns as jcols
    from nbody.forces import pm_supercell as jsc
    from nbody_torch.forces import pm_supercell as tsc

    geom, js = dom4["geom"], dom4["js"]
    g, built, planes = _sc_planes(dom4)

    def body(p, m):
        out = jcols.build_local_column_plane(
            p, m, box=BOX, r_cut=geom.r_cut, ncell=g["sc"], n_dev=4,
            col_capacity=g["CK"], window=g["W"], axis_name="shard",
            chunk=128)
        d = jax.lax.axis_index("shard")
        plane = out[0].at[0].add(-jnp.asarray(d * (BOX / 4), jnp.float32))
        rho = jsc.supercell_deposit_local(
            plane, out[6], box=BOX, nmesh=NMESH, ncell=g["sc"], n_dev=4,
            stride=g["stride"], gz=g["gz"], axis_name="shard", chunk=128,
            shift=shift)
        return rho

    jrho = np.asarray(_jmap(body, dom4["mesh"], 2, 1)(js.pos, js.mass))
    kw = dict(box=BOX, nmesh=NMESH, ncell=g["sc"], stride=g["stride"],
              gz=g["gz"], chunk=128, shift=shift)
    counts = [b[6] for b in built]
    got = tsc.supercell_deposit_local(planes, counts, group=dom4["group"],
                                      **kw)
    assert _rel(torch.cat(got).numpy(), jrho) < 1e-5
    assert abs(float(sum(r.sum() for r in got)) - N) < 1e-3
    nx = g["sc"] // 4
    exts = [tsc.supercell_deposit_from_plane(p, c, nx=nx, row0=d * nx, **kw)
            for d, (p, c) in enumerate(zip(planes, counts))]
    unsent = [e.clone() for e in exts]
    for e in unsent:
        e[-2] = 0.0  # node nml deposited, never sent to the right neighbour
    bad = tsc.slab_halo_fold(unsent, dom4["group"])
    assert _rel(torch.cat(bad).numpy(), jrho) > 1e-2


@pytest.mark.parametrize("interlaced", [False, True])
def test_k3_slab_matches_jax(dom4, interlaced):
    """K3 on the slab planes (split_out) against the JAX kernel reading
    the JAX package's per-column node subgrids, from the same random
    force-grid slabs; and the haloed grids the port reads carry exactly
    the JAX subgrids' node values."""
    from nbody.forces import p3m_columns as jcols
    from nbody.forces import pm_supercell as jsc
    from nbody_torch.forces import pm_supercell as tsc

    geom, js = dom4["geom"], dom4["js"]
    g, built, planes = _sc_planes(dom4)
    nc = 6 if interlaced else 3
    rng = np.random.default_rng(11)
    grids = rng.normal(size=(nc, NMESH, NMESH, NMESH)).astype(np.float32)
    nx = g["sc"] // 4
    fkw = dict(ncell=g["sc"], stride=g["stride"], W=g["W"],
               maxch=g["maxch"], gz=g["gz"], chunk=128, eps2=EPS**2,
               r_s=geom.r_s, r_cut=geom.r_cut, split=SPLIT, softening=SOFT,
               S=g["S"], ZP=g["ZP"], scale=NMESH / BOX, split_out=True,
               nx=nx, interlaced=interlaced)

    def body(p, m, gl):
        out = jcols.build_local_column_plane(
            p, m, box=BOX, r_cut=geom.r_cut, ncell=g["sc"], n_dev=4,
            col_capacity=g["CK"], window=g["W"], axis_name="shard",
            chunk=128)
        d = jax.lax.axis_index("shard")
        plane = out[0].at[0].add(-jnp.asarray(d * (BOX / 4), jnp.float32))
        sub = jsc.extract_local_subgrids(gl, g["sc"], g["S"], g["ZP"],
                                         n_dev=4, axis_name="shard")
        res = jsc.run_fused_column_plane(plane, out[1], out[2], sub,
                                         interpret=True, **fkw)
        return res.reshape(1, *res.shape), sub.reshape(1, *sub.shape)

    spec = P("shard")
    jout, jsub = jax.jit(jd._shard_map(
        body, mesh=dom4["mesh"], in_specs=(spec, spec, P(None, "shard")),
        out_specs=(spec, spec), check_vma=False))(js.pos, js.mass,
                                                  jnp.asarray(grids))
    slabs = [torch.as_tensor(x) for x in np.split(grids, 4, axis=1)]
    halo = tsc.extract_local_subgrids(slabs, dom4["group"])
    S, ZP, sc = g["S"], g["ZP"], g["sc"]
    for d in range(4):
        # JAX node (x-row a, y-row b, lane l) of local column (tx, ty) is
        # halo plane tx S + a (node tx S + a - 1), y node ty S + b - 1,
        # z node l - 1
        sub = np.asarray(jsub[d]).reshape(nx, sc, 16, 16, nc, ZP)
        xa = np.clip(np.arange(nx)[:, None] * S + np.arange(16)[None],
                     0, nx * S + 3)
        yb = np.mod(np.arange(sc)[:, None] * S + np.arange(16)[None] - 1,
                    NMESH)
        zl = np.mod(np.arange(NMESH + 4) - 1, NMESH)
        h = halo[d].numpy()
        want = h[:, xa][:, :, :, yb][..., zl]  # (nc, nx, 16, sc, 16, Z)
        np.testing.assert_array_equal(
            sub[..., : NMESH + 4], want.transpose(1, 3, 2, 4, 0, 5))
    tkw = {k: v for k, v in fkw.items() if k not in ("eps2", "ZP")}
    for d, (b, plane) in enumerate(zip(built, planes)):
        out = tsc.run_fused_column_plane(plane, b[1], b[2], halo[d],
                                         eps=EPS, row0=d * nx, **tkw)
        # the particles' slots (the JAX kernel leaves the ghost columns
        # unwritten, and its node subgrid reads nothing at the ghost
        # slots of a chunk's tail, where the port reads the periodic z)
        slots = b[5][b[5] < plane.shape[1]]
        want = np.asarray(jout[d])[:6, slots.numpy()]
        assert _rel(out[:6, slots].numpy(), want) < F32_TOL


# ---------------------------------------------------------------------------
# the domain force, the runner, measurement and energies
# ---------------------------------------------------------------------------

JCFG = JConfig(n_side=16)
TIERS = {"cells": dict(bucket_capacity=512),
         "columns": dict(col_capacity=640),
         "supercell": dict(col_capacity=640)}


def _cosmos():
    from nbody_torch.driver import SimulationConfig as TConfig

    return JCFG.cosmology(), TConfig.from_dict(JCFG.to_dict()).cosmology()


@pytest.mark.parametrize("tier,interlace", [("cells", False),
                                            ("columns", False),
                                            ("supercell", False),
                                            ("supercell", True)])
def test_domain_force_matches_jax(dom4, tier, interlace):
    """make_domain_p3m_force on the same decomposed state: the whole force
    to float32 tolerance (its short-range half comes from float32 planes
    in both packages), the overflow word equal."""
    jc, tc = _cosmos()
    js, group = dom4["js"], dom4["group"]
    kw = dict(shortrange=tier, softening=SOFT, interlace=interlace,
              **TIERS[tier])
    jf, _ = jd.make_domain_p3m_force(jc, BOX, NMESH, dom4["mesh"], EPS, N,
                                     **kw)
    jg, jov = jax.jit(jf)(js.pos, js.mass, 0.5)
    tf, geom = td.make_domain_p3m_force(tc, BOX, NMESH, group, EPS, N, **kw)
    pos, _, mass = _lists(dom4["ts"])
    g, ov = tf(pos, mass, 0.5)
    assert _rel(torch.cat(g).numpy(), jg) < F32_TOL
    assert int(ov) == int(jov)


@pytest.mark.parametrize("part", ["long", "pm"])
def test_domain_far_field_matches_jax_tightly(dom4, part):
    """The far field alone and the pure domain PM (split='none') are
    float64 in both packages: 1e-9."""
    jc, tc = _cosmos()
    js, group = dom4["js"], dom4["group"]
    D = 4
    jgeom = jd.domain_p3m_geometry(BOX, NMESH, D, N)
    tgeom = td.domain_p3m_geometry(BOX, NMESH, D, N)
    assert tuple(tgeom) == tuple(jgeom)[:-1]
    kw = (dict(part="long", interlace=True) if part == "long"
          else dict(split="none"))
    jloc = jd.make_domain_p3m_local(jc, jgeom, EPS, **kw)
    jout = _jmap(lambda p, m: jloc(p, m, 0.5) if part == "long"
                 else jloc(p, m, 0.5)[0], dom4["mesh"], 2, 1)(js.pos,
                                                             js.mass)
    tloc = td.make_domain_p3m_local(tc, tgeom, EPS, group=group, **kw)
    pos, _, mass = _lists(dom4["ts"])
    got = tloc(pos, mass, 0.5)
    got = got if part == "long" else got[0]
    assert _rel(torch.cat(got).numpy(), jout) < TIGHT


@pytest.mark.parametrize("tier", ["cells", "columns", "supercell"])
def test_domain_force_parts_add_up(dom4, tier):
    """part='long' + part='short' (and, on the supercell tier, the two
    halves of part='split') make part='both'."""
    _, tc = _cosmos()
    group, geom = dom4["group"], dom4["geom"]
    pos, _, mass = _lists(dom4["ts"])
    kw = dict(group=group, shortrange=tier, softening=SOFT,
              col_capacity=TIERS[tier].get("col_capacity"))
    tgeom = geom._replace(bucket_capacity=512)
    both, ov = td.make_domain_p3m_local(tc, tgeom, EPS, **kw)(pos, mass, 0.5)
    if tier == "supercell":
        gs, gl, ov2 = td.make_domain_p3m_local(tc, tgeom, EPS, part="split",
                                               **kw)(pos, mass, 0.5, 0.5)
    else:
        gl = td.make_domain_p3m_local(tc, tgeom, EPS, part="long",
                                      **kw)(pos, mass, 0.5)
        gs, ov2 = td.make_domain_p3m_local(tc, tgeom, EPS, part="short",
                                           **kw)(pos, mass, 0.5)
    for b, x, y in zip(both, gl, gs):
        assert _rel((x + y).numpy(), b.numpy()) < TIGHT
    assert [int(o) for o in ov] == [int(o) for o in ov2]
    if tier == "cells":
        # the rung tier's masked form with every row active is the cells
        # tier's short-range force
        g_all, _, _, _ = td.make_domain_p3m_local(
            tc, tgeom, EPS, part="short_masked", target_capacity=512,
            **kw)(pos, mass, [m > 0 for m in mass], 0.5)
        for x, y in zip(g_all, gs):
            assert _rel(x.numpy(), y.numpy()) < TIGHT


@pytest.mark.parametrize("tier,split", [("cells", "spline"),
                                        ("cells", "none")])
def test_run_cosmological_domain_matches_jax(dom4, tier, split):
    """Four steps of the domain runner from the same decomposed state:
    slot for slot the same particles; positions to 1e-9 of the box for
    the pure PM (float64 throughout), to 2e-5 of the largest drift where
    float32 short-range forces enter."""
    jc, tc = _cosmos()
    js, group = dom4["js"], dom4["group"]
    a_grid = np.geomspace(0.5, 0.6, 5)
    kw = dict(box=BOX, nmesh=NMESH, eps=EPS, n_global=N, split=split,
              softening=SOFT, shortrange=tier)
    jres = jd.run_cosmological_domain(js, jc, a_grid, dom4["mesh"], **kw)
    tres = td.run_cosmological_domain(dom4["ts"], tc, a_grid, group, **kw)
    assert tres.force_evals == 5
    assert tres.exchange_overflow == int(jres.exchange_overflow)
    assert tres.bucket_overflow == int(jres.bucket_overflow)
    tpos, tvel, tmass, _ = domain_state_to_numpy(tres.state)
    np.testing.assert_array_equal(tmass, np.asarray(jres.state.mass))
    d = tpos - np.asarray(jres.state.pos)
    d -= BOX * np.round(d / BOX)
    drift = np.abs(tpos - np.asarray(js.pos))
    drift = np.minimum(drift, BOX - drift).max()
    tol = TIGHT * BOX if split == "none" else F32_TOL * drift
    assert np.abs(d).max() < tol
    vtol = TIGHT if split == "none" else F32_TOL
    assert _rel(tvel, np.asarray(jres.state.vel)) < vtol


# the subcycled runs' system: tests/test_domain.py's uniform 2048
# particles in an 80 Mpc box with the cosmology's particle mass, so that
# gravity, not the initial velocities, sets the velocities after four
# steps (a kick factor 1% off in one subcycle moves them by ~1e-3 of the
# largest; the float32 planes leave ~1e-6)
SUB_N, SUB_BOX, SUB_NMESH = 2048, 80.0, 32


def _sub_dom(tier):
    """The subcycled runs' system decomposed in both packages on four
    shards, on the tier's own slab grid."""
    from nbody.core import units as ju

    rng = np.random.default_rng(21)
    pos = rng.uniform(0.0, SUB_BOX, (SUB_N, 3))
    rho_crit = 3.0 * JCFG.cosmology().H0**2 / (8.0 * np.pi * ju.COSMO.G)
    pmass = rho_crit * JCFG.cosmology().Omega_m * SUB_BOX**3 / SUB_N
    arrs = (pos, rng.normal(0.0, 0.004 * SUB_BOX, (SUB_N, 3)),
            np.full(SUB_N, pmass), 0.5)
    group = t_mesh(4, device="cpu")
    xgrid = td.slab_grid(td.domain_p3m_geometry(SUB_BOX, SUB_NMESH, 4,
                                                SUB_N), tier)
    js = jd.domain_decompose(_jstate(arrs), j_mesh(4), SUB_BOX, ncell=xgrid)
    ts = td.domain_decompose(state_from_numpy(*arrs, device="cpu",
                                              dtype=F64), group, SUB_BOX,
                             ncell=xgrid)
    return js, ts, group


@pytest.mark.parametrize("tier,n_sub,capacity", [("cells", 3, None),
                                                 ("supercell", 2, 256)])
def test_run_cosmological_domain_subcycled_matches_jax(tier, n_sub,
                                                       capacity):
    """The subcycled domain runner, four steps on four shards: every
    subcycle drift migrating, and on the supercell tier the last subcycle
    fused with the far field (part='split').  Slot for slot the JAX runner's particles: masses
    exact, positions to 1e-6 of the box, velocities to 2e-5 of the
    largest (float32 short-range planes in both packages), the same
    overflow words; the evaluations by kind."""
    jc, tc = _cosmos()
    js, ts, group = _sub_dom(tier)
    a_grid = np.geomspace(0.5, 0.6, 5)
    kw = dict(box=SUB_BOX, nmesh=SUB_NMESH, eps=0.1, n_global=SUB_N,
              split="spline", softening="spline", shortrange=tier,
              subcycles=n_sub, col_capacity=capacity)
    jres = jd.run_cosmological_domain(js, jc, a_grid, j_mesh(4), **kw)
    tres = td.run_cosmological_domain(ts, tc, a_grid, group, **kw)
    steps = len(a_grid) - 1
    fused = steps if tier == "supercell" else 0
    assert (tres.force_evals, tres.interior_evals, tres.fused_evals) == \
        (steps + 1, 1 + steps * n_sub - fused, fused)
    assert tres.exchange_overflow == int(jres.exchange_overflow) == 0
    assert tres.bucket_overflow == int(jres.bucket_overflow) == 0
    tpos, tvel, tmass, _ = domain_state_to_numpy(tres.state)
    np.testing.assert_array_equal(tmass, np.asarray(jres.state.mass))
    d = tpos - np.asarray(jres.state.pos)
    d -= SUB_BOX * np.round(d / SUB_BOX)
    assert np.abs(d).max() < 1e-6 * SUB_BOX
    assert _rel(tvel, np.asarray(jres.state.vel)) < F32_TOL


@pytest.mark.parametrize("D,order,interlace", [(2, 2, False), (4, 3, False),
                                               (4, 4, True)])
def test_measure_powerspec_domain_matches_jax(D, order, interlace):
    from nbody.distributed.measure import measure_powerspec_domain as jm
    from nbody_torch.distributed.measure import measure_powerspec_domain

    dom = _dom(D)
    edges = np.geomspace(0.01, 0.35, 13)
    kw = dict(box=BOX, nmesh=NMESH, n_global=N, edges=edges,
              window_order=order, interlace=interlace)
    jraw, jcorr = jm(dom["js"], dom["mesh"], **kw)
    raw, corr = measure_powerspec_domain(dom["ts"], dom["group"], **kw)
    for t, j in ((raw, jraw), (corr, jcorr)):
        np.testing.assert_array_equal(t.n_modes.numpy(), np.asarray(j.n_modes))
        assert _rel(t.power.numpy(), j.power) < TIGHT
        assert _rel(t.k.numpy(), j.k) < TIGHT


def test_peculiar_energies_domain_matches_jax(dom4):
    from nbody.diagnostics import layzer_irvine as jli
    from nbody_torch.diagnostics.layzer_irvine import (
        peculiar_energies_domain,
    )

    jc, tc = _cosmos()
    dom = dom4
    jli._self_potential_table(BOX, NMESH, 6)  # host-side, before tracing
    jT, jW = jax.jit(lambda p, v, m: jli.peculiar_energies_domain(
        JState(pos=p, vel=v, mass=m, time=0.5), jc, BOX, NMESH,
        dom["mesh"]))(dom["js"].pos, dom["js"].vel, dom["js"].mass)
    T, W = peculiar_energies_domain(dom["ts"], tc, BOX, NMESH, dom["group"])
    assert abs(float(T) - float(jT)) < TIGHT * abs(float(jT))
    assert abs(float(W) - float(jW)) < TIGHT * abs(float(jW))


# ---------------------------------------------------------------------------
# the driver's domain branch
# ---------------------------------------------------------------------------

PORT_DATA = __import__("os").path.join(
    __import__("os").path.dirname(__file__), "data", "torch_port")


@pytest.mark.parametrize("change,missing", [
    # the ring Ewald PP runs on several devices; the domain realization
    # of its ICs is not ported
    pytest.param(dict(solver="pp", ic_realization="domain"), "solver='pp'",
                 id="change0-solver='pp'"),
    # adaptive steps, subcycles and the domain ICs are ported: the run
    # completes
    pytest.param(dict(rungs=3, time_stepping="adaptive"), None,
                 id="change1-rungs >= 2"),
    pytest.param(dict(subcycles=2), None, id="change2-subcycles > 1"),
    pytest.param(dict(time_stepping="adaptive"), None,
                 id="change3-time_stepping='adaptive'"),
    pytest.param(dict(ic_realization="domain"), None,
                 id="change4-ic_realization='domain'"),
])
def test_domain_refusals_name_what_is_missing(change, missing, tmp_path):
    """What the domain branch refuses names what is missing; what it now
    runs (``missing`` None) completes a step at 16^3 on two shards."""
    from nbody_torch.driver import OutputConfig
    from nbody_torch.driver import SimulationConfig as TConfig
    from nbody_torch.driver.simulate import check_supported, run_simulation

    cfg = TConfig(n_side=16, devices=2).replace(**change)
    if missing is None:
        check_supported(cfg, "cpu")
        cfg = cfg.replace(a_begin=0.5, n_steps=1, step_dla_max=0.35,
                          output=OutputConfig(snapshot=False,
                                              energy_log=False,
                                              realization_correction=True))
        res = run_simulation(cfg, 0, str(tmp_path), device="cpu")
        assert res.state.pos.shape == (cfg.n_particles, 3)
        assert bool(torch.isfinite(res.state.vel).all())
        assert float(res.state.time) == pytest.approx(1.0)
        assert len(res.powerspecs) == 1
        return
    with pytest.raises(NotImplementedError, match="devices=2") as err:
        run_simulation(cfg, 0, str(tmp_path), device="cpu")
    assert missing in str(err.value)
    with pytest.raises(NotImplementedError, match="devices=2"):
        check_supported(cfg, "cpu")


def test_build_cosmo_force_refuses_several_devices():
    from nbody_torch.driver import SimulationConfig as TConfig
    from nbody_torch.driver.simulate import build_cosmo_force

    with pytest.raises(NotImplementedError, match="devices > 1"):
        build_cosmo_force(TConfig(n_side=16, devices=4), device="cpu")


@pytest.mark.parametrize("change", [
    dict(), dict(shortrange="supercell"), dict(shortrange="columns"),
    dict(solver="pm"), dict(n_side=64, box=500.0, pm_grid=128),
    dict(n_side=64, box=500.0, pm_grid=128, shortrange="columns"),
    dict(n_side=48, pm_grid=96, shortrange="supercell"),
])
@pytest.mark.parametrize("D", [2, 4, 3])
def test_domain_tier_and_geometry_match_jax(change, D):
    from nbody.driver.simulate import _domain_tier as j_tier
    from nbody_torch.driver import SimulationConfig as TConfig
    from nbody_torch.driver.simulate import _domain_tier as t_tier

    jcfg = JConfig(n_side=16).replace(**change)
    tcfg = TConfig.from_dict(jcfg.to_dict())
    assert t_tier(tcfg, D) == j_tier(jcfg, D)
    try:
        jg = tuple(jd.domain_p3m_geometry(jcfg.box, jcfg.mesh_size, D,
                                          jcfg.n_particles))[:-1]
    except ValueError:
        with pytest.raises(ValueError):
            td.domain_p3m_geometry(tcfg.box, tcfg.mesh_size, D,
                                   tcfg.n_particles)
        return
    assert tuple(td.domain_p3m_geometry(tcfg.box, tcfg.mesh_size, D,
                                        tcfg.n_particles)) == jg


def test_domain_run_matches_committed_jax_pk(tmp_path):
    """The 16^3 run on two shards from the JAX package's committed white
    noise (cells tier, 142 steps, float32 on the CPU): its sharded P(k)
    at a = 1 against the JAX package's domain run, bin by bin to 1e-3
    for k <= k_Nyq / 2, and the driver's run.log lines."""
    from nbody_torch.driver import OutputConfig as TOutput
    from nbody_torch.driver import SimulationConfig as TConfig
    from nbody_torch.driver.simulate import realize_ics, run_simulation
    from nbody_torch.io.powerspec import read_powerspec

    cfg = TConfig(n_side=16, devices=2, output=TOutput(snapshot=False))
    noise = np.load(f"{PORT_DATA}/white_noise_n16_seed0.npy")
    res = run_simulation(cfg, 0, str(tmp_path), device="cpu",
                         initial_state=realize_ics(cfg, 0, noise=noise,
                                                   device="cpu"))
    assert res.state.n == cfg.n_particles
    assert bool(torch.isfinite(res.state.pos).all())
    log = (tmp_path / "run.log").read_text()
    assert ("Domain decomposition: 2x1x1 (4 chaining cells, 2680 "
            "slots/device, bucket capacity 112, short-range tier cells)"
            in log)
    assert "Energy budget" in log and "(sharded)" in log
    assert f"Domain force evaluations: {142 + 5} on 2 shards" in log
    got = read_powerspec(res.powerspecs[-1])
    ref = read_powerspec(f"{PORT_DATA}/powerspec_a=1.00_n16_domain2_seed0")
    k_half = 0.5 * np.pi * cfg.mesh_size / cfg.box
    m = ref.k <= k_half
    np.testing.assert_array_equal(got.modes, ref.modes)
    assert np.abs(got.P[m] / ref.P[m] - 1.0).max() < 1e-3


def test_domain_checkpoint_resume_equals_straight_run(tmp_path):
    """A pure-PM domain run cut by an autosave and resumed ends where the
    straight run ends (the checkpoint goes through domain_gather and the
    resume through domain_decompose)."""
    from nbody_torch.driver import OutputConfig as TOutput
    from nbody_torch.driver import SimulationConfig as TConfig
    from nbody_torch.driver.simulate import run_simulation

    cfg = TConfig(n_side=8, pm_grid=32, solver="pm", n_steps=8, devices=2,
                  output=TOutput(snapshot=False, powerspec=False,
                                 energy_log=False))
    kw = dict(device="cpu", dtype=F64)
    straight = run_simulation(cfg, 3, str(tmp_path / "a"), **kw)
    run_simulation(cfg, 3, str(tmp_path / "b"), checkpoint_every_steps=4,
                   **kw)
    assert (tmp_path / "b" / "autosave" / "checkpoint.npz").exists()
    resumed = run_simulation(cfg, 3, str(tmp_path / "b"), resume=True, **kw)
    assert "start_idx=4" in (tmp_path / "b" / "run.log").read_text()

    def order(st):
        key = st.pos[:, 0] * 1e6 + st.pos[:, 1] * 1e3 + st.pos[:, 2]
        return st.pos[torch.argsort(key)]

    np.testing.assert_allclose(order(resumed.state).numpy(),
                               order(straight.state).numpy(), atol=1e-9)
