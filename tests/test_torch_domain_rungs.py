"""The torch port's domain rung tier against the JAX package, on the CPU:
the frozen local column plans (freeze_local_column_plan, local_plan_stale),
K5's slab site (p3m_local_columns_frozen_masked) and K6's masked slab
site (make_domain_p3m_local(part="short_masked")), run_cosmological_domain
with rungs on both interior-tick routes, the driver's 16^3 two-shard rung
run against the JAX package's committed run, the driver's staleness heals
and the two hazards the port makes loud (a massive row outside its slab,
a drift past skin/2).

Inputs are made with numpy from a seed (float64 states in both
packages).  The JAX side runs on the 8-device CPU mesh of
tests/conftest.py, each function wrapped in ``jax.jit`` (its Pallas
kernels in interpret mode); the port drives D shards from one process on
the CPU.  Plans are equal exactly.  The two kernels' plain versions are
held to the JAX kernels on float64 copies of one plane (relative L2
1e-9: summation order only); the whole functions sum float32 planes in
both packages and are held to 2e-5 of the largest force (F32_TOL, as in
tests/test_torch_domain.py).
"""

import functools
import re

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import jax
import jax.numpy as jnp
from nbody.core.cosmology import Cosmology as JCosmology
from nbody.core.types import ParticleState as JState
from nbody.distributed import domain as jd
from nbody.distributed.sharding import device_mesh as j_mesh
from nbody.forces import p3m as jp3m
from nbody.forces import p3m_columns as jc
from nbody_torch.convert import domain_state_to_numpy, state_from_numpy
from nbody_torch.core import units
from nbody_torch.core.cosmology import Cosmology as TCosmology
from nbody_torch.distributed import domain as td
from nbody_torch.distributed.sharding import device_mesh as t_mesh
from nbody_torch.driver import simulate as tsim
from nbody_torch.forces import p3m as tp3m
from nbody_torch.forces import p3m_columns as tc

BOX, NMESH, N = 80.0, 48, 1500
# the whole functions and the runs ride mesh 32 (a 4^3 chaining grid):
# the JAX package's interpret-mode kernels take seconds a call on the 8^3
# grid of mesh 48
NMESH_RUN = 32
EPS, SPLIT, SOFT = 1.0, "spline", "plummer"
F64 = torch.float64
KERNEL_REL_L2 = 1e-9
# float32 planes in both packages, summed in other orders
F32_TOL = 2e-5
# column capacity that holds the dense clump's column, and one that
# spills; a z-window as wide as the column (clamped to its stride)
CK, CK_TINY = 512, 128
WINDOW = 4096
# below the frozen-xy slack 0.49 (box / ncell - r_cut) = 0.306 Mpc
SKIN = 0.3
PORT_DATA = __import__("os").path.join(
    __import__("os").path.dirname(__file__), "data", "torch_port")


@pytest.fixture(autouse=True)
def _clear_port_capacity_memory():
    yield
    tsim._CAPACITY_MEMORY.clear()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's plain kernels on one thread: the tier-1 run shares the
    cores among its workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmap(fn, mesh, n_in, n_out):
    """jit(shard_map) over the JAX mesh, every argument and result split
    over the shards."""
    spec = P("shard")
    return jax.jit(jd._shard_map(
        fn, mesh=mesh, in_specs=(spec,) * n_in,
        out_specs=(spec,) * n_out if n_out > 1 else spec, check_vma=False))


def _state(dense: bool, seed=31):
    """A cosmological system in an 80 Mpc box: uniform particles and one
    clump, the critical-density mass, small random velocities that
    populate all three rungs, as numpy float64.  The dense clump fills one
    cell and one column with ~400 particles (the spills of the smallest
    column and target capacity, 128); the other spreads 300 over a few
    cells, where float32 trajectories of the two packages stay within
    float32 tolerances over the rung runs' two steps."""
    cosmo = JCosmology()
    rho = 3.0 * cosmo.H0**2 / (8.0 * np.pi * units.COSMO.G)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, BOX, (N, 3))
    if dense:
        pos[:400] = rng.normal(0.0, 1.5, (400, 3)) + [25.0, 55.0, 35.0]
    else:
        pos[:300] = np.mod(rng.normal(0.0, 3.0, (300, 3))
                           + [20.0, 50.0, 70.0], BOX)
    vel = rng.normal(0.0, 0.0005 * BOX, (N, 3))
    mass = np.full(N, rho * cosmo.Omega_m * BOX**3 / N)
    return pos, vel, mass, 0.5


_DOMS = {}


def _dom(D, dense=True, nmesh=NMESH):
    """The same decomposed state in both packages, D shards, on the
    chaining grid of mesh ``nmesh`` (once a module)."""
    if (D, dense, nmesh) not in _DOMS:
        pos, vel, mass, t = _state(dense)
        geom = jd.domain_p3m_geometry(BOX, nmesh, D, N)
        mesh = j_mesh(D)
        js = jd.domain_decompose(
            JState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                   mass=jnp.asarray(mass), time=jnp.asarray(t)),
            mesh, BOX, ncell=geom.ncell)
        group = t_mesh(D, device="cpu")
        ts = td.domain_decompose(
            state_from_numpy(pos, vel, mass, t, device="cpu", dtype=F64),
            group, BOX, ncell=geom.ncell)
        tgeom = td.domain_p3m_geometry(BOX, nmesh, D, N)
        _DOMS[(D, dense, nmesh)] = dict(D=D, mesh=mesh, group=group,
                                        geom=geom, tgeom=tgeom, js=js, ts=ts)
    return _DOMS[(D, dense, nmesh)]


def _lists(shards):
    return [s.pos for s in shards], [s.mass for s in shards]


def _drift(shards, frac, seed=5, rows=None):
    """Each shard's positions moved by frac * skin/2 in random directions
    (the first ``rows`` rows of each shard only, when given)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shards:
        u = rng.normal(size=tuple(s.pos.shape))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        step = frac * 0.5 * SKIN * u
        if rows is not None:
            step[rows:] = 0.0
        out.append(s.pos + torch.as_tensor(step))
    return out


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


_JFREEZE = {}


def _jfreeze(D, ck, nmesh=NMESH):
    """The JAX package's freeze_local_column_plan over D shards, jitted
    once a (D, ck, nmesh): the plans' fields concatenated over the
    shards."""
    if (D, ck, nmesh) not in _JFREEZE:
        geom = _dom(D, nmesh=nmesh)["geom"]

        def body(p, m):
            plan = jc.freeze_local_column_plan(
                p, m, box=BOX, r_cut=geom.r_cut, ncell=geom.ncell, n_dev=D,
                col_capacity=ck, window=WINDOW, axis_name="shard",
                skin=SKIN)
            return tuple(plan._replace(ov=plan.ov[None]))

        _JFREEZE[(D, ck, nmesh)] = _jmap(body, _dom(D, nmesh=nmesh)["mesh"],
                                         2, 8)
    return _JFREEZE[(D, ck, nmesh)]


def _port_plans(dom, ck, pos=None):
    geom = dom["geom"]
    p, m = _lists(dom["ts"])
    return tc.freeze_local_column_plan(
        p if pos is None else pos, m, box=BOX, r_cut=geom.r_cut,
        ncell=geom.ncell, group=dom["group"], col_capacity=ck, window=WINDOW,
        skin=SKIN)


# ---------------------------------------------------------------------------
# frozen local column plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D,ck", [(2, CK), (4, CK), (2, CK_TINY)])
def test_freeze_local_column_plan_matches_jax(D, ck):
    """Every field of every shard's plan equals the JAX package's: the
    integer fields exactly, pos0 bit for bit, and the word (nonzero at
    the spilling capacity)."""
    dom = _dom(D)
    js = dom["js"]
    want = _jfreeze(D, ck)(js.pos, js.mass)
    got = _port_plans(dom, ck)
    assert got[0]._fields == jc.LocalColumnPlan._fields
    for name, jfield in zip(jc.LocalColumnPlan._fields, want):
        parts = np.split(np.asarray(jfield), D)
        for d, plan in enumerate(got):
            g = getattr(plan, name)
            np.testing.assert_array_equal(g.reshape(parts[d].shape).numpy(),
                                          parts[d], err_msg=name)
    assert all(plan.pos0.dtype == torch.float32 for plan in got)
    assert (max(int(pl.ov) for pl in got) > 0) == (ck == CK_TINY)


@pytest.mark.parametrize("frac", [0.0, 0.99, 1.01])
def test_local_plan_stale_matches_jax(frac):
    """The staleness count of each shard at positions drifted by frac *
    skin/2 (40 rows a shard): 0 within the budget, 40 beyond it, as in
    the JAX package."""
    dom = _dom(2)
    js = dom["js"]
    jplans = _jfreeze(2, CK)(js.pos, js.mass)
    moved = _drift(dom["ts"], frac, rows=40)

    def body(p, *fields):
        plan = jc.LocalColumnPlan(*fields[:-1], ov=fields[-1][0])
        return jc.local_plan_stale(p, plan, BOX, SKIN)[None]

    want = np.asarray(_jmap(body, dom["mesh"], 9, 1)(
        jnp.asarray(torch.cat(moved).numpy()), *jplans))
    got = [int(tc.local_plan_stale(p, plan, BOX, SKIN))
           for p, plan in zip(moved, _port_plans(dom, CK))]
    assert got == want.tolist() == [0 if frac < 1.0 else 40] * 2


# ---------------------------------------------------------------------------
# K5's slab site: the masked column pair sum on a frozen local plane
# ---------------------------------------------------------------------------


def _jax_k5_slab(plane, ws, nch_act, cht, *, ncell, nxl, stride, W, maxch,
                 gz, chunk, eps, r_s, r_cut):
    """The JAX package's masked column kernel on a slab plane, launched as
    p3m_local_columns_frozen_masked launches it (interpret mode)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    Pn = ncell + 2
    ncol_l = nxl * ncell

    def i_map(ic, o2, *_):
        return (0, (ic // ncell + 1) * Pn + (ic % ncell + 1))

    def j_map(ic, o2, *_):
        return (0, (ic // ncell + o2 // 3) * Pn + (ic % ncell + o2 % 3))

    ws_tab = jc._smem_table(ws, ncol_l * 9, maxch)
    cht_tab = jc._smem_table(cht, ncol_l, maxch)
    cols = ws_tab.shape[1]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(ncol_l, 9),
        in_specs=[
            pl.BlockSpec((8, cols), lambda ic, o2, *_: (ic * 9 + o2, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((8, cols), lambda ic, o2, *_: (ic, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((8, stride), i_map, memory_space=pltpu.VMEM),
            pl.BlockSpec((8, stride), j_map, memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((8, stride), i_map, memory_space=pltpu.VMEM))
    return pl.pallas_call(
        functools.partial(jc._column_kernel_masked, ncell=ncell,
                          stride=stride, W=W, maxch=maxch, gz=gz,
                          chunk=chunk, eps2=eps**2, r_s=r_s, r_cut=r_cut,
                          split=SPLIT, softening=SOFT),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct(plane.shape, plane.dtype),
        interpret=True)(nch_act, ws_tab, cht_tab, plane, plane)


def _active(shards, frac, seed=9):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.uniform(size=s.mass.shape[0]) < frac)
            & (s.mass > 0) for s in shards]


@pytest.mark.parametrize("frac", [0.0, 0.99])
def test_k5_slab_plain_matches_jax_kernel(frac):
    """K5's slab site on the frozen planes of the two shards (of four)
    whose halos wrap around the box, at positions drifted by frac *
    skin/2, nx = ncell / D: the port's plain version against the JAX
    kernel on float64 copies of the same plane, at the interior columns'
    slots, restricted to the chunks that hold an active row."""
    dom = _dom(4)
    geom = dom["geom"]
    nxl = geom.ncell // 4
    CKq, gz, stride, W, maxch, chunk = tc.plane_geometry(BOX, geom.r_cut,
                                                         CK, WINDOW)
    plans = _port_plans(dom, CK)
    moved = _drift(dom["ts"], frac)
    mass = [s.mass for s in dom["ts"]]
    frozen = [tc._frozen_buf(p, m, pl, BOX, geom.r_cut, CKq, gz, stride)
              for p, m, pl in zip(moved, mass, plans)]
    planes = tc._local_plane_from_buf([b for b, _, _ in frozen], box=BOX,
                                      r_cut=geom.r_cut, ncell=geom.ncell,
                                      group=dom["group"], stride=stride)
    kw = dict(ncell=geom.ncell, stride=stride, W=W, maxch=maxch, gz=gz,
              chunk=chunk, eps=EPS, r_s=geom.r_s, r_cut=geom.r_cut)
    kernel = jax.jit(functools.partial(_jax_k5_slab, nxl=nxl, **kw))
    Pn = geom.ncell + 2
    ic = torch.arange(nxl * geom.ncell)
    pcol = (ic // geom.ncell + 1) * Pn + (ic % geom.ncell + 1)
    slots = (pcol[:, None] * stride + torch.arange(stride)).reshape(-1)
    listed = 0
    # the two shards whose halos wrap around the box
    for d, (a, pl, (_, interior, _), (plane, _)) in enumerate(zip(
            _active(dom["ts"], 0.05), plans, frozen, planes)):
        if d not in (0, 3):
            continue
        nch_act, cht = tc.active_chunk_table(a, pl, interior, CK=CKq,
                                             nx=nxl, **{k: kw[k] for k in (
                                                 "ncell", "gz", "maxch",
                                                 "chunk")})
        p64 = plane.double()
        got = tc.run_column_plane_masked(p64, pl.ws, nch_act, cht, nx=nxl,
                                         split=SPLIT, softening=SOFT, **kw)
        want = np.asarray(kernel(jnp.asarray(p64.numpy()),
                                 jnp.asarray(pl.ws.numpy()),
                                 jnp.asarray(nch_act.numpy()),
                                 jnp.asarray(cht.numpy())))
        g, wv = got[:3, slots].numpy(), want[:3, slots.numpy()]
        assert np.linalg.norm(g - wv) / np.linalg.norm(wv) <= KERNEL_REL_L2
        assert float(got[3:].abs().max()) == 0.0
        listed += int(nch_act.sum())
        assert int(nch_act.sum()) < int(pl.nch.sum())
    assert listed > 0


def test_frozen_masked_function_matches_jax():
    """The whole p3m_local_columns_frozen_masked (float32 planes in both
    packages) at positions drifted by 0.99 skin/2: forces to F32_TOL of
    the largest, the plans' words equal."""
    dom = _dom(2, nmesh=NMESH_RUN)
    geom, js = dom["geom"], dom["js"]
    jplans = _jfreeze(2, CK, NMESH_RUN)(js.pos, js.mass)
    moved = _drift(dom["ts"], 0.99)
    act = _active(dom["ts"], 0.05)
    kw = dict(box=BOX, eps=EPS, r_s=geom.r_s, r_cut=geom.r_cut,
              G=units.COSMO.G, ncell=geom.ncell, col_capacity=CK,
              window=WINDOW,
              split=SPLIT, softening=SOFT)

    def body(p, m, a, *fields):
        plan = jc.LocalColumnPlan(*fields[:-1], ov=fields[-1][0])
        g, ov = jc.p3m_local_columns_frozen_masked(
            p, m, a, plan, n_dev=2, axis_name="shard", **kw)
        return g, ov[None]

    jg, jov = _jmap(body, dom["mesh"], 11, 2)(
        jnp.asarray(torch.cat(moved).numpy()), js.mass,
        jnp.asarray(torch.cat(act).numpy()), *jplans)
    g, ovs = tc.p3m_local_columns_frozen_masked(
        moved, [s.mass for s in dom["ts"]], act, _port_plans(dom, CK),
        group=dom["group"], **kw)
    assert _max_rel(torch.cat(g).numpy(), jg) < F32_TOL
    assert [int(o) for o in ovs] == np.asarray(jov).tolist()
    assert float(torch.cat(g).abs().max()) > 0.0


# ---------------------------------------------------------------------------
# K6's masked slab site: the two-plane cell pair sum
# ---------------------------------------------------------------------------


def _masked_planes(dom, act, tcap=128):
    geom = dom["tgeom"]._replace(bucket_capacity=64)
    p, m = _lists(dom["ts"])
    kw = dict(box=BOX, r_cut=geom.r_cut, ncell=geom.ncell, group=dom["group"])
    return (geom, td.build_local_plane(p, m, capacity=geom.bucket_capacity,
                                       **kw),
            td.build_local_plane(p, m, capacity=tcap, valid=act, **kw))


def test_k6_masked_slab_plain_matches_jax_kernel():
    """K6's two-plane form on the slabs of the two shards (of four) whose
    halos wrap around the box (the active rows' plane against the slab's
    cell plane, nx = ncell / D): the port's plain version against the JAX
    kernel on float64 copies, at the real cells' slots."""
    dom = _dom(4)
    act = _active(dom["ts"], 0.1)
    geom, src, tgt = _masked_planes(dom, act)
    nxl = geom.ncell // 4
    kw = dict(nx=nxl, ncell=geom.ncell, eps2=EPS**2, r_s=geom.r_s,
              r_cut=geom.r_cut, split=SPLIT, softening=SOFT)
    K_j, K_i = src[0][2], tgt[0][2]
    kernel = jax.jit(functools.partial(jp3m.run_cell_plane, K=K_i, K_j=K_j,
                                       interpret=True, **kw))
    cells = tp3m._real_cells(nxl, geom.ncell, "cpu")
    slots = (cells[:, None] * K_i + torch.arange(K_i)[None, :]).reshape(-1)
    for d, ((pj, _, _, _, cj), (pi, _, _, _, ci)) in enumerate(zip(src,
                                                                 tgt)):
        if d not in (0, 3):  # the two shards whose halos wrap
            continue
        got = tp3m.run_cell_plane(pi.double(), ci, K=K_i,
                                  plane_j=pj.double(), K_j=K_j, counts_j=cj,
                                  **kw)
        want = np.asarray(kernel(jnp.asarray(pi.double().numpy()),
                                 plane_j=jnp.asarray(pj.double().numpy())))
        g, wv = got[:3, slots].numpy(), want[:3, slots.numpy()]
        assert np.linalg.norm(g - wv) / np.linalg.norm(wv) <= KERNEL_REL_L2
        assert float(got[3:].abs().max()) == 0.0


def test_short_masked_matches_jax():
    """make_domain_p3m_local(part='short_masked') on the same decomposed
    state: forces to F32_TOL of the largest, the source and target
    planes' spills and the densest active cell equal, shard by shard
    (a target capacity the clump spills)."""
    dom = _dom(2, nmesh=NMESH_RUN)
    js = dom["js"]
    act = _active(dom["ts"], 0.5)
    jc_, tcos = JCosmology(), TCosmology()
    geom_j = dom["geom"]._replace(bucket_capacity=64)
    geom_t = dom["tgeom"]._replace(bucket_capacity=64)
    kw = dict(split=SPLIT, softening=SOFT, part="short_masked",
              target_capacity=16)
    jloc = jd.make_domain_p3m_local(jc_, geom_j, EPS, **kw)

    def body(p, m, a):
        g, ov_j, ov_i, occ = jloc(p, m, a, 0.5)
        return g, ov_j[None], ov_i[None], occ[None]

    jout = _jmap(body, dom["mesh"], 3, 4)(
        js.pos, js.mass, jnp.asarray(torch.cat(act).numpy()))
    g, ov_j, ov_i, occ = td.make_domain_p3m_local(
        tcos, geom_t, EPS, group=dom["group"], **kw)(*_lists(dom["ts"]),
                                                      act, 0.5)
    assert _max_rel(torch.cat(g).numpy(), jout[0]) < F32_TOL
    for got, want in ((ov_j, jout[1]), (ov_i, jout[2]), (occ, jout[3])):
        assert [int(x) for x in got] == np.asarray(want).tolist()
    assert max(int(x) for x in ov_i) > 0  # the clump spills the targets
    inactive = ~torch.cat(act)
    assert float(torch.cat(g)[inactive].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# run_cosmological_domain with rungs
# ---------------------------------------------------------------------------

A_GRID = np.geomspace(0.5, 0.6, 3)
RUN_KW = dict(box=BOX, nmesh=NMESH_RUN, eps=EPS, n_global=N, split=SPLIT,
              softening=SOFT, rungs=3, eta_disp=0.05, eta_acc=0.025,
              target_capacity=128)


FROZEN_KW = dict(rung_frozen=True, col_window=WINDOW, column_skin=SKIN)


@pytest.fixture(scope="module", params=["masked", "frozen"])
def rung_runs(request):
    """Two steps of the domain rung runner from the same decomposed state
    on two shards, in both packages: the masked cell planes (K6's two-plane
    slab site) or frozen local plans (K5's slab site, at a skin the drift
    exceeds)."""
    dom = _dom(2, dense=False, nmesh=NMESH_RUN)
    kw = dict(RUN_KW, **(dict(FROZEN_KW, col_capacity=CK_TINY)
                         if request.param == "frozen" else {}))
    jres = jd.run_cosmological_domain(dom["js"], JCosmology(), A_GRID,
                                      dom["mesh"], **kw)
    tres = td.run_cosmological_domain(dom["ts"], TCosmology(), A_GRID,
                                      dom["group"], **kw)
    return request.param, dom, jres, tres


def test_domain_rung_run_matches_jax(rung_runs):
    """Rung populations and every overflow channel equal; the particles
    slot for slot, positions to F32_TOL of the largest drift and
    velocities to F32_TOL (the short-range forces come from float32
    planes in both packages)."""
    route, dom, jres, tres = rung_runs
    np.testing.assert_array_equal(tres.rung_hists, np.asarray(jres.rung_hists))
    assert (tres.rung_hists[:, 1:] > 0).all()
    assert tres.rung_hists.sum(axis=1).tolist() == [N, N]
    for name in ("exchange_overflow", "bucket_overflow", "target_overflow",
                 "target_occupancy", "plan_overflow", "plan_stale"):
        want = getattr(jres, name)
        assert getattr(tres, name) == (None if want is None else int(want)), \
            name
    if route == "frozen":
        # the clump spills the plans' capacity, and the drift the skin
        assert tres.plan_overflow >> 16 > 0 and tres.plan_stale > 0
        assert tres.plan_freezes == 2
    else:
        assert tres.target_occupancy > 0 and tres.plan_freezes == 0
    assert tres.force_evals == 3 and tres.interior_evals == 6
    tpos, tvel, tmass, _ = domain_state_to_numpy(tres.state)
    jpos = np.asarray(jres.state.pos)
    np.testing.assert_array_equal(tmass, np.asarray(jres.state.mass))
    d = tpos - jpos
    d -= BOX * np.round(d / BOX)
    drift = np.abs(tpos - np.asarray(dom["js"].pos))
    drift = np.minimum(drift, BOX - drift).max()
    assert np.abs(d).max() < F32_TOL * drift
    assert _max_rel(tvel, np.asarray(jres.state.vel)) < F32_TOL


def test_domain_rung_refusals_match_jax():
    """The JAX package's ValueErrors: frozen plans without a column
    capacity or a skin, rungs without a force split."""
    dom = _dom(2, dense=False, nmesh=NMESH_RUN)
    for change in (FROZEN_KW,
                   dict(FROZEN_KW, col_capacity=CK, column_skin=0.0),
                   dict(split="none")):
        kw = dict(RUN_KW, **change)
        with pytest.raises(ValueError):
            jd.run_cosmological_domain(dom["js"], JCosmology(), A_GRID,
                                       dom["mesh"], **kw)
        with pytest.raises(ValueError):
            td.run_cosmological_domain(dom["ts"], TCosmology(), A_GRID,
                                       dom["group"], **kw)


# ---------------------------------------------------------------------------
# the two hazards, made loud
# ---------------------------------------------------------------------------


def _planted(dom):
    """The decomposed state with one massive row of shard 0 moved into
    shard 1's slab and no exchange after it (as an exchange that
    disagreed with the freeze's cut would leave it)."""
    geom = dom["geom"]
    pos = [p.clone() for p in _lists(dom["ts"])[0]]
    row = int(torch.nonzero(dom["ts"][0].mass > 0)[0])
    pos[0][row, 0] = 1.5 * BOX / dom["D"]
    assert int(td._slab_of(pos[0][row:row + 1, 0], BOX, geom.ncell,
                           geom.ncell // dom["D"])) == 1
    return pos


def test_nonresident_massive_row_is_counted():
    """The port's freeze counts a massive row outside its shard's slab in
    the bucket field of the plan's word (the JAX package drops it with no
    count: a zero force), a sound plan reads 0, and the rung runner
    reports the planted row on its plan channel (a capacity and window
    that hold the clump, so that nothing else spills)."""
    dom = _dom(2)
    pos = _planted(dom)
    sound = _port_plans(dom, CK)
    planted = _port_plans(dom, CK, pos=pos)
    assert [int(p.ov) for p in sound] == [0, 0]
    assert int(planted[0].ov) >> 16 == 1 and int(planted[1].ov) == 0
    jplans = _jfreeze(2, CK)(jnp.asarray(torch.cat(pos).numpy()),
                             dom["js"].mass)
    assert np.asarray(jplans[-1]).tolist() == [0, 0]
    run_dom = _dom(2, nmesh=NMESH_RUN)
    shards = [s.replace(pos=p) for s, p in zip(run_dom["ts"],
                                               _planted(run_dom))]
    res = td.run_cosmological_domain(shards, TCosmology(), A_GRID[:2],
                                     run_dom["group"],
                                     **dict(RUN_KW, **FROZEN_KW,
                                            col_capacity=CK))
    assert res.plan_overflow == 1 << 16 and res.plan_freezes == 1


def _cfg(**change):
    from nbody_torch.driver import OutputConfig, SimulationConfig

    return SimulationConfig(n_side=16, rungs=3, a_begin=0.3, n_steps=6,
                            devices=2,
                            output=OutputConfig(snapshot=False)).replace(
                                **change)


def test_heal_domain_frozen_outcomes():
    """The frozen plans' heals: the word first (window, then capacity),
    staleness up to the tolerance kept, more grows the skin below the
    ceiling and heals it to 0 at the ceiling."""
    cfg = _cfg(pm_grid=48)
    geom = td.domain_p3m_geometry(cfg.box, cfg.mesh_size, 2, cfg.n_particles)
    smax = 0.49 * (cfg.box / geom.ncell - geom.r_cut)
    tol = tsim.stale_tolerance(cfg)
    heal = functools.partial(tsim.heal_domain_frozen, cfg, geom, 384, 640)
    ck, cw, skin, lines, kept = heal(1.0, 5, 999)
    assert (ck, cw, skin, kept) == (384, 1024, 1.0, 0) and "window" in lines[0]
    ck, cw, skin, lines, kept = heal(1.0, 3 << 16, 999)
    assert (ck, skin) == (768, 1.0) and "capacity" in lines[0]
    assert heal(1.0, 0, tol) == (384, 640, 1.0, [], tol)
    ck, cw, skin, lines, kept = heal(1.0, 0, tol + 1)
    assert skin == 1.5 and "growing" in lines[0] and kept == 0
    ck, cw, skin, lines, kept = heal(smax, 0, tol + 1)
    assert skin == 0.0 and "ceiling" in lines[0] and kept == 0
    assert heal(1.0, 0, 0) == (384, 640, 1.0, [], 0)


def test_heal_domain_doubles_the_cell_bucket():
    """The cells tier's bucket heal doubles the planes' 128-slot bucket:
    the JAX driver's doubling of a capacity of 64 leaves the bucket at
    128 and spends an attempt for nothing."""
    cfg = _cfg()
    geom = td.domain_p3m_geometry(cfg.box, cfg.mesh_size, 2,
                                  cfg.n_particles)._replace(
                                      bucket_capacity=64)
    geom, ck, cw, E, lines = tsim.heal_domain(cfg, "cells", geom, 0, 0, 64,
                                              68, 3)
    assert (geom.bucket_capacity, ck, cw, E) == (256, 0, 0, 128)
    assert "bucket capacity to 256" in lines[0] and "exchange" in lines[1]


def _run(cfg, tmp_path, name):
    from nbody_torch.driver.simulate import realize_ics, run_simulation

    noise = np.load(f"{PORT_DATA}/white_noise_n16_seed0.npy")
    work = tmp_path / name
    res = run_simulation(cfg, 0, str(work), device="cpu",
                         initial_state=realize_ics(cfg, 0, noise=noise,
                                                   device="cpu"))
    return res, (work / "run.log").read_text()


def test_staleness_at_the_ceiling_heals_to_the_cell_planes(tmp_path):
    """At mesh 48 the 16^3 two-shard rung run (a = 0.3 to 1 in 3 steps)
    starts its skin at the ceiling 1.91 Mpc, and hundreds of particles
    drift past skin/2: the driver heals column_skin to 0 and re-runs the
    segment on the masked cell planes; the run then equals a
    column_skin=0 run bit for bit."""
    res, log = _run(_cfg(pm_grid=48, n_steps=3), tmp_path, "auto")
    assert "frozen rung plans (skin 1.91" in log
    assert "at the geometric ceiling 1.91 — healing column_skin to 0" in log
    assert res.config_run.column_skin == 0.0 and res.stale_max == 0
    B, F, M = (int(x) for x in re.search(
        r"Domain rung stepping: (\d+) boundary, (\d+) frozen-plan interior "
        r"and (\d+) masked interior", log).groups())
    # the one segment ran twice: on the plans, then on the cell planes
    assert (B, F, M) == (8, M, M) and M > 0
    assert f"Capacity heals repeated {F} frozen-plan interior" in log
    cells, clog = _run(_cfg(pm_grid=48, n_steps=3, column_skin=0.0),
                       tmp_path, "cells")
    assert "frozen rung plans" not in clog
    assert torch.equal(res.state.pos, cells.state.pos)
    assert torch.equal(res.state.vel, cells.state.vel)


def _pops(log: str) -> np.ndarray:
    rows = [[int(x) for x in line.split("matter:")[1].split(",")]
            for line in log.splitlines() if "Rung population" in line]
    return np.array([r + [0] * (3 - len(r)) for r in rows])


def test_domain_rung_run_matches_committed_jax_run(tmp_path):
    """The 16^3 rung run (a = 0.3 to 1 in 6 steps) on two shards from the
    JAX package's committed white noise, float32 on the CPU, on the
    frozen route with one particle past skin/2 kept with a note (the JAX
    run logged the same one): its sharded P(k) at a = 1 against the JAX
    package's domain rung run to 1e-3 for k <= k_Nyq / 2, and its rung
    populations to 0.5% of N at every step."""
    from nbody_torch.io.powerspec import read_powerspec

    cfg = _cfg()
    res, log = _run(cfg, tmp_path, "run")
    assert ("Domain decomposition: 2x1x1 (4 chaining cells, 2680 "
            "slots/device, bucket capacity 112, short-range tier cells, "
            "frozen rung plans (skin 18.2, column capacity 384))") in log
    assert "frozen-plan drift note: 1 rung-clamped" in log
    assert "re-running" not in log and res.stale_max == 1
    assert res.config_run.rung_capacity == 128
    ref_pops = np.loadtxt(
        f"{PORT_DATA}/rung_population_n16_domain2_rungs3_seed0.txt",
        dtype=np.int64)[:, 1:]
    assert np.abs(_pops(log) - ref_pops).max() <= 0.005 * cfg.n_particles
    got = read_powerspec(res.powerspecs[-1])
    ref = read_powerspec(
        f"{PORT_DATA}/powerspec_a=1.00_n16_domain2_rungs3_seed0")
    m = ref.k <= 0.5 * np.pi * cfg.mesh_size / cfg.box
    np.testing.assert_array_equal(got.modes, ref.modes)
    assert np.abs(got.P[m] / ref.P[m] - 1.0).max() < 1e-3
