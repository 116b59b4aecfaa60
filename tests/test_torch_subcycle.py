"""The torch port's split-Hamiltonian subcycled KDK against the JAX
package, on the CPU: run_cosmological_subcycled with one subcycle against
the plain KDK, with three on the dense tier (float64) and on the
supercell tier with frozen column plans and the fused boundary
evaluation (float32 planes in both packages), the driver's subcycled
run from the JAX noise's ICs, the slab domain's subcycled runner against one
device's, and the configurations that used to be refused.

The small system is tests/test_torch_rungs.py's (12^3 particles, box 60
Mpc, mesh 32: a 4^2 supercell column grid whose auto skin, 5% of r_cut,
fits the column side).  The JAX kernels run in Pallas interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from nbody.core import units as ju
from nbody.core.cosmology import Cosmology as JCosmology
from nbody.core.types import ParticleState as JState
from nbody.driver import run_simulation as j_run
from nbody.driver import simulate as jsim
from nbody.driver.config import OutputConfig as JOutput
from nbody.driver.config import SimulationConfig as JConfig
from nbody.forces import p3m as jp3m
from nbody.integrate import cosmo_stepping as jcs
from nbody_torch.convert import state_from_numpy, state_to_numpy
from nbody_torch.core.cosmology import Cosmology as TCosmology
from nbody_torch.distributed import domain as td
from nbody_torch.distributed.sharding import device_mesh as t_mesh
from nbody_torch.driver import OutputConfig as TOutput
from nbody_torch.driver import SimulationConfig as TConfig
from nbody_torch.driver import run_simulation as t_run
from nbody_torch.driver import simulate as tsim
from nbody_torch.forces import p3m as tp3m
from nbody_torch.integrate import cosmo_stepping as tcs

# float64 states and float64 kernels: summation order only
RUN_RTOL = 1e-9
# float32 column planes in both packages (tests/test_torch_rungs.py)
COLUMN_RUN_RTOL = 1e-5
BOX, NMESH = 60.0, 32


@pytest.fixture(autouse=True)
def _clear_port_capacity_memory():
    yield
    tsim._CAPACITY_MEMORY.clear()


def _cosmo_state(n, box, seed=3, vel_scale=0.004):
    """tests/test_rungs.py's state, in float64 numpy."""
    rho_crit = 3.0 * JCosmology().H0**2 / (8.0 * np.pi * ju.COSMO.G)
    pmass = float(rho_crit * JCosmology().Omega_m * box**3 / n)
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, box, (n, 3)),
            rng.normal(0, vel_scale * box, (n, 3)), np.full(n, pmass),
            np.float64(0.5))


def _split_fns(p3m_acc, **kw):
    """(long, short, both) of the dense tier's P3M force."""
    kw = dict(G=ju.COSMO.G, eps=0.1, split="spline", softening="spline",
              shortrange="allpairs", **kw)

    def long_fn(pos, mass, a):
        return p3m_acc(pos, mass, BOX, NMESH, part="long", **kw) / a

    def short_fn(pos, mass, a):
        g, ov = p3m_acc(pos, mass, BOX, NMESH, part="short",
                        with_overflow=True, **kw)
        return g / a, ov

    def both_fn(pos, mass, a_s, a_l):
        gl, gs, ov = p3m_acc(pos, mass, BOX, NMESH, part="split", **kw)
        return gs / a_s, gl / a_l, ov

    return long_fn, short_fn, both_fn


def _close(got, want, rtol):
    pos, vel, _, time_ = state_to_numpy(got)
    d = pos - np.asarray(want.pos)
    d -= BOX * np.round(d / BOX)
    assert np.abs(d).max() <= rtol * BOX
    wv = np.asarray(want.vel)
    assert np.abs(vel - wv).max() <= rtol * np.abs(wv).max()
    assert float(time_) == pytest.approx(float(want.time), rel=1e-6)


def test_subcycle_tables_and_one_subcycle_is_the_kdk():
    """The subcycle tables are the JAX scan's; with n_sub = 1 the split
    KDK (long and short kicks apart) is the plain KDK of their sum, to
    float64 rounding."""
    a_grid = np.geomspace(0.5, 0.6, 4)
    cosmo = TCosmology()
    Ks1, Drs, Ks2, A_sub = tcs.subcycle_tables(cosmo, a_grid, 3)
    for i in range(3):
        sub = np.geomspace(a_grid[i], a_grid[i + 1], 4)
        k1, dr, k2, _ = jcs.cosmo_kick_drift_factors(JCosmology(), sub)
        for got, want in ((Ks1[i], k1), (Drs[i], dr), (Ks2[i], k2),
                          (A_sub[i], sub[1:])):
            np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    arrays = _cosmo_state(8**3, BOX)
    long_fn, short_fn, _ = _split_fns(tp3m.p3m_acc)

    def full(pos, mass, a):
        g, ov = short_fn(pos, mass, a)
        return long_fn(pos, mass, a) + g, ov

    st = state_from_numpy(*arrays, device="cpu", dtype=torch.float64)
    want, _, _ = tcs.kdk_steps(st, cosmo, a_grid, full, BOX)
    stats = {}
    got, ov = tcs.run_cosmological_subcycled(st, cosmo, a_grid, long_fn,
                                             short_fn, BOX, 1, stats=stats)
    assert ov == 0
    assert stats["long_evals"] == stats["short_evals"] == len(a_grid)
    d = got.pos - want.pos
    d -= BOX * torch.round(d / BOX)
    assert float(d.abs().max()) <= 1e-12 * BOX
    assert float((got.vel - want.vel).abs().max()) <= \
        1e-12 * float(want.vel.abs().max())


def test_dense_subcycled_matches_jax():
    """Three subcycles a step over three steps on the dense tier (8^3
    particles), the last subcycle fused with the far field as the driver
    runs it, from one float64 state (the halves apart are held to the
    plain KDK above and, on the slab domain, below)."""
    arrays = _cosmo_state(8**3, BOX)
    a_grid = np.geomspace(0.5, 0.6, 4)
    jl, js, jb = _split_fns(jp3m.p3m_acc)
    tl, ts, tb = _split_fns(tp3m.p3m_acc)
    want, jov = jcs.run_cosmological_subcycled(
        JState.create(*[jnp.asarray(a) for a in arrays], dtype=jnp.float64),
        JCosmology(), a_grid, jl, js, BOX, 3, acc_both_fn=jb)
    stats = {}
    got, ov = tcs.run_cosmological_subcycled(
        state_from_numpy(*arrays, device="cpu", dtype=torch.float64),
        TCosmology(), a_grid, tl, ts, BOX, 3, acc_both_fn=tb, stats=stats)
    assert ov == int(jov) == 0
    _close(got, want, RUN_RTOL)
    # a fused and two short evaluations a step, plus a fused one first
    assert (stats["both_evals"], stats["short_evals"]) == (4, 6)
    assert stats["long_evals"] == 0


def _sub_config(shortrange, **kw):
    return JConfig(n_side=12, box=BOX, solver="p3m", pm_grid=NMESH,
                   n_steps=4, subcycles=3, a_begin=0.2, a_end=0.3,
                   shortrange=shortrange,
                   output=JOutput(snapshot_times=(0.3,), powerspec_bins=8,
                                  powerspec=False, snapshot=False,
                                  energy_log=False), **kw)


def test_supercell_frozen_subcycled_matches_jax():
    """The supercell tier as the driver builds it: interior subcycles on a
    frozen column plan (K4 frozen), the boundary tick fused (K2 + K3) on
    the same carried plan, refrozen when the drift predicate fails; one
    float32 state in both packages, over two steps (a close pair's
    float32 rounding grows ~10x a step here: 7e-7 of the largest velocity
    after two, 2e-4 after four)."""
    jcfg = _sub_config("supercell")
    tcfg = TConfig.from_dict(jcfg.to_dict())
    st = jsim.realize_ics(jcfg, 2)
    arrays = [np.asarray(x, np.float64) for x in (st.pos, st.vel, st.mass,
                                                  st.time)]
    a_grid = np.geomspace(0.2, 0.25, 3)
    jfz = jsim.build_cosmo_force_frozen(jcfg)
    want, jov = jcs.run_cosmological_subcycled(
        JState.create(*[jnp.asarray(a) for a in arrays], dtype=jnp.float32),
        jcfg.cosmology(), a_grid, *jsim.build_cosmo_force_split(jcfg), BOX,
        3, acc_both_fn=jsim.build_cosmo_force_both(jcfg), frozen_fns=jfz,
        frozen_both_fn=jsim.build_cosmo_force_frozen_both(jcfg)[1])
    tfz = tsim.build_cosmo_force_frozen(tcfg)
    assert tsim._frozen_geometry(tcfg)[0] == "supercell"
    stats = {}
    got, ov = tcs.run_cosmological_subcycled(
        state_from_numpy(*arrays, device="cpu", dtype=torch.float32),
        tcfg.cosmology(), a_grid, *tsim.build_cosmo_force_split(tcfg), BOX,
        3, acc_both_fn=tsim.build_cosmo_force_both(tcfg), frozen_fns=tfz,
        frozen_both_fn=tsim.build_cosmo_force_frozen_both(tcfg)[1],
        stats=stats)
    assert ov == int(jov) == 0
    _close(got, want, COLUMN_RUN_RTOL)
    assert stats["frozen_evals"] == 2 * 2 and stats["both_evals"] == 3
    assert stats["drift_reads"] == 3 * 2 and stats["refreezes"] > 0
    assert stats["long_evals"] == stats["short_evals"] == 0


def test_subcycled_run_matches_jax(tmp_path):
    """run_simulation with two subcycles at 16^3 from a = 0.3 for one
    step on the supercell tier (the fused tick, a subcycle on the frozen
    plan, the fused tick on the same plan), from the JAX ICs of the
    committed noise's draw, in both packages, float32 (the planes are
    float32 in both): the final positions and the evaluations by kind.
    One step keeps the file within its time (the JAX kernels' interpret
    mode takes about 3 s a step here); the hand-over from one step to the
    next is held above and, on the slab domain, in
    tests/test_torch_domain.py.  The dense tier's run is held to the JAX
    package's P(k) on the card (chip_smoke.py [22]); its plain pair sum
    takes 2 s an evaluation here."""
    subcycles, n_steps = 2, 1
    jcfg = JConfig(n_side=16, subcycles=subcycles, a_begin=0.3,
                   n_steps=n_steps, shortrange="supercell",
                   output=JOutput(powerspec=False, snapshot=False,
                                  energy_log=False))
    st = jsim.realize_ics(jcfg, 0)
    arrays = [np.asarray(x, np.float64) for x in (st.pos, st.vel, st.mass,
                                                  st.time)]
    want = j_run(jcfg, 0, str(tmp_path / "jax"), initial_state=JState.create(
        *[jnp.asarray(a) for a in arrays], dtype=jnp.float32))
    tcfg = TConfig.from_dict(jcfg.to_dict())
    got = t_run(tcfg, 0, str(tmp_path / "torch"), device="cpu",
                initial_state=state_from_numpy(*arrays, device="cpu",
                                               dtype=torch.float32))
    box = jcfg.box
    d = got.state.pos.double().numpy() - np.asarray(want.state.pos)
    d -= box * np.round(d / box)
    assert np.abs(d).max() <= COLUMN_RUN_RTOL * box
    with open(tmp_path / "torch" / "run.log") as f:
        line = [x for x in f if x.startswith("Subcycled stepping")]
    # a fused evaluation a step and one first, the other subcycles on the
    # frozen plan, a drift read before each evaluation on it
    assert len(line) == 1
    inner = n_steps * (subcycles - 1)
    assert f" {inner} frozen-plan short and {n_steps + 1} fused" in line[0]
    assert f" {n_steps * subcycles} host reads" in line[0]


def _domain_state(n, box, seed=21):
    """tests/test_domain.py's uniform system, in float64 numpy."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (n, 3))
    rho_crit = 3.0 * JCosmology().H0**2 / (8.0 * np.pi * ju.COSMO.G)
    pmass = float(rho_crit * JCosmology().Omega_m * box**3 / n)
    return pos, rng.normal(0.0, 0.004 * box, (n, 3)), np.full(n, pmass), 0.5


@pytest.mark.parametrize("tier,D,nmesh,steps,n_sub", [
    ("cells", 4, 48, 2, 3), ("supercell", 2, 32, 2, 2)])
def test_domain_subcycled_matches_one_device(tier, D, nmesh, steps, n_sub):
    """The domain's subcycled runner (every subcycle migrating; on the
    supercell tier the fused last subcycle) against the single-device run_cosmological_subcycled on the
    same discretization, as tests/test_domain.py holds the JAX package's
    (n = 2048, box 80; the cells tier at mesh 48 with three subcycles over
    two steps, the supercell tier at mesh 32, a 4^2 column grid, with two
    over two)."""
    n, box = 2048, 80.0
    arrays = _domain_state(n, box)
    cosmo = TCosmology()
    a_grid = np.geomspace(0.5, 0.6, steps + 1)
    state = state_from_numpy(*arrays, device="cpu", dtype=torch.float32)
    group = t_mesh(D, device="cpu")
    geom = td.domain_p3m_geometry(box, nmesh, D, n)
    ck = 256 if tier == "supercell" else None
    shards = td.domain_decompose(state, group, box,
                                 ncell=td.slab_grid(geom, tier))
    res = td.run_cosmological_domain(
        shards, cosmo, a_grid, group, box=box, nmesh=nmesh, eps=0.1,
        n_global=n, geom=geom, split="spline", subcycles=n_sub,
        shortrange=tier, col_capacity=ck)
    assert res.exchange_overflow == 0 and res.bucket_overflow == 0
    fused = steps if tier == "supercell" else 0
    assert (res.force_evals, res.interior_evals, res.fused_evals) == \
        (steps + 1, 1 + steps * n_sub - fused, fused)

    kw = dict(G=ju.COSMO.G, eps=0.1, split="spline", shortrange=tier,
              capacity=ck)

    def long_fn(pos, mass, a):
        return tp3m.p3m_acc(pos, mass, box, nmesh, part="long", **kw) / a

    def short_fn(pos, mass, a):
        g, ov = tp3m.p3m_acc(pos, mass, box, nmesh, part="short",
                             with_overflow=True, **kw)
        return g / a, ov

    def both_fn(pos, mass, a_s, a_l):
        gl, gs, ov = tp3m.p3m_acc(pos, mass, box, nmesh, part="split", **kw)
        return gs / a_s, gl / a_l, ov

    ref, ov = tcs.run_cosmological_subcycled(
        state, cosmo, a_grid, long_fn, short_fn, box, n_sub,
        acc_both_fn=both_fn if tier == "supercell" else None)
    assert ov == 0
    final = td.domain_gather(res.state)
    assert final.pos.shape[0] == n
    dist, idx = cKDTree(ref.pos.numpy()).query(final.pos.numpy())
    assert len(set(idx.tolist())) == n
    # float32 forces summed in other orders, and the supercell tier's
    # short half on its own chaining grid: tests/test_domain.py's limits
    assert dist.max() < 1e-3
    np.testing.assert_allclose(final.vel.numpy(), ref.vel.numpy()[idx],
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("solver", ["pm", "p3m"])
def test_formerly_refused_subcycles_run(solver, tmp_path):
    """subcycles > 1 no longer raises: the PM solver (which has no short
    range to subcycle) runs the plain KDK, P3M the subcycled one, at
    tests/test_torch_driver.py's tiny size."""
    cfg = TConfig(n_side=8, box=200.0, solver=solver, pm_grid=16, n_steps=4,
                  subcycles=2,
                  output=TOutput(snapshot_times=(0.3, 1.0), powerspec_bins=8,
                                 snapshot=False))
    tsim.check_supported(cfg, "cpu")
    res = t_run(cfg, 0, str(tmp_path), device="cpu")
    assert res.state.pos.shape == (cfg.n_particles, 3)
    assert bool(torch.isfinite(res.state.vel).all())
    assert float(res.state.time) == pytest.approx(1.0)
    with open(tmp_path / "run.log") as f:
        line = [x for x in f if x.startswith("Subcycled stepping")]
    assert len(line) == (solver == "p3m")
