"""The torch port's per-particle rung stepping against the JAX package, on
the CPU: the kick tables and the rung rules, run_cosmological_rungs from
one float64 state, and run_simulation with rungs on the dense tier (its
interior ticks on K6's two-plane form) and on the supercell tier (frozen
column plans, interior ticks on K5), with their "Rung population" lines;
and the staleness note of the frozen plans.

The geometry is tests/test_rungs.py's (12^3 particles, box 60 Mpc, mesh
32: a 5^3 cell grid and, on the supercell tier, a 4^2 column grid whose
skin covers a step's deepest-rung drift).  Both
packages run float64 states; their cell and column planes are float32,
which sets the supercell runs' tolerance (tests/test_torch_columns.py).
The JAX kernels run in Pallas interpret mode.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from nbody_torch.driver import SimulationConfig as TConfig
from nbody_torch.driver import run_simulation as t_run
from nbody_torch.driver import simulate as tsim
from nbody_torch.forces import p3m as tp3m
from nbody_torch.integrate import cosmo_stepping as tcs

# float64 states and float64 kernels: summation order only
RUN_RTOL = 1e-9
# the driver's interior kicks come from float32 cell planes in both
# packages: their rounding (a few 1e-7 of each kick, summed in another
# order) moves a close pair by up to ~2e-7 Mpc over the run, 3e-9 of the
# box
PLANE_RUN_RTOL = 1e-8
# the supercell runs' boundary forces come from float32 column planes
# too (tests/test_torch_columns.py)
COLUMN_RUN_RTOL = 1e-5
BOX, NMESH = 60.0, 32


@pytest.fixture(autouse=True)
def _clear_port_capacity_memory():
    yield
    tsim._CAPACITY_MEMORY.clear()


def test_kick_tables_and_rung_rules_match_jax():
    a_grid = np.geomspace(0.1, 0.5, 6)
    for n_rungs in (2, 3, 4):
        want = jcs.rung_kick_tables(JCosmology(), a_grid, n_rungs)
        got = tcs.rung_kick_tables(TCosmology(), a_grid, n_rungs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-14, atol=0)
        for j in range(1, 2 ** (n_rungs - 1)):
            assert tcs.rung_active_min(j, n_rungs) == \
                jcs.rung_active_min(j, n_rungs)
    rng = np.random.default_rng(0)
    vel, gl, gs = (rng.normal(0.0, s, (500, 3)) for s in (30.0, 5.0, 50.0))
    cosmo = TCosmology()
    H0, Om, OL = float(cosmo.H0), float(cosmo.Omega_m), float(cosmo.Omega_L)
    for acc in (0.02, 0.0):
        want = jcs._rung_demand(jnp.asarray(vel), jnp.asarray(gl),
                                jnp.asarray(gs), 0.4, 1.25, 0.25, acc, H0,
                                Om, OL)
        t = [torch.tensor(x) for x in (vel, gl, gs)]
        s = [torch.tensor(x, dtype=torch.float64) for x in (0.4, 1.25, 0.25)]
        got = tcs._rung_demand(*t, *s, torch.tensor(acc, dtype=torch.float64)
                               if acc else None, H0, Om, OL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)
        step = float(np.median(np.asarray(want))) * 2.5
        for n_rungs in (2, 3):
            np.testing.assert_array_equal(
                tcs._assign_rungs(got, torch.tensor(step), n_rungs).numpy(),
                np.asarray(jcs._assign_rungs(want, step, n_rungs)))


def _cosmo_state(n, box, seed=3, vel_scale=0.004):
    """tests/test_rungs.py's state, in float64 numpy."""
    rho_crit = 3.0 * JCosmology().H0**2 / (8.0 * np.pi * ju.COSMO.G)
    pmass = float(rho_crit * JCosmology().Omega_m * box**3 / n)
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, box, (n, 3)), rng.normal(0, vel_scale * box, (n, 3)),
            np.full(n, pmass), np.float64(0.5))


def test_run_cosmological_rungs_matches_jax():
    """Two global steps with three rungs: the boundary ticks on the dense
    tier (split halves), the interior ticks on the two-plane cell kernel
    run on float64 copies of the float32 cell planes (each package's
    own); positions, velocities, overflow channels and histograms."""
    n = 12**3
    arrays = _cosmo_state(n, BOX)
    a_grid = np.geomspace(0.5, 0.6, 3)
    r_s, r_cut, ncell, cap = jp3m.p3m_short_params(BOX, NMESH, n)
    kw = dict(G=ju.COSMO.G, eps=0.1, split="spline", softening="spline")
    ckw = dict(nx=ncell, ncell=ncell, eps2=0.01, r_s=r_s, r_cut=r_cut,
               split="spline", softening="spline")

    def both_fn(p3m_acc):
        def both(pos, mass, a_s, a_l):
            gl, gs, ov = p3m_acc(pos, mass, BOX, NMESH, part="split",
                                 shortrange="allpairs", **kw)
            return gs / a_s, gl / a_l, ov

        return both

    def jmasked(pos, mass, act, a):
        plane_j, ov_j, K_j, _ = jp3m.build_padded_plane(pos, mass, BOX,
                                                        r_cut, ncell, cap)
        plane_i, ov_i, K_i, gidx = jp3m.build_padded_plane(
            pos, mass, BOX, r_cut, ncell, cap, valid=act)
        out = jp3m.run_cell_plane(plane_i.astype(jnp.float64), K=K_i,
                                  plane_j=plane_j.astype(jnp.float64),
                                  K_j=K_j, **ckw)
        rows = jnp.concatenate([out[:3].T, jnp.zeros((1, 3))], axis=0)
        return kw["G"] * rows[gidx] / a, ov_j, ov_i, jnp.int32(0)

    def tmasked(pos, mass, act, a):
        plane_j, ov_j, K_j, _, c_j = tp3m.build_padded_plane(
            pos, mass, BOX, r_cut, ncell, cap)
        plane_i, ov_i, K_i, gidx, c_i = tp3m.build_padded_plane(
            pos, mass, BOX, r_cut, ncell, cap, valid=act)
        out = tp3m.run_cell_plane(plane_i.double(), c_i, K=K_i,
                                  plane_j=plane_j.double(), K_j=K_j,
                                  counts_j=c_j, **ckw)
        rows = torch.cat([out[:3].T, torch.zeros((1, 3),
                                                 dtype=out.dtype)])
        return kw["G"] * rows[gidx] / a, ov_j, ov_i, 0

    rkw = dict(n_rungs=3, cell=BOX / NMESH, eta_disp=0.25, eta_acc=0.1,
               eps=0.1)
    want = jcs.run_cosmological_rungs(
        JState.create(*[jnp.asarray(a) for a in arrays], dtype=jnp.float64),
        JCosmology(), a_grid, None, None, jmasked, BOX,
        acc_both_fn=both_fn(jp3m.p3m_acc), **rkw)
    stats = {}
    got = tcs.run_cosmological_rungs(
        state_from_numpy(*arrays, device="cpu", dtype=torch.float64),
        TCosmology(), a_grid, both_fn(tp3m.p3m_acc), tmasked, BOX,
        stats=stats, **rkw)
    hists = np.asarray(want[-1])
    np.testing.assert_array_equal(got[-1], hists)
    assert hists[:, 1:].sum() > 0 and (hists.sum(axis=1) == n).all()
    assert [int(x) for x in got[1:6]] == [int(x) for x in want[1:6]]
    pos, vel, _, _ = state_to_numpy(got[0])
    d = pos - np.asarray(want[0].pos)
    d -= BOX * np.round(d / BOX)
    assert np.abs(d).max() <= RUN_RTOL * BOX
    wv = np.asarray(want[0].vel)
    assert np.abs(vel - wv).max() <= RUN_RTOL * np.abs(wv).max()
    assert stats["boundary_evals"] == 3 and stats["interior_evals"] > 0


def _rung_config(rungs, shortrange="auto", **kw):
    return JConfig(n_side=12, box=BOX, solver="p3m", pm_grid=NMESH,
                   n_steps=4, rungs=rungs, a_begin=0.2, a_end=0.3,
                   shortrange=shortrange,
                   output=JOutput(snapshot_times=(0.3,), powerspec_bins=8,
                                  powerspec=False, snapshot=False,
                                  energy_log=False), **kw)


def _run_both(jcfg, tmp_path, dtype):
    st = jsim.realize_ics(jcfg, 2)
    arrays = [np.asarray(x, np.float64) for x in (st.pos, st.vel, st.mass,
                                                  st.time)]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = j_run(jcfg, 2, str(tmp_path / "jax"), initial_state=JState.create(
        *[jnp.asarray(a) for a in arrays], dtype=jdt))
    got = t_run(TConfig.from_dict(jcfg.to_dict()), 2, str(tmp_path / "torch"),
                device="cpu", dtype=dtype,
                initial_state=state_from_numpy(*arrays, device="cpu",
                                               dtype=dtype))
    return want, got


def _log(run_dir, key):
    with open(os.path.join(run_dir, "run.log")) as f:
        return [line.rstrip() for line in f if key in line]


@pytest.mark.parametrize("rungs", [2, 3])
def test_dense_rung_run_matches_jax(tmp_path, rungs):
    """run_simulation with rungs on the dense tier (K1 boundaries, K6
    interior ticks): final state, pre-warm lines, rung populations."""
    jcfg = _rung_config(rungs)
    want, got = _run_both(jcfg, tmp_path, torch.float64)
    d = got.state.pos.numpy() - np.asarray(want.state.pos)
    d -= BOX * np.round(d / BOX)
    assert np.abs(d).max() <= PLANE_RUN_RTOL * BOX
    pops = _log(tmp_path / "torch", "Rung population")
    assert pops == _log(tmp_path / "jax", "Rung population")
    assert len(pops) == jcfg.n_steps and any(", " in p for p in pops)
    assert _log(tmp_path / "torch", "pre-warming") == \
        _log(tmp_path / "jax", "pre-warming")
    assert got.config_run.to_dict() == want.config_run.to_dict()


def supercell_rung_run_check(tmp_path, nmesh, frozen_fns):
    """run_simulation with rungs=3 on the supercell tier at mesh ``nmesh``
    in both packages: the port's frozen builder returns ``frozen_fns``
    functions, and the final positions, rung populations and healed
    config are the JAX package's."""
    jcfg = _rung_config(3, "supercell").replace(pm_grid=nmesh)
    tcfg = TConfig.from_dict(jcfg.to_dict())
    assert len(tsim.build_cosmo_force_frozen_both(tcfg)) == frozen_fns
    assert len(jsim.build_cosmo_force_frozen_both(jcfg)) == \
        {6: 7, 3: 3}[frozen_fns]
    want, got = _run_both(jcfg, tmp_path, torch.float32)
    d = got.state.pos.double().numpy() - np.asarray(want.state.pos)
    d -= BOX * np.round(d / BOX)
    assert np.abs(d).max() <= COLUMN_RUN_RTOL * BOX
    pops = _log(tmp_path / "torch", "Rung population")
    assert pops == _log(tmp_path / "jax", "Rung population")
    assert any(", " in p for p in pops)
    summary = _log(tmp_path / "torch", "Rung stepping")
    assert len(summary) == 1 and " 0 masked interior" not in summary[0]
    assert got.config_run.to_dict() == want.config_run.to_dict()


def test_supercell_rung_run_matches_jax(tmp_path):
    """Mesh 32 (S = 8 mesh cells a column): the skin covers a step's
    deepest-rung drift, so the boundaries ride frozen plans and the
    interior ticks K5."""
    supercell_rung_run_check(tmp_path, 32, 6)


def test_frozen_plan_staleness_note(tmp_path):
    """Five particles fast enough to outrun the plan's skin/2 within a
    step (rung-clamped on the deepest rung) stay within the JAX driver's
    note-only tolerance of max(16, N // 65536): run.log notes them, the
    run goes on, and the result keeps the largest noted count."""
    tcfg = TConfig.from_dict(_rung_config(3, "supercell").to_dict()).replace(
        n_steps=2)
    n = tcfg.n_particles
    skin = tsim._frozen_geometry(tcfg)[-1]
    a_grid = np.geomspace(tcfg.a_begin, tcfg.a_end, tcfg.n_steps + 1)
    dr = tcs.cosmo_kick_drift_factors(tcfg.cosmology(), a_grid)[1][0]
    rng = np.random.default_rng(4)
    vel = np.zeros((n, 3))
    # 1.5 skins of drift per step
    vel[:5] = rng.normal(size=(5, 3))
    vel[:5] *= 1.5 * skin / dr / np.linalg.norm(vel[:5], axis=1)[:, None]
    mass = tsim.realize_ics(tcfg, 0, device="cpu").mass.numpy()
    # a lattice at rest (no close pairs) but for the five
    side = np.arange(tcfg.n_side) * (BOX / tcfg.n_side)
    lattice = np.stack(np.meshgrid(side, side, side, indexing="ij"),
                       axis=-1).reshape(-1, 3)
    state = state_from_numpy(lattice, vel, mass, tcfg.a_begin, device="cpu")
    res = t_run(tcfg, 2, str(tmp_path), device="cpu", initial_state=state)
    notes = _log(tmp_path, "frozen-plan drift note")
    assert notes and not _log(tmp_path, "growing column skin")
    assert res.stale_max == 5 == max(int(x.split()[3]) for x in notes)
    assert res.stale_max <= tsim.stale_tolerance(tcfg)
    assert "at most 5 particles beyond skin/2" in \
        _log(tmp_path, "Rung stepping")[0]
