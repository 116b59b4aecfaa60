"""The torch port's adaptive time stepping against the JAX package, on the
CPU: the Gauss-Legendre kick tables, make_adaptive_cosmo_runner (plain
and subcycled with the fused boundary), make_adaptive_rung_runner on the
masked route and on the frozen-plan route (slack and binding demand),
the compact active-row kicks against the full-N kicks, the slab domain's
adaptive runner on four shards, the arrival at a_end from one float32 ulp
below it, and run_simulation with ``time_stepping='adaptive'`` (outputs
at the exact a, run.log, a resume from an adaptive checkpoint, the
refusal of subcycles without rungs on several devices).

The systems are tests/test_rungs.py's (512 to 1,500 particles with the
critical density's mass in an 80 Mpc box, mesh 32) with its cheap forces
in both packages: the dense tier's P3M split (plain jnp and torch ops
here), and for the interior ticks the short force masked to the active
rows.  The frozen route's "plan" is the freeze positions with the
identity slot table, the same in both packages, so the runners' control
flow (refreezes, staleness, compact slot gathers) is compared and not the
column kernels, which tests/test_torch_frozen.py and
tests/test_torch_rungs.py hold.  Float64 states in both packages: the
runners agree to summation order (RUN_RTOL).
"""

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.core import units as ju
from nbody.core.cosmology import Cosmology as JCosmology
from nbody.core.types import ParticleState as JState
from nbody.distributed import domain as jd
from nbody.distributed.sharding import device_mesh as j_mesh
from nbody.driver import run_simulation as j_run
from nbody.driver.config import OutputConfig as JOutput
from nbody.driver.config import SimulationConfig as JConfig
from nbody.forces import p3m as jp3m
from nbody.integrate import cosmo_stepping as jcs
from nbody_torch.convert import (
    domain_state_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from nbody_torch.core.cosmology import Cosmology as TCosmology
from nbody_torch.distributed import domain as td
from nbody_torch.distributed.sharding import device_mesh as t_mesh
from nbody_torch.driver import OutputConfig as TOutput
from nbody_torch.driver import SimulationConfig as TConfig
from nbody_torch.driver import run_simulation as t_run
from nbody_torch.driver import simulate as tsim
from nbody_torch.forces import p3m as tp3m
from nbody_torch.integrate import cosmo_stepping as tcs

# float64 states and forces in both packages: summation order only
RUN_RTOL = 1e-9
# the kick tables: both 16-point Gauss-Legendre in float64
TABLE_RTOL = 1e-12
# the domain runs' short forces come from float32 cell planes in both
# packages (tests/test_torch_domain_rungs.py)
F32_TOL = 2e-5
BOX, NMESH = 80.0, 32
EPS = 0.1


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


def _system(n, vel_scale, seed=4):
    """tests/test_rungs.py's system as float64 numpy (pos, vel, mass, a)."""
    rho = 3.0 * JCosmology().H0**2 / (8.0 * np.pi * ju.COSMO.G)
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, BOX, (n, 3)),
            rng.normal(0, vel_scale * BOX, (n, 3)),
            np.full(n, float(rho * JCosmology().Omega_m * BOX**3 / n)),
            np.float64(0.5))


def _jstate(arrays):
    return JState.create(*[jnp.asarray(a) for a in arrays],
                         dtype=jnp.float64)


def _tstate(arrays, dtype=torch.float64):
    return state_from_numpy(*arrays, device="cpu", dtype=dtype)


class Plan(NamedTuple):
    """A stand-in frozen plan: the freeze positions and the slot of each
    particle (the identity), so that a slot table is the per-particle
    force with a zero row appended."""
    x0: object
    gidx: object


def _forces(xp):
    """The forces of one package (``xp`` jnp or torch): checked, long,
    short, both, the masked cells-route form and the frozen-route
    seven."""
    J = xp is jnp
    p3m_acc = jp3m.p3m_acc if J else tp3m.p3m_acc
    kw = dict(G=ju.COSMO.G, eps=EPS, split="spline", softening="spline",
              shortrange="allpairs")
    zero = jnp.int32(0) if J else 0
    skin = 1.0

    def checked(pos, mass, a):
        g, ov = p3m_acc(pos, mass, BOX, NMESH, with_overflow=True, **kw)
        return g / a, ov

    def long_fn(pos, mass, a):
        return p3m_acc(pos, mass, BOX, NMESH, part="long", **kw) / a

    def short_fn(pos, mass, a):
        g, ov = p3m_acc(pos, mass, BOX, NMESH, part="short",
                        with_overflow=True, **kw)
        return g / a, ov

    def both_fn(pos, mass, a_s, a_l):
        gl, gs, ov = p3m_acc(pos, mass, BOX, NMESH, part="split", **kw)
        return gs / a_s, gl / a_l, ov

    def masked(pos, mass, act, a):
        g = short_fn(pos, mass, a)[0]
        return xp.where(act[:, None], g, 0.0 * g)

    def masked_fn(pos, mass, act, a):
        return masked(pos, mass, act, a), zero, zero, zero

    def drift2(pos, plan):
        d = pos - plan.x0
        d = d - BOX * xp.round(d / BOX)
        return xp.sum(d * d, -1)

    def freeze_fn(pos, mass):
        n = pos.shape[0]
        return Plan(pos, jnp.arange(n) if J else torch.arange(n))

    def both_frozen_fn(pos, mass, a_s, a_l, plan):
        return both_fn(pos, mass, a_s, a_l)

    def drift_ok_fn(pos, plan):
        return xp.max(drift2(pos, plan)) <= (0.25 * skin) ** 2

    def stale_fn(pos, plan):
        n = xp.sum(drift2(pos, plan) > (0.5 * skin) ** 2)
        return n.astype(jnp.int32) if J else n

    def fresh_plan_fn(pos, mass, a_s, a_l):
        return (*both_fn(pos, mass, a_s, a_l), freeze_fn(pos, mass))

    def buckets_fn(pos, mass, act, a, plan):
        g = masked(pos, mass, act, a)
        return xp.concatenate([g, 0.0 * g[:1]]), zero

    if J:
        def masked_frozen_fn(pos, mass, act, a, plan):
            return masked(pos, mass, act, a), zero

        frozen = (freeze_fn, both_frozen_fn, drift_ok_fn, masked_frozen_fn,
                  stale_fn, fresh_plan_fn, buckets_fn)
    else:
        def masked_frozen_fn(pos, mass, act, a, plan, buckets=False):
            if buckets:
                return buckets_fn(pos, mass, act, a, plan)
            return masked(pos, mass, act, a), zero

        frozen = (freeze_fn, both_frozen_fn, drift_ok_fn, masked_frozen_fn,
                  stale_fn, fresh_plan_fn)
    return dict(checked=checked, long=long_fn, short=short_fn,
                both=both_fn, masked=masked_fn, frozen=frozen)


JF, TF = _forces(jnp), _forces(torch)


def _close(got, want):
    """Positions (minimum image) and velocities of a port state against a
    JAX state, to RUN_RTOL."""
    pos, vel, _, _ = state_to_numpy(got)
    d = pos - np.asarray(want.pos)
    d -= BOX * np.round(d / BOX)
    assert np.abs(d).max() <= RUN_RTOL * BOX
    wv = np.asarray(want.vel)
    assert np.abs(vel - wv).max() <= RUN_RTOL * np.abs(wv).max()


def test_gl_int_and_rung_tables_match_jax():
    """_gl_int on arrays of intervals and _rung_tables_device for two,
    three and four rungs, float64, against the JAX package's."""
    cosmo = TCosmology()
    H0, Om, OL = float(cosmo.H0), float(cosmo.Omega_m), float(cosmo.Omega_L)
    lo, hi = np.array([0.02, 0.3, 0.5]), np.array([0.0206, 0.31, 0.56])

    def f(a):
        return 1.0 / (a**3 * H0 * (Om / a**3 + OL) ** 0.5)

    want = jax.jit(lambda x, y: jcs._gl_int(f, x, y, jnp.float64))(
        jnp.asarray(lo), jnp.asarray(hi))
    got = tcs._gl_int(f, torch.tensor(lo), torch.tensor(hi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TABLE_RTOL)
    tables = jax.jit(jcs._rung_tables_device, static_argnums=(2, 3, 4, 5, 6))
    for n_rungs in (2, 3, 4):
        want = tables(jnp.float64(0.5), jnp.float64(0.53), n_rungs, H0, Om,
                      OL, jnp.float64)
        got = tcs._rung_tables_device(torch.tensor(0.5, dtype=torch.float64),
                                      torch.tensor(0.53, dtype=torch.float64),
                                      n_rungs, H0, Om, OL)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=TABLE_RTOL, atol=0)
        # and the host trapezoid tables of the fixed grid, to theirs
        Fk, Dr, A_sub = tcs.rung_kick_tables(cosmo, [0.5, 0.53], n_rungs)
        np.testing.assert_allclose(got[2].numpy(), Fk[0], rtol=1e-6)
        np.testing.assert_allclose(got[4].numpy(), A_sub[0], rtol=1e-14)


@pytest.mark.parametrize("form", ["plain", "split"])
def test_adaptive_cosmo_runner_matches_jax(form):
    """Steps limited by the displacement demand from a = 0.5 to 0.53: the
    plain KDK, and two subcycles with the fused last subcycle; state,
    steps, the last step and the last histogram."""
    arrays = _system(512, 0.02)
    kw = dict(dla_max=0.03, eta_disp=0.25, n_rungs=3)
    if form == "split":
        kw.update(n_sub=2)
        jkw = dict(split_fns=(JF["long"], JF["short"]), acc_both_fn=JF["both"])
        tkw = dict(split_fns=(TF["long"], TF["short"]), acc_both_fn=TF["both"])
    else:
        jkw = tkw = {}
    jrun = jcs.make_adaptive_cosmo_runner(JCosmology(), JF["checked"], BOX,
                                          BOX / NMESH, max_steps=64, **kw,
                                          **jkw)
    trun = tcs.make_adaptive_cosmo_runner(TCosmology(), TF["checked"], BOX,
                                          BOX / NMESH, **kw, **tkw)
    want = jrun(_jstate(arrays), 0.53)
    stats = {}
    got = trun(_tstate(arrays), 0.53, stats=stats)
    _close(got[0], want[0])
    assert got[1] == int(want[1]) >= 3 and got[2] == int(want[2]) == 0
    assert got[3] == pytest.approx(float(want[3]), rel=RUN_RTOL)
    assert got[3] < 0.03 and got[4] == np.asarray(want[4]).tolist()
    assert float(got[0].time) == 0.53
    assert stats["step_reads"] == got[1]
    if form == "split":
        assert stats["both_evals"] == got[1] == stats["short_evals"] - 1
    else:
        assert stats["evals"] == got[1] + 1


def _rung_pair(arrays, a_end, route, active_capacity=0, **kw):
    """The adaptive rung runner of both packages from ``arrays`` to
    ``a_end``: (JAX result, port result, port stats)."""
    rkw = dict(dla_max=0.03, n_rungs=3, eps=EPS, **kw)
    jfrozen = JF["frozen"] if route == "frozen" else None
    tfrozen = TF["frozen"] if route == "frozen" else None
    jrun = jcs.make_adaptive_rung_runner(
        JCosmology(), None, None, JF["masked"], BOX, BOX / NMESH,
        max_steps=64, acc_both_fn=JF["both"], frozen_both_fns=jfrozen,
        active_capacity=active_capacity, **rkw)
    trun = tcs.make_adaptive_rung_runner(
        TCosmology(), TF["both"], TF["masked"], BOX, BOX / NMESH,
        frozen_both_fns=tfrozen, active_capacity=active_capacity, **rkw)
    stats = {}
    return (jrun(_jstate(arrays), a_end),
            trun(_tstate(arrays), a_end, stats=stats), stats)


@pytest.mark.parametrize("route", ["masked", "frozen"])
def test_adaptive_rung_runner_slack_demand_matches_jax(route):
    """tests/test_rungs.py's slack case: demand far above dla_max, every
    step dla_max and every particle on rung 0, both routes."""
    arrays = _system(512, 1e-5)
    a_end = float(np.exp(np.log(0.5) + 4 * 0.03))
    want, got, stats = _rung_pair(arrays, a_end, route, eta_disp=1e9,
                                  eta_acc=0.0)
    _close(got[0], want[0])
    assert got[1] == int(want[1]) == 4
    assert list(got[2:7]) == [int(x) for x in want[2:7]] == [0] * 5
    assert got[7] == pytest.approx(float(want[7]), rel=RUN_RTOL)
    assert got[8] == np.asarray(want[8]).tolist() == [512, 0, 0]
    assert stats["interior_evals"] == 0 and stats["boundary_evals"] == 5


@pytest.mark.parametrize("route", ["masked", "frozen"])
def test_adaptive_rung_runner_mixed_rungs_matches_jax(route):
    """tests/test_rungs.py's binding case with the acceleration criterion
    on: several rungs populated, interior ticks on both routes (on the
    frozen one with refreezes and stale particles)."""
    arrays = _system(512, 0.02)
    want, got, stats = _rung_pair(arrays, 0.52, route, eta_disp=0.25,
                                  eta_acc=0.1)
    _close(got[0], want[0])
    assert got[1] == int(want[1])
    assert list(got[2:7]) == [int(x) for x in want[2:7]]
    assert got[7] == pytest.approx(float(want[7]), rel=RUN_RTOL)
    assert got[8] == np.asarray(want[8]).tolist()
    assert stats["interior_evals"] > 0
    assert stats["step_reads"] == got[1]
    if route == "frozen":
        assert stats["refreezes"] > 0 and got[6] > 0
        assert stats["drift_reads"] == got[1]


def test_compact_kicks_match_full_kicks():
    """The compact active-row kicks on the frozen route: bit for bit the
    full-N kicks (adaptive and fixed grid), the JAX package's compact
    runner to RUN_RTOL, and a capacity below the active rows counts their
    excess on the target channel, as the JAX package's runner does
    (max over steps of the rows with rung >= 1 less the capacity)."""
    arrays = _system(512, 0.02)
    kw = dict(eta_disp=0.25, eta_acc=0.1)
    want, got, stats = _rung_pair(arrays, 0.52, "frozen",
                                  active_capacity=512, **kw)
    assert stats["interior_evals"] > 0
    _close(got[0], want[0])
    assert list(got[1:]) == [int(want[1]), *[int(x) for x in want[2:7]],
                             pytest.approx(float(want[7]), rel=RUN_RTOL),
                             np.asarray(want[8]).tolist()]
    full = tcs.make_adaptive_rung_runner(
        TCosmology(), TF["both"], TF["masked"], BOX, BOX / NMESH, eps=EPS,
        frozen_both_fns=TF["frozen"], **kw)(_tstate(arrays), 0.52)
    for name in ("pos", "vel", "time"):
        assert torch.equal(getattr(got[0], name), getattr(full[0], name))
    a_grid = np.geomspace(0.5, 0.515, 2)
    fixed = [tcs.run_cosmological_rungs(
        _tstate(arrays), TCosmology(), a_grid, TF["both"], TF["masked"], BOX,
        3, BOX / NMESH, eps=EPS, frozen_both_fns=TF["frozen"],
        active_capacity=cap, **kw) for cap in (0, 512, 4)]
    assert torch.equal(fixed[0][0].pos, fixed[1][0].pos)
    assert torch.equal(fixed[0][0].vel, fixed[1][0].vel)
    hists = fixed[2][-1]
    assert fixed[2][3] == hists[:, 1:].sum(axis=1).max() - 4 > 0
    assert fixed[0][3] == fixed[1][3] == 0


@pytest.mark.parametrize("rungs", [1, 2])
def test_domain_adaptive_runner_matches_jax(rungs):
    """run_cosmological_domain_adaptive on four shards from the same
    decomposed state (tests/test_torch_domain_rungs.py's system, mesh 32):
    two steps, the populations, channels, last step and the particles
    slot for slot."""
    n = 1500
    rho = 3.0 * JCosmology().H0**2 / (8.0 * np.pi * ju.COSMO.G)
    rng = np.random.default_rng(31)
    pos = rng.uniform(0.0, BOX, (n, 3))
    pos[:300] = np.mod(rng.normal(0.0, 3.0, (300, 3)) + [20.0, 50.0, 70.0],
                       BOX)
    vel = rng.normal(0.0, 0.004 * BOX, (n, 3))
    mass = np.full(n, rho * JCosmology().Omega_m * BOX**3 / n)
    D = 4
    geom = jd.domain_p3m_geometry(BOX, NMESH, D, n)
    mesh = j_mesh(D)
    js = jd.domain_decompose(
        JState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
               mass=jnp.asarray(mass), time=jnp.asarray(0.5)),
        mesh, BOX, ncell=geom.ncell)
    group = t_mesh(D, device="cpu")
    ts = td.domain_decompose(
        state_from_numpy(pos, vel, mass, 0.5, device="cpu",
                         dtype=torch.float64), group, BOX, ncell=geom.ncell)
    kw = dict(box=BOX, nmesh=NMESH, eps=1.0, n_global=n, split="spline",
              softening="plummer", rungs=rungs, dla_max=0.03,
              eta_disp=0.25, eta_acc=0.025, max_steps=2)
    want = jd.run_cosmological_domain_adaptive(js, JCosmology(), 0.6, mesh,
                                               **kw)
    got = td.run_cosmological_domain_adaptive(ts, TCosmology(), 0.6, group,
                                              **kw)
    assert got.n_steps == int(want.n_steps) == 2
    assert got.rung_hist == np.asarray(want.rung_hist).tolist()
    assert sum(got.rung_hist) == n and (rungs == 1 or got.rung_hist[1] > 0)
    for name in ("exchange_overflow", "bucket_overflow", "target_overflow",
                 "target_occupancy"):
        assert getattr(got, name) == int(getattr(want, name)), name
    assert got.dla_last == pytest.approx(float(want.dla_last), rel=1e-6)
    assert got.force_evals == 3 and got.step_reads == 2
    assert (got.interior_evals > 0) == (rungs > 1)
    tpos, tvel, tmass, tt = domain_state_to_numpy(got.state)
    np.testing.assert_array_equal(tmass, np.asarray(want.state.mass))
    assert float(tt) == pytest.approx(float(want.state.time), rel=1e-12)
    d = tpos - np.asarray(want.state.pos)
    d -= BOX * np.round(d / BOX)
    drift = np.abs(tpos - np.asarray(js.pos))
    drift = np.minimum(drift, BOX - drift).max()
    assert np.abs(d).max() < F32_TOL * drift
    wv = np.asarray(want.state.vel)
    assert np.abs(tvel - wv).max() < F32_TOL * np.abs(wv).max()


def test_one_ulp_below_a_end_arrives_exactly():
    """A float32 state one ulp below a_end: each runner takes one step and
    ends at a_end itself (exp(ln a0 + ln a_end - ln a0) can round an ulp
    short, which would take another step)."""
    a_end = 1.0
    t = float(np.nextafter(np.float32(a_end), np.float32(0.0)))
    arrays = _system(512, 0.004)[:3] + (np.float64(t),)
    runners = [
        tcs.make_adaptive_cosmo_runner(TCosmology(), TF["checked"], BOX,
                                       BOX / NMESH),
        tcs.make_adaptive_rung_runner(TCosmology(), TF["both"], TF["masked"],
                                      BOX, BOX / NMESH, eps=EPS),
        tcs.make_adaptive_rung_runner(TCosmology(), TF["both"], TF["masked"],
                                      BOX, BOX / NMESH, eps=EPS,
                                      frozen_both_fns=TF["frozen"],
                                      active_capacity=64),
    ]
    for run in runners:
        st = _tstate(arrays, torch.float32)
        assert float(st.time) == t < a_end
        out = run(st, a_end)
        assert out[1] == 1 and float(out[0].time) == a_end
        assert out[0].time.dtype == torch.float32
        assert bool(torch.isfinite(out[0].pos).all())
    group = t_mesh(2, device="cpu")
    shards = td.domain_decompose(_tstate(arrays, torch.float32), group, BOX,
                                 ncell=td.domain_p3m_geometry(
                                     BOX, NMESH, 2, 512).ncell)
    res = td.run_cosmological_domain_adaptive(
        shards, TCosmology(), a_end, group, box=BOX, nmesh=NMESH, eps=EPS,
        n_global=512, rungs=2)
    assert res.n_steps == 1 and all(float(s.time) == a_end
                                    for s in res.state)


def _adaptive_config(**kw):
    return JConfig(n_side=10, box=BOX, solver="p3m", pm_grid=NMESH,
                   a_begin=0.2, a_end=0.3, time_stepping="adaptive",
                   step_dla_max=0.05,
                   output=JOutput(snapshot_times=(0.25, 0.3),
                                  powerspec_bins=8, snapshot=False,
                                  energy_log=False), **kw)


def _log(run_dir, *keys):
    with open(os.path.join(run_dir, "run.log")) as f:
        return [line.rstrip() for line in f if any(k in line for k in keys)]


def test_driver_adaptive_run_matches_jax(tmp_path):
    """run_simulation with adaptive steps from the same float64 ICs: the
    P(k) files at a = 0.25 and 0.3 themselves (not snapped to a grid), the
    final state, the stretches' "Time step ... dln(a)" lines and the total,
    and a resume from the adaptive checkpoint at a = 0.25 that ends bit
    for bit where the uninterrupted run ended."""
    from nbody.driver import simulate as jsim

    jcfg = _adaptive_config()
    st = jsim.realize_ics(jcfg, 1)
    arrays = [np.asarray(x, np.float64) for x in (st.pos, st.vel, st.mass,
                                                  st.time)]
    want = j_run(jcfg, 1, str(tmp_path / "jax"), initial_state=_jstate(arrays))
    tcfg = TConfig.from_dict(jcfg.to_dict())
    got = t_run(tcfg, 1, str(tmp_path / "torch"), device="cpu",
                dtype=torch.float64, initial_state=_tstate(arrays),
                checkpoint_every_steps=1)
    _close(got.state, want.state)
    assert float(got.state.time) == 0.3
    assert [os.path.basename(p) for p in got.powerspecs] == \
        ["powerspec_a=0.25", "powerspec_a=0.30"]
    for p, q in zip(got.powerspecs, want.powerspecs):
        assert os.path.basename(p) == os.path.basename(q)
        np.testing.assert_allclose(np.loadtxt(p)[:, 2], np.loadtxt(q)[:, 2],
                                   rtol=1e-7)
    keys = ("dln(a)", "Total adaptive steps", "Reached a")
    tlog, jlog = _log(tmp_path / "torch", *keys), _log(tmp_path / "jax", *keys)
    strip = [line.split(" (")[0] for line in tlog]
    assert strip == [line.split(" (")[0] for line in jlog]
    assert tlog[-1].startswith("Total adaptive steps") and len(tlog) == 5
    # resume: the checkpoint of a = 0.25 carries grid_index -1 and a
    ckpt = tmp_path / "torch" / "autosave"
    resumed = t_run(tcfg, 1, str(tmp_path / "torch"), device="cpu",
                    dtype=torch.float64, resume=True)
    assert os.listdir(ckpt)
    assert torch.equal(resumed.state.pos, got.state.pos)
    assert torch.equal(resumed.state.vel, got.state.vel)
    assert "(adaptive stepping)" in _log(tmp_path / "torch", "nbody run")[-1]


def test_adaptive_subcycles_without_rungs_refused_on_devices():
    """devices > 1 with adaptive steps subdivides by rungs: subcycles
    without rungs raise ValueError, as in the JAX package, before any
    work; with rungs or one subcycle the domain runner takes it."""
    cfg = TConfig(n_side=8, devices=4, time_stepping="adaptive", subcycles=2)
    with pytest.raises(ValueError, match="rungs"):
        t_run(cfg, 0, None, device="cpu")
    with pytest.raises(ValueError, match="rungs"):
        j_run(JConfig.from_dict(cfg.to_dict()), 0, None)
    tsim.check_supported(cfg.replace(rungs=2), "cpu")
    tsim.check_supported(cfg.replace(subcycles=1), "cpu")
    tsim.check_supported(cfg.replace(devices=1, rung_active_capacity=64,
                                     rungs=3), "cpu")


def test_driver_heals_the_compact_capacity(tmp_path):
    """An adaptive rung run on the supercell tier's frozen plans with the
    compact kicks at a capacity of two rows: the driver doubles
    ``rung_active_capacity`` on the target channel, re-runs the stretch,
    and ends where the full-N run ends, bit for bit."""
    cfg = TConfig(n_side=12, box=60.0, pm_grid=32, a_begin=0.25,
                  a_end=0.265, rungs=3, shortrange="supercell",
                  time_stepping="adaptive",
                  output=TOutput(powerspec=False, snapshot=False,
                                 energy_log=False))
    assert len(tsim.build_cosmo_force_frozen_both(cfg)) == 6
    st = tsim.realize_ics(cfg, 0, device="cpu")
    # eight fast particles: rows on rungs >= 1 at every step
    vel = st.vel.clone()
    vel[:8] *= 6.0
    runs = [t_run(cfg.replace(rung_active_capacity=cap), 0,
                  str(tmp_path / str(cap)), device="cpu",
                  initial_state=st.replace(vel=vel)) for cap in (0, 2)]
    heals = _log(tmp_path / "2", "compact active-row overflow")
    assert heals and runs[1].config_run.rung_active_capacity > 2
    assert not _log(tmp_path / "0", "compact active-row overflow")
    assert torch.equal(runs[0].state.pos, runs[1].state.pos)
    assert torch.equal(runs[0].state.vel, runs[1].state.vel)
