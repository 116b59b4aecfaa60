"""The torch port's block-sharded forces against the JAX package, on the
CPU: the ring all-pairs force, the ring Ewald force, the sharded PM and
the replicated-grid P3M, their refusals, the P3M's overflow word, and the
driver's ``solver='pp'`` run on several devices.

Inputs are made with numpy from a seed.  The JAX side runs its
``shard_map`` programs on the virtual CPU devices of tests/conftest.py,
jitted, with its Pallas kernels in interpret mode; the port drives D
shards from one process, all on the CPU, where its wrappers take their
kernels' plain versions.
"""

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import jax
import jax.numpy as jnp
from nbody.core import units as ju
from nbody.core.cosmology import Cosmology as JCosmology
from nbody.distributed import sharding as js
from nbody.ic import systems as jsys
from nbody_torch.core.cosmology import Cosmology as TCosmology
from nbody_torch.distributed import sharding as ts
from nbody_torch.distributed.collectives import ShardGroup
from nbody_torch.forces.p3m import p3m_acc, run_cell_plane

D = 4
F64 = torch.float64


def _group(n=D):
    return ts.device_mesh(n, device="cpu")


def _jsharded(mesh, *xs):
    sh = NamedSharding(mesh, P("shard"))
    return [jax.device_put(jnp.asarray(x), sh) for x in xs]


def _plummer(n, seed):
    st = jsys.plummer(n, seed=seed, dtype=jnp.float64)
    return np.asarray(st.pos), np.asarray(st.vel), np.asarray(st.mass)


def _t(x, dtype=F64):
    return torch.as_tensor(np.array(x), dtype=dtype)


# ---------------------------------------------------------------------------
# the ring all-pairs force
# ---------------------------------------------------------------------------


def test_ring_matches_jax_ring():
    """plummer(512) in float64 on four shards: acc and phi against the JAX
    ring (its own plain pair terms on the CPU) to rtol 1e-9, the JAX
    package's own limit for its ring against the dense oracle; the same
    algebra in another summation order reads ~1e-15."""
    pos, _, mass = _plummer(512, 0)
    eps, G = 0.05, 1.3
    mesh = js.device_mesh(D)
    want = jax.jit(js.make_ring_acc_fn(mesh, eps=eps, G=G))(
        *_jsharded(mesh, pos, mass))
    got = ts.make_ring_acc_fn(_group(), eps=eps, G=G)(_t(pos), _t(mass))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)


def test_ring_d2_equals_d4():
    """The same force on two and four shards (only the order in which
    the blocks' sums are added differs): rtol 1e-12 in float64."""
    pos, _, mass = _plummer(256, 5)
    out = [ts.make_ring_acc_fn(_group(d), eps=0.02)(_t(pos), _t(mass))
           for d in (2, 4)]
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


def test_ring_drive_matches_jax():
    """Forty KDK steps of plummer(256) through each ring (float64): the
    final positions agree to 1e-9 of the largest, and the port's drive
    conserves energy as the JAX package's test requires (1e-6)."""
    from nbody.integrate.leapfrog import run as jrun
    from nbody_torch.convert import state_from_numpy
    from nbody_torch.diagnostics.energy import kinetic_energy
    from nbody_torch.forces.allpairs import direct_potential
    from nbody_torch.integrate.leapfrog import run as trun

    pos, vel, mass = _plummer(256, 1)
    eps = 0.05
    mesh = js.device_mesh(D)
    jst = js.shard_state(jsys.plummer(256, seed=1, dtype=jnp.float64), mesh)
    jfin = jrun(jst, 1e-3, 40, js.make_ring_acc_fn(mesh, eps=eps))
    tst = state_from_numpy(pos, vel, mass, 0.0, device="cpu", dtype=F64)
    tfin = trun(tst, 1e-3, 40, ts.make_ring_acc_fn(_group(), eps=eps))
    scale = np.abs(pos).max()
    assert np.abs(tfin.pos.numpy() - np.asarray(jfin.pos)).max() <= 1e-9 * scale

    def energy(st):
        return float(kinetic_energy(st)
                     + direct_potential(st.pos, st.mass, eps=eps))

    assert abs(energy(tfin) / energy(tst) - 1.0) < 1e-6


def test_ring_refusals():
    """eps <= 0 raises when the force is built (the JAX ring builds, and
    its first call fails in Python: the self-pair term takes 0 ** -0.5),
    and use_pallas=False raises for shards that are not on the CPU, where
    it would switch the card to the plain version."""
    pos, _, mass = _plummer(64, 2)
    mesh = js.device_mesh(D)
    jring = js.make_ring_acc_fn(mesh, eps=0.0)
    with pytest.raises(ZeroDivisionError):
        jax.jit(jring)(*_jsharded(mesh, pos, mass))
    with pytest.raises(ValueError, match="eps > 0"):
        ts.make_ring_acc_fn(_group(), eps=0.0)
    with pytest.raises(ValueError, match="use_pallas=False"):
        ts.make_ring_acc_fn(ShardGroup([torch.device("cuda")] * D), eps=0.05,
                            use_pallas=False)
    # on the CPU the plain version is the route: use_pallas=False is it
    got = ts.make_ring_acc_fn(_group(), eps=0.05, use_pallas=False)(
        _t(pos), _t(mass))
    want = ts.make_ring_acc_fn(_group(), eps=0.05)(_t(pos), _t(mass))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="not divisible"):
        ts.make_ring_acc_fn(_group(3), eps=0.05)(_t(pos), _t(mass))


# ---------------------------------------------------------------------------
# the ring Ewald force
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("softening", ["plummer", "spline"])
def test_ring_ewald_matches_jax(softening):
    """N = 512 uniform in a 100 box, float32 in both: the largest
    per-particle difference within 2e-5 of max |acc|, the JAX package's
    limit for its ring Ewald against the single-device Ewald force
    (float32 sums in other orders)."""
    n, box = 512, 100.0
    rng = np.random.default_rng(41)
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mesh = js.device_mesh(D)
    want = np.asarray(jax.jit(js.make_ring_ewald_acc_fn(
        mesh, box, eps=0.5, softening=softening))(
            *_jsharded(mesh, pos, mass)), np.float64)
    got = ts.make_ring_ewald_acc_fn(_group(), box, eps=0.5,
                                    softening=softening)(
        _t(pos, torch.float32), _t(mass, torch.float32))
    assert got.dtype == torch.float32
    scale = np.linalg.norm(want, axis=1).max()
    err = np.linalg.norm(got.double().numpy() - want, axis=1) / scale
    assert err.max() < 2e-5


def test_ring_ewald_matches_single_device_in_float64():
    """The same sum as the single-device Ewald force (the dense tier on
    one device, the ring over four shards), float64: 1e-10 of max |acc|."""
    from nbody_torch.forces.ewald import ewald_pp_acc

    n, box = 256, 80.0
    rng = np.random.default_rng(3)
    pos, mass = _t(rng.uniform(0, box, (n, 3))), _t(rng.uniform(0.5, 2, n))
    got = ts.make_ring_ewald_acc_fn(_group(), box, eps=0.3, G=2.0)(pos, mass)
    ref = ewald_pp_acc(pos, mass, box, eps=0.3, G=2.0)
    assert float((got - ref).norm(dim=1).max() / ref.norm(dim=1).max()) < 1e-10


# ---------------------------------------------------------------------------
# the sharded PM and the replicated-grid P3M
# ---------------------------------------------------------------------------


def test_sharded_pm_matches_jax():
    """N = 1,024 uniform in a 500 box on a 16^3 mesh, float64 in both:
    1e-8 relative, the JAX package's limit for its sharded PM against
    one device (FFTs and deposits in other orders)."""
    box, nmesh, n = 500.0, 16, 1024
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, box, (n, 3))
    mass = np.full(n, 2.0)
    mesh = js.device_mesh(D)
    want = jax.jit(js.make_sharded_pm_cosmo_force(JCosmology(), box, nmesh,
                                                  mesh))(
        *_jsharded(mesh, pos, mass), jnp.asarray(0.5))
    got = ts.make_sharded_pm_cosmo_force(TCosmology(), box, nmesh, _group())(
        _t(pos), _t(mass), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                               atol=1e-12)


def _p3m_inputs(n=2048, box=80.0, seed=4):
    """The JAX package's sharded-P3M test: uniform particles of the
    critical density's mass, float32 (box 80, mesh 48: r_cut 9.375, an
    8-cell grid, two x-layers a shard on four)."""
    cosmo = JCosmology()
    rho_crit = 3.0 * cosmo.H0**2 / (8.0 * np.pi * ju.COSMO.G)
    pmass = float(rho_crit * cosmo.Omega_m * box**3 / n)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    return pos, np.full(n, pmass, np.float32)


def _rel(got, ref):
    return np.linalg.norm(got - ref, axis=-1) / np.maximum(
        np.linalg.norm(ref, axis=-1), 1e-12)


def test_sharded_p3m_matches_jax():
    """n = 2,048, box 80, mesh 48 on four shards, float32 planes in both:
    per particle relative difference with median < 1e-5 and max < 1e-4,
    the JAX package's limits for its sharded P3M against one device
    (float32 pair sums and FFTs in other orders), and the same limits
    against the port's single-device cells tier."""
    from nbody_torch.core import units as tu

    box, nmesh, a = 80.0, 48, 0.5
    pos, mass = _p3m_inputs()
    mesh = js.device_mesh(D)
    want = np.asarray(jax.jit(js.make_sharded_p3m_cosmo_force(
        JCosmology(), box, nmesh, mesh, eps=0.1, split="spline"))(
            *_jsharded(mesh, pos, mass), jnp.asarray(a, jnp.float32)),
        np.float64)
    before = run_cell_plane.launches
    fn = ts.make_sharded_p3m_cosmo_force(TCosmology(), box, nmesh, _group(),
                                         eps=0.1, split="spline")
    tp, tm = _t(pos, torch.float32), _t(mass, torch.float32)
    got = fn(tp, tm, a)
    assert run_cell_plane.launches == before  # the CPU takes no kernel
    assert got.dtype == torch.float32 and got.shape == (2048, 3)
    rel = _rel(got.double().numpy(), want)
    assert np.median(rel) < 1e-5 and rel.max() < 1e-4
    ref = p3m_acc(tp, tm, box, nmesh, G=tu.COSMO.G, eps=0.1,
                  shortrange="cells", split="spline") / a
    rel1 = _rel(got.double().numpy(), ref.double().numpy())
    assert np.median(rel1) < 1e-5 and rel1.max() < 1e-4


def test_sharded_p3m_geometry_matches_jax():
    """The cell grid rounds down to a multiple of D: 22 -> 20 at the 64^3
    config (five x-layers a shard), 11 -> 8 at the default 32^3 config
    (two), and too few cells raise in both packages."""
    assert ts.sharded_p3m_geometry(500.0, 128, 4)[2:] == (20, 5)
    assert ts.sharded_p3m_geometry(500.0, 64, 4)[2:] == (8, 2)
    with pytest.raises(ValueError, match="x-slabs"):
        ts.make_sharded_p3m_cosmo_force(TCosmology(), 50.0, 16, _group(8),
                                        eps=0.1)
    with pytest.raises(ValueError):
        js.make_sharded_p3m_cosmo_force(JCosmology(), 50.0, 16,
                                        js.device_mesh(8), eps=0.1)


def test_sharded_p3m_overflow_is_counted():
    """At capacity 8 (a mean of 4 particles a cell) the fullest cells
    spill.  The JAX function drops the spilled particles' short-range
    force without a word; the port returns the same force and, with
    checked=True, the number of particles dropped, which is > 0.  A
    dropped particle is missing from the plane as a target and as a
    source, so at least as many forces move (by > 1e-3) as particles
    were dropped."""
    box, nmesh, a = 80.0, 48, 0.5
    pos, mass = _p3m_inputs()
    mesh = js.device_mesh(D)
    kw = dict(eps=0.1, split="spline")
    want = np.asarray(jax.jit(js.make_sharded_p3m_cosmo_force(
        JCosmology(), box, nmesh, mesh, capacity=8, **kw))(
            *_jsharded(mesh, pos, mass), jnp.asarray(a, jnp.float32)),
        np.float64)
    tp, tm = _t(pos, torch.float32), _t(mass, torch.float32)
    got, ov = ts.make_sharded_p3m_cosmo_force(
        TCosmology(), box, nmesh, _group(), capacity=8, checked=True,
        **kw)(tp, tm, a)
    full, ov_full = ts.make_sharded_p3m_cosmo_force(
        TCosmology(), box, nmesh, _group(), checked=True, **kw)(tp, tm, a)
    assert int(ov_full) == 0 and int(ov) > 0
    rel = _rel(got.double().numpy(), want)
    assert np.median(rel) < 1e-5 and rel.max() < 1e-4
    lost = _rel(got.double().numpy(), full.double().numpy()) > 1e-3
    assert int(lost.sum()) >= int(ov)


def test_sharded_p3m_sixteen_cubed_matches_committed_jax():
    """At the JAX package's 16^3 ICs (committed with its output; four
    shards, the config's eps and split, a = a_begin), against the
    committed JAX output of make_sharded_p3m_cosmo_force: 2e-5 of max
    |g|, the JAX package's tier-vs-tier limit (float32 planes, sums in
    other orders)."""
    import os

    from nbody_torch.driver import SimulationConfig as TConfig
    from nbody_torch.driver.simulate import realize_ics

    data = os.path.join(os.path.dirname(__file__), "data", "torch_port")
    cfg = TConfig(n_side=16)
    pos, want = np.load(os.path.join(data, "sharded_p3m_n16_d4_seed0.npy"))
    mass = realize_ics(cfg, 0, device="cpu").mass
    got = ts.make_sharded_p3m_cosmo_force(
        cfg.cosmology(), cfg.box, cfg.mesh_size, _group(), eps=cfg.eps,
        split=cfg.force_split)(_t(pos, torch.float32), mass, cfg.a_begin)
    scale = np.linalg.norm(want, axis=1).max()
    err = np.linalg.norm(got.double().numpy() - want, axis=1).max() / scale
    assert err <= 2e-5


# ---------------------------------------------------------------------------
# the driver: solver='pp' on several devices
# ---------------------------------------------------------------------------


def test_driver_pp_multidevice_matches_jax(tmp_path):
    """run_simulation(solver='pp', devices=4) at 8^3 on the CPU from the
    JAX package's ICs against the JAX driver's devices=4 run (float32
    both, three steps): positions to atol 5e-3, the JAX package's limit
    for its ring run against one device."""
    from nbody.driver.config import OutputConfig as JOutput
    from nbody.driver.config import SimulationConfig as JConfig
    from nbody.driver.simulate import realize_ics as jics
    from nbody.driver.simulate import run_simulation as jrun
    from nbody_torch.convert import state_from_numpy
    from nbody_torch.driver import SimulationConfig as TConfig
    from nbody_torch.driver.simulate import run_simulation as trun

    jcfg = JConfig(n_side=8, box=200.0, solver="pp", n_steps=3, devices=4,
                   output=JOutput(dir="", snapshot=False, powerspec=False))
    ref = jrun(jcfg, seed=2, workdir="")
    st = jics(jcfg, 2)
    init = state_from_numpy(*(np.asarray(x) for x in (
        st.pos, st.vel, st.mass, st.time)), device="cpu")
    tcfg = TConfig.from_dict(jcfg.to_dict())
    res = trun(tcfg, 2, str(tmp_path), device="cpu", initial_state=init)
    assert res.state.n == tcfg.n_particles
    assert bool(torch.isfinite(res.state.pos).all())
    d = res.state.pos.double().numpy() - np.asarray(ref.state.pos)
    d -= tcfg.box * np.round(d / tcfg.box)
    assert np.abs(d).max() <= 5e-3


def test_build_cosmo_force_pp_ring():
    """The driver's PP force on four shards is the ring Ewald force; N
    must split over the devices, as in the JAX driver."""
    from nbody_torch.core import units as tu
    from nbody_torch.driver import SimulationConfig as TConfig
    from nbody_torch.driver.simulate import build_cosmo_force

    cfg = TConfig(n_side=8, box=200.0, solver="pp", devices=4)
    rng = np.random.default_rng(9)
    pos = _t(rng.uniform(0, 200.0, (512, 3)), torch.float32)
    mass = torch.full((512,), 3.0)
    g, ov = build_cosmo_force(cfg, device="cpu", checked=True)(pos, mass, 0.5)
    want = ts.make_ring_ewald_acc_fn(_group(), 200.0, cfg.eps, G=tu.COSMO.G,
                                     softening=cfg.softening_kernel)(pos,
                                                                     mass)
    assert ov == 0 and torch.equal(g, want / 0.5)
    with pytest.raises(ValueError, match="must divide"):
        build_cosmo_force(cfg.replace(devices=3), device="cpu")
