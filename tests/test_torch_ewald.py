"""The torch port's Ewald PP solver against the JAX package, on the CPU:
both halves of the force, the Ewald energy and its Layzer-Irvine
functional on the JAX tests' 24-particle system, the driver's PP force
and a short PP run.

float64; the JAX real-space half runs K1 as its own tests run it here
(Pallas interpret mode); the port's CPU tensors take K1's plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.core.types import ParticleState as JState
from nbody.diagnostics import layzer_irvine as jli
from nbody.driver.config import OutputConfig as JOutput
from nbody.driver.config import SimulationConfig as JConfig
from nbody.driver.simulate import build_cosmo_force as j_build_force
from nbody.driver.simulate import realize_ics as j_realize_ics
from nbody.driver.simulate import run_simulation as j_run
from nbody.forces import ewald as jew
from nbody.forces.pallas_pp import allpairs_pallas as j_allpairs
from nbody_torch.convert import state_from_numpy, state_to_numpy
from nbody_torch.core.cosmology import Cosmology as TCosmology
from nbody_torch.diagnostics import layzer_irvine as tli
from nbody_torch.driver import SimulationConfig as TConfig
from nbody_torch.driver.simulate import build_cosmo_force as t_build_force
from nbody_torch.driver.simulate import run_simulation as t_run
from nbody_torch.forces import ewald as tew
from nbody_torch.forces.pallas_pp import allpairs_pallas as t_allpairs

# float64 on both sides with the same algebra: summation order only
F64_RTOL = 1e-9


@pytest.fixture(scope="module")
def system():
    """tests/test_ewald.py's system."""
    rng = np.random.default_rng(42)
    n, box = 24, 100.0
    pos = rng.uniform(0, box, (n, 3))
    mass = rng.uniform(0.5, 2.0, (n,))
    return pos, mass, box


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _close(got, want, rtol=F64_RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


def test_half_space_modes_match_jax():
    for n_max in (3, 10):
        np.testing.assert_array_equal(tew._half_space_modes(n_max),
                                      jew._half_space_modes(n_max))
    assert len(tew._half_space_modes(10)) == 2084


@pytest.mark.parametrize("r_s,n_max", [(None, 10), (5.0, 14)])
def test_kspace_acc_matches_jax(system, r_s, n_max):
    pos, mass, box = system
    want = jew.ewald_kspace_acc(jnp.asarray(pos), jnp.asarray(mass), box,
                                G=2.0, r_s=r_s, n_max=n_max)
    got = tew.ewald_kspace_acc(_t(pos), _t(mass), box, G=2.0, r_s=r_s,
                               n_max=n_max)
    _close(got, want)


@pytest.mark.parametrize("eps,softening", [(0.0, "plummer"),
                                           (0.5, "plummer"),
                                           (0.5, "spline")])
def test_ewald_pp_acc_matches_jax(system, eps, softening):
    pos, mass, box = system
    want = jew.ewald_pp_acc(jnp.asarray(pos), jnp.asarray(mass), box,
                            eps=eps, G=1.0, softening=softening)
    got = tew.ewald_pp_acc(_t(pos), _t(mass), box, eps=eps, G=1.0,
                           softening=softening)
    _close(got, want)


def test_ewald_pp_is_periodic_and_beats_minimum_image(system):
    """The port's own physics checks: momentum conservation, and split
    invariance (the sum does not depend on r_s) where the nearest-image
    K7 is off by far more."""
    pos, mass, box = system
    tp, tm = _t(pos), _t(mass)
    a1 = tew.ewald_pp_acc(tp, tm, box, r_s=box / 16, n_max=10)
    a2 = tew.ewald_pp_acc(tp, tm, box, r_s=box / 20, n_max=14)
    rel = ((a1 - a2).norm(dim=1) / a1.norm(dim=1)).max()
    assert float(rel) < 1e-5
    net = (tm[:, None] * a1).sum(0).abs().max()
    assert float(net) < 1e-10 * float((tm[:, None] * a1.abs()).sum())
    a_mi, _ = t_allpairs(tp, tm, 1e-6, box=box)
    assert float(((a_mi - a1).norm(dim=1) / a1.norm(dim=1)).max()) > 1e-3


def test_ewald_potential_energy_matches_jax(system):
    pos, mass, box = system
    for r_s in (None, 8.0):
        want = jew.ewald_potential_energy(jnp.asarray(pos), jnp.asarray(mass),
                                          box, G=2.0, r_s=r_s)
        got = tew.ewald_potential_energy(_t(pos), _t(mass), box, G=2.0,
                                         r_s=r_s)
        assert float(got) == pytest.approx(float(want), rel=F64_RTOL)


def test_peculiar_energies_exact_matches_jax(system):
    pos, mass, box = system
    rng = np.random.default_rng(7)
    vel = rng.normal(0.0, 30.0, pos.shape)
    jst = JState.create(pos, vel, mass, 0.4, dtype=jnp.float64)
    tst = state_from_numpy(pos, vel, mass, 0.4, device="cpu",
                           dtype=torch.float64)
    want = jli.peculiar_energies_exact(jst, JConfig().cosmology(), box)
    got = tli.peculiar_energies_exact(tst, TCosmology(), box)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=F64_RTOL)


# tests/test_driver.py's TINY geometry with the PP solver
PP_TINY = JConfig(
    n_side=8, box=200.0, solver="pp", pm_grid=16, n_steps=3, a_begin=0.1,
    softening_kernel="plummer",
    output=JOutput(snapshot_times=(1.0,), powerspec_bins=8, snapshot=False),
)


def _ics64(jcfg):
    st = j_realize_ics(jcfg, 0)
    arrays = [np.asarray(x, np.float64) for x in (st.pos, st.vel, st.mass,
                                                  st.time)]
    return JState.create(*arrays, dtype=jnp.float64), arrays


def test_driver_pp_force_matches_jax():
    """build_cosmo_force's PP closure (checked and unchecked) at the 8^3
    ICs: the Ewald force over a, overflow 0."""
    jcfg = PP_TINY.replace(softening_kernel="spline")
    jst, arrays = _ics64(jcfg)
    a = float(arrays[3])
    want = j_build_force(jcfg)(jst.pos, jst.mass, a)
    tcfg = TConfig.from_dict(jcfg.to_dict())
    pos, mass = _t(arrays[0]), _t(arrays[2])
    got = t_build_force(tcfg, device="cpu", dtype=torch.float64)(pos, mass, a)
    _close(got, want)
    g, ov = t_build_force(tcfg, device="cpu", dtype=torch.float64,
                          checked=True)(pos, mass, a)
    assert ov == 0 and torch.equal(g, got)


def test_pp_run_matches_jax(tmp_path):
    """A 3-step PP run from a = 0.1 (Plummer softening) from one float64
    state: the final positions and velocities."""
    jst, arrays = _ics64(PP_TINY)
    want = j_run(PP_TINY, 0, str(tmp_path / "jax"), initial_state=jst)
    got = t_run(TConfig.from_dict(PP_TINY.to_dict()), 0,
                str(tmp_path / "torch"), device="cpu", dtype=torch.float64,
                initial_state=state_from_numpy(*arrays, device="cpu",
                                               dtype=torch.float64))
    pos, vel, _, _ = state_to_numpy(got.state)
    d = pos - np.asarray(want.state.pos)
    d -= PP_TINY.box * np.round(d / PP_TINY.box)
    assert np.abs(d).max() <= F64_RTOL * PP_TINY.box
    _close(vel, want.state.vel)
    assert got.config_run == got.config


def test_minimum_image_k7_matches_jax_at_box_scale(system):
    """K7's minimum image (the nearest-image PP tier) at box-scale
    separations, where the rounding of d / box decides the image."""
    pos, mass, box = system
    want = j_allpairs(jnp.asarray(pos), jnp.asarray(mass), eps=0.5, box=box,
                      ti=128, tj=256, interpret=True)
    got = t_allpairs(_t(pos), _t(mass), 0.5, box=box)
    for g, w in zip(got, want):
        _close(g, w)
