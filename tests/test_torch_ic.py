"""The torch port's cosmology, ICs and KDK factors against the JAX
package, on the CPU.

JAX's threefry and torch's Philox give different numbers for one seed,
so the ICs are compared from the JAX package's own white noise, handed
to the port.  The JAX ICs are float32 whatever the x64 setting (its noise
is drawn in float32), so the IC tolerances are float32's.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.core.cosmology import Cosmology as JCosmology
from nbody.ic.gaussian import GRFSpec as JSpec
from nbody.ic.zeldovich import lpt_ic as j_lpt_ic
from nbody.integrate.cosmo_stepping import (
    cosmo_kick_drift_factors as j_factors,
    log_a_steps as j_log_a_steps,
)
from nbody_torch.core.cosmology import Cosmology as TCosmology
from nbody_torch.ic.gaussian import GRFSpec as TSpec
from nbody_torch.ic.gaussian import gaussian_delta_k, white_noise_k
from nbody_torch.ic.zeldovich import lpt_ic as t_lpt_ic
from nbody_torch.integrate.cosmo_stepping import (
    cosmo_kick_drift_factors as t_factors,
    log_a_steps as t_log_a_steps,
)

COSMO = dict(h=0.7, omega_b=0.023, omega_cdm=0.11, A_s=2.3e-9, n_s=0.95)


def test_cosmology_host_functions():
    """Background, growth, transfer, P(k) and sigma8 agree in float64."""
    jc, tc = JCosmology(**COSMO), TCosmology(**COSMO)
    a = np.array([0.02, 0.1, 0.5, 1.0])
    k = np.geomspace(1e-4, 10.0, 64)
    for name in ("E", "H", "growth_D", "growth_f", "growth_D2"):
        np.testing.assert_allclose(getattr(tc, name)(a),
                                   np.asarray(getattr(jc, name)(jnp.asarray(a))),
                                   rtol=1e-12, err_msg=name)
    for transfer in ("eh", "bbks"):
        np.testing.assert_allclose(
            tc.linear_power(k, a=0.3, transfer=transfer),
            np.asarray(jc.linear_power(jnp.asarray(k), a=0.3, transfer=transfer)),
            rtol=1e-11, err_msg=transfer)
    assert abs(tc.sigma8() / float(jc.sigma8()) - 1.0) < 1e-11
    assert tc.growth_suppression == jc.growth_suppression
    assert tc.H0 == jc.H0 and tc.Omega_m == jc.Omega_m


def test_kick_drift_factors():
    """The same host numpy: equal to rounding."""
    grid = t_log_a_steps(0.02, 1.0, 12)
    np.testing.assert_array_equal(grid, j_log_a_steps(0.02, 1.0, 12))
    for got, want in zip(t_factors(TCosmology(**COSMO), grid),
                         j_factors(JCosmology(**COSMO), grid)):
        np.testing.assert_allclose(got, want, rtol=1e-14)


def _jax_noise(key, n):
    return np.asarray(jax.random.normal(key, (n, n, n), jnp.float32))


def test_gaussian_delta_k_from_noise():
    """delta(k) from the JAX noise matches JAX's gaussian_delta_k."""
    from nbody.ic.gaussian import gaussian_delta_k as j_gdk

    n, box = 16, 200.0
    key = jax.random.key(3)
    jc = JCosmology()
    want = j_gdk(key, JSpec(nmesh=n, box=box), lambda k: jc.linear_power(k))
    got = gaussian_delta_k(TSpec(nmesh=n, box=box),
                           lambda k: TCosmology().linear_power(k),
                           noise=_jax_noise(key, n), dtype=torch.float64,
                           device="cpu")
    want = np.asarray(want)
    # float32 noise and float32 JAX arithmetic on its side
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("order", [1, 2])
def test_lpt_ic_from_jax_noise(order):
    n, box, a0 = 16, 300.0, 0.02
    key = jax.random.key(11)
    jc, tc = JCosmology(**COSMO), TCosmology(**COSMO)
    want = j_lpt_ic(key, JSpec(nmesh=n, box=box),
                    lambda k: jc.linear_power(k), jc, a0, order=order)
    got = t_lpt_ic(TSpec(nmesh=n, box=box), lambda k: tc.linear_power(k), tc,
                   a0, order=order, noise=_jax_noise(key, n),
                   dtype=torch.float64, device="cpu")
    d = got.pos.numpy() - np.asarray(want.pos)
    d -= box * np.round(d / box)
    # float32 positions of magnitude box carry ~box * 6e-8 rounding
    assert np.abs(d).max() < 1e-5 * box
    vel = np.asarray(want.vel)
    np.testing.assert_allclose(got.vel.numpy(), vel, rtol=0,
                               atol=1e-5 * np.abs(vel).max())
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(want.mass), rtol=1e-6)
    assert float(got.time) == pytest.approx(a0)


@pytest.mark.parametrize("fn", [white_noise_k, gaussian_delta_k, t_lpt_ic])
def test_ic_entry_points_default_to_the_card(fn):
    """As the JAX functions run on the default device, the port's IC entry
    points build on the card unless the caller asks for the CPU (read from
    the signature: nothing is allocated on a card here)."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_white_noise_from_generator_is_reproducible():
    """One seed, one field: a CPU generator draws the same noise for every
    dtype, so float32 and float64 runs of a seed start alike."""
    w64 = white_noise_k(8, torch.Generator().manual_seed(5), device="cpu",
                        dtype=torch.float64)
    w32 = white_noise_k(8, torch.Generator().manual_seed(5), device="cpu",
                        dtype=torch.float32)
    assert w64.dtype == torch.complex128 and w32.dtype == torch.complex64
    np.testing.assert_allclose(w32.numpy(), w64.numpy(), rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        white_noise_k(8, noise=np.zeros((8, 8, 4)), device="cpu")


def test_tabulated_power_spectrum(tmp_path):
    """A tabulated transfer (two-column file, or a powerspec file's linear
    column) interpolates like the JAX package's table."""
    from nbody.core.cosmology import TabulatedPowerSpectrum as JTab
    from nbody_torch.core.cosmology import TabulatedPowerSpectrum as TTab
    from nbody_torch.io.powerspec import write_powerspec

    k = np.geomspace(1e-3, 2.0, 40)
    path = str(tmp_path / "pk.txt")
    np.savetxt(path, np.c_[k, JCosmology().linear_power(k)])
    ps = str(tmp_path / "powerspec_a=1.00")
    write_powerspec(ps, k, np.ones(40), k, k, JCosmology().linear_power(k))
    q = np.geomspace(1e-5, 50.0, 300)
    for jt, tt in ((JTab.from_file(path), TTab.from_file(path)),
                   (JTab.from_file(path, h=0.7, in_h_units=True),
                    TTab.from_file(path, h=0.7, in_h_units=True)),
                   (JTab.from_file(ps), TTab.from_file(ps))):
        np.testing.assert_allclose(tt(q), np.asarray(jt(jnp.asarray(q))),
                                   rtol=1e-12)


def test_run_cosmological_matches_jax():
    """The public integrators (plain and checked) with a PM force."""
    from nbody.core.types import ParticleState as JState
    from nbody.forces.pm import make_pm_cosmo_force as j_force
    from nbody.integrate.cosmo_stepping import run_cosmological as j_run
    from nbody_torch.convert import state_from_numpy
    from nbody_torch.forces.pm import make_pm_cosmo_force as t_force
    from nbody_torch.integrate.cosmo_stepping import (
        run_cosmological as t_run,
        run_cosmological_checked as t_run_checked,
    )

    rng = np.random.default_rng(4)
    pos, vel = rng.uniform(0, 100.0, (300, 3)), rng.normal(0, 5.0, (300, 3))
    mass = np.full(300, 3.0)
    grid = t_log_a_steps(0.1, 0.5, 5)
    jc, tc = JCosmology(**COSMO), TCosmology(**COSMO)
    want = j_run(JState.create(pos, vel, mass, 0.1, dtype=jnp.float64), jc,
                 grid, j_force(jc, 100.0, 16), 100.0)
    st = state_from_numpy(pos, vel, mass, 0.1, device="cpu", dtype=torch.float64)
    got = t_run(st, tc, grid, t_force(tc, 100.0, 16, device="cpu",
                                      dtype=torch.float64), 100.0)
    pm = t_force(tc, 100.0, 16, device="cpu", dtype=torch.float64)
    checked, ov = t_run_checked(st, tc, grid, lambda p, m, a: (pm(p, m, a), 0),
                                100.0)
    assert ov == 0 and torch.equal(checked.pos, got.pos)
    d = got.pos.numpy() - np.asarray(want.pos)
    d -= 100.0 * np.round(d / 100.0)
    assert np.abs(d).max() < 1e-9 * 100.0
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel),
                               rtol=0, atol=1e-9 * np.abs(want.vel).max())
    assert float(got.time) == pytest.approx(0.5, rel=1e-15)
