"""The torch port's mesh operations and PM force against the JAX package,
on the CPU, float64 (same seeded numpy inputs through both)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.core.cosmology import Cosmology as JCosmology
from nbody.forces import pm as jpm
from nbody.mesh import cic as jcic
from nbody.mesh import spectrum as jspec
from nbody_torch.core.cosmology import Cosmology as TCosmology
from nbody_torch.forces import pm as tpm
from nbody_torch.mesh import cic as tcic
from nbody_torch.mesh import spectrum as tspec

# float64 against float64: summation order only (scatter-add, FFT)
RTOL = 1e-10


def _particles(n=400, box=50.0, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, box, (n, 3)), rng.uniform(0.5, 1.5, n)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= rtol, err


@pytest.mark.parametrize("order", [2, 3, 4])
@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_bspline_deposit(order, shift):
    pos, mass = _particles()
    want = jcic.bspline_deposit(jnp.asarray(pos), 50.0, 16, order=order,
                                weights=jnp.asarray(mass), shift=shift)
    got = tcic.bspline_deposit(torch.tensor(pos), 50.0, 16, order=order,
                               weights=torch.tensor(mass), shift=shift)
    _close(got, want)
    # mass is conserved exactly by the assignment
    assert abs(float(got.sum()) - mass.sum()) < 1e-9 * mass.sum()


def test_cic_gather_round_trip():
    """Gather matches JAX; gathering a constant field returns it; the
    gather is the adjoint of the deposit (<deposit(w), f> = <w, gather(f)>)."""
    pos, w = _particles(seed=1)
    grid = np.random.default_rng(2).normal(size=(3, 16, 16, 16))
    tpos = torch.tensor(pos)
    for shift in (0.0, 0.5):
        want = jcic.cic_gather_vec(jnp.asarray(grid), jnp.asarray(pos), 50.0,
                                   shift=shift)
        got = tcic.cic_gather_vec(torch.tensor(grid), tpos, 50.0, shift=shift)
        _close(got, want)
    _close(tcic.cic_gather(torch.tensor(grid[0]), tpos, 50.0),
           jcic.cic_gather(jnp.asarray(grid[0]), jnp.asarray(pos), 50.0))
    ones = torch.full((16, 16, 16), 2.5, dtype=torch.float64)
    np.testing.assert_allclose(tcic.cic_gather(ones, tpos, 50.0).numpy(), 2.5,
                               rtol=1e-14)
    f = torch.tensor(grid[1])
    lhs = float((tcic.cic_deposit(tpos, 50.0, 16, weights=torch.tensor(w)) * f).sum())
    rhs = float((torch.tensor(w) * tcic.cic_gather(f, tpos, 50.0)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("order", [2, 4])
def test_interlaced_deposit_k(order):
    pos, mass = _particles(seed=3)
    want = jcic.bspline_deposit_interlaced_k(jnp.asarray(pos), 50.0, 16,
                                             order=order,
                                             weights=jnp.asarray(mass))
    got = tcic.bspline_deposit_interlaced_k(torch.tensor(pos), 50.0, 16,
                                            order=order,
                                            weights=torch.tensor(mass))
    _close(got, want)


def test_window_and_deconvolve():
    _close(tcic.cic_window(16, 50.0, p=4, dtype=torch.float64),
           jcic.cic_window(16, 50.0, p=4, dtype=jnp.float64))
    dk = np.random.default_rng(4).normal(size=(16, 16, 9)) + 0j
    _close(tcic.deconvolve(torch.tensor(dk), 16, 50.0, p=2),
           jcic.deconvolve(jnp.asarray(dk), 16, 50.0, p=2))
    np.testing.assert_array_equal(
        tcic.density_to_delta(torch.full((4, 4, 4), 2.0), 128).numpy(), 0.0)


@pytest.mark.parametrize("deconvolve_p,convention,window_order", [
    (0, "grid", 2), (1, "grid", 2), (1, "fac", 4), (2, "grid", 3),
])
def test_power_spectrum(deconvolve_p, convention, window_order):
    """P(k) of a Gaussian field against JAX: default log bins and the
    CONCEPT variable bins, real and Fourier input."""
    delta = np.random.default_rng(5).normal(size=(16, 16, 16))
    edges = jspec.concept_bin_edges(50.0, 16)
    np.testing.assert_array_equal(tspec.concept_bin_edges(50.0, 16), edges)
    for kw in (dict(n_bins=10), dict(edges=edges)):
        want = jspec.power_spectrum(jnp.asarray(delta), 50.0,
                                    deconvolve_p=deconvolve_p,
                                    convention=convention,
                                    window_order=window_order, **kw)
        got = tspec.power_spectrum(torch.tensor(delta), 50.0,
                                   deconvolve_p=deconvolve_p,
                                   convention=convention,
                                   window_order=window_order, **kw)
        for g, w in zip(got, want):
            _close(g, w)
    dk = torch.fft.rfftn(torch.tensor(delta))
    via_k = tspec.power_spectrum(dk, 50.0, n_bins=10, is_fourier=True)
    direct = tspec.power_spectrum(torch.tensor(delta), 50.0, n_bins=10)
    _close(via_k.power, direct.power, rtol=1e-14)


def test_power_spectrum_recovers_input_spectrum():
    """GRF -> P(k) round trip: a white field's measured power is flat at
    V / N^3 per mode within its mode-count scatter."""
    n, box = 32, 100.0
    delta = torch.tensor(np.random.default_rng(6).normal(size=(n, n, n)))
    res = tspec.power_spectrum(delta, box, n_bins=12)
    keep = res.n_modes > 200
    ratio = res.power[keep] / (box**3 / n**3)
    assert torch.all((ratio - 1.0).abs() < 5.0 / res.n_modes[keep].sqrt())


PM_CASES = [
    dict(),
    dict(interlace=True),
    dict(cell_centered=True),
    dict(grad_order="spectral"),
    dict(grad_order="fd2", deconvolve_p=0),
    dict(longrange_split=4.0),
    dict(spline_split=15.0),
]


@pytest.mark.parametrize("kw", PM_CASES, ids=lambda kw: ",".join(kw) or "default")
def test_pm_acc(kw):
    pos, mass = _particles(seed=7)
    want = jpm.pm_acc(jnp.asarray(pos), jnp.asarray(mass), 50.0, 16, G=1.7, **kw)
    got = tpm.pm_acc(torch.tensor(pos), torch.tensor(mass), 50.0, 16, G=1.7, **kw)
    _close(got, want)


def test_pm_acc_spline_interlaced_two_pass():
    """Spline split with interlacing: the two-pass gather of the JAX
    package's interlaced force grids (pm_force_grids_from_rho_pair).
    ``nbody.forces.pm.pm_acc`` itself gathers this case from the unshifted
    grid only; the port keeps the two-pass convention."""
    import math

    pos, mass = _particles(seed=9)
    jp, jm = jnp.asarray(pos), jnp.asarray(mass)
    amp = 4.0 * math.pi * 1.7 * mass.sum() / 50.0**3
    grids = jpm.pm_force_grids_from_rho_pair(
        jcic.cic_deposit(jp, 50.0, 16, weights=jm),
        jcic.cic_deposit(jp, 50.0, 16, weights=jm, shift=0.5),
        jnp.sum(jm), 50.0, 16, source_amp=amp, spline_split=15.0,
    )
    want = 0.5 * (jcic.cic_gather_vec(grids[:3], jp, 50.0)
                  + jcic.cic_gather_vec(grids[3:], jp, 50.0, shift=0.5))
    got = tpm.pm_acc(torch.tensor(pos), torch.tensor(mass), 50.0, 16, G=1.7,
                     spline_split=15.0, interlace=True)
    _close(got, want)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("split", [dict(spline_split=15.0),
                                   dict(longrange_split=2.0)])
def test_force_grids_from_rho(interlace, split):
    """PMForce.force_grids_from_rho against the JAX package's from-rho
    builders: pm_force_grids_from_rho, and pm_force_grids_from_rho_pair
    with the half-cell-shifted deposit."""
    import math

    pos, mass = _particles(seed=10)
    jp, jm = jnp.asarray(pos), jnp.asarray(mass)
    amp = 4.0 * math.pi * 1.7 * mass.sum() / 50.0**3
    rho = [jcic.cic_deposit(jp, 50.0, 16, weights=jm, shift=s)
           for s in ((0.0, 0.5) if interlace else (0.0,))]
    jkw = dict(source_amp=amp, **split)
    if interlace:
        want = jpm.pm_force_grids_from_rho_pair(*rho, jnp.sum(jm), 50.0, 16,
                                                **jkw)
    else:
        want = jpm.pm_force_grids_from_rho(rho[0], jnp.sum(jm), 50.0, 16,
                                           **jkw)
    pm = tpm.PMForce(50.0, 16, interlace=interlace, dtype=torch.float64,
                     **split)
    rho_t = [torch.tensor(np.asarray(r)) for r in rho]
    got = pm.force_grids_from_rho(rho_t[0], amp, float(mass.sum()),
                                  rho1=rho_t[1] if interlace else None)
    _close(got, want)


def test_pm_module_buffers_live_on_its_device():
    pm = tpm.PMForce(50.0, 16, interlace=True, grad_order="spectral",
                     spline_split=10.0, dtype=torch.float64)
    assert {name for name, _ in pm.named_buffers()} == {"green", "grad", "phase_read"}
    assert pm.green.shape == (16, 16, 9) and pm.green.dtype == torch.float64


@pytest.mark.parametrize("fn", [tpm.make_pm_cosmo_force, tpm.pm_module])
def test_pm_entry_points_default_to_the_card(fn):
    """Like the port's other entry points, the PM builders put their
    buffers on the card unless the caller passes ``device="cpu"``."""
    sig = inspect.signature(getattr(fn, "__wrapped__", fn))
    assert sig.parameters["device"].default == "cuda"


@pytest.mark.parametrize("interlace", [False, True])
def test_pm_cosmo_force(interlace):
    pos, mass = _particles(seed=8)
    jc, tc = JCosmology(), TCosmology()
    want = jpm.make_pm_cosmo_force(jc, 50.0, 16, interlace=interlace)(
        jnp.asarray(pos), jnp.asarray(mass), 0.3)
    got = tpm.make_pm_cosmo_force(tc, 50.0, 16, interlace=interlace,
                                  device="cpu", dtype=torch.float64)(
        torch.tensor(pos), torch.tensor(mass), 0.3)
    _close(got, want)
    want_phi = jpm.pm_potential_k(jnp.asarray(pos), jnp.asarray(mass), 50.0, 16)
    got_phi = tpm.pm_potential_k(torch.tensor(pos), torch.tensor(mass), 50.0, 16)
    _close(got_phi, want_phi)
