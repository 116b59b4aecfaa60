"""The torch port's Newtonian systems against the JAX package, on the CPU:
the IC constructors (same seed, same state), the conservation diagnostics,
the KDK leapfrog and the adaptive global step.

float64; the JAX all-pairs kernel runs as its own tests run it here
(Pallas interpret mode, ti=128, tj=256).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.core import units
from nbody.diagnostics import energy as jen
from nbody.forces.allpairs import direct_acc as j_direct_acc
from nbody.forces.pallas_pp import allpairs_pallas as j_allpairs
from nbody.ic import systems as jsys
from nbody.integrate import adaptive as jad
from nbody.integrate import leapfrog as jlf
from nbody_torch.diagnostics import energy as ten
from nbody_torch.forces.allpairs import direct_acc as t_direct_acc
from nbody_torch.forces.pallas_pp import allpairs_pallas as t_allpairs
from nbody_torch.ic import systems as tsys
from nbody_torch.integrate import adaptive as tad
from nbody_torch.integrate import leapfrog as tlf

# float64 runs of one state through both packages: only summation order
# differs, amplified over the steps
RUN_RTOL = 1e-10
EPS = 0.05


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same_state(got, want):
    """Bit for bit, in the same dtype."""
    for name in ("pos", "vel", "mass", "time"):
        g, w = _np(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _close(got, want, rtol=RUN_RTOL, scale=None):
    """Max |got - want| <= rtol * scale, the scale max |want| unless given
    (a sum that is zero by construction, such as the momentum of a state
    in its COM frame, is held to the scale of its terms)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    if scale is None:
        scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale


@pytest.mark.parametrize("build,kwargs", [
    ("two_body", {}),
    ("two_body", dict(e=0.7, m2=0.1)),
    ("solar_system", dict(seed=3)),
    ("plummer", dict(n=500, seed=2)),
    ("plummer", dict(n=64, seed=0, dtype="float64", scale_radius=0.5)),
    ("cold_collapse", dict(n=300, seed=1)),
    ("cold_collapse", dict(n=300, seed=1, virial_ratio=0.5)),
    ("two_galaxy_merger", dict(n=401, seed=1, mass_ratio=3.0)),
])
def test_ic_constructors_match_jax(build, kwargs):
    """The same seed gives the same state in both packages, with the
    JAX functions' dtype defaults."""
    jkw, tkw = dict(kwargs), dict(kwargs)
    if "dtype" in kwargs:
        jkw["dtype"] = getattr(jnp, kwargs["dtype"])
        tkw["dtype"] = getattr(torch, kwargs["dtype"])
    want = getattr(jsys, build)(**jkw)
    got = getattr(tsys, build)(**tkw, device="cpu")
    _same_state(got, want)


def test_kepler_period_matches_jax():
    assert tsys.kepler_period(1.3, 1.1) == jsys.kepler_period(1.3, 1.1)


def test_energy_diagnostics_match_jax():
    want = jsys.plummer(300, seed=4, dtype=jnp.float64)
    got = tsys.plummer(300, seed=4, dtype=torch.float64, device="cpu")
    _close(ten.kinetic_energy(got), jen.kinetic_energy(want))
    # zero by construction: held to the scale of the state (M = 1,
    # positions and speeds of order 1)
    for name in ("momentum", "angular_momentum", "center_of_mass"):
        _close(getattr(ten, name)(got), getattr(jen, name)(want), scale=1.0)
    for name in ("potential_energy", "total_energy", "virial_ratio"):
        _close(getattr(ten, name)(got, eps=EPS, G=2.0),
               getattr(jen, name)(want, eps=EPS, G=2.0))
    e = np.array([1.0, 1.01, 0.98, 1.005])
    assert float(ten.energy_drift(e)) == pytest.approx(
        float(jen.energy_drift(jnp.asarray(e))), rel=1e-15)


def test_potential_energy_chunked_above_4096():
    """Above 4,096 particles the chunked oracle gives E_pot."""
    st = tsys.plummer(4100, seed=1, dtype=torch.float64, device="cpu")
    dense = -0.5 * torch.sum(
        st.mass[:, None] * st.mass[None, :]
        * torch.where(torch.eye(st.n, dtype=torch.bool), 0.0, torch.rsqrt(
            ((st.pos[None] - st.pos[:, None]) ** 2).sum(-1) + EPS**2)))
    assert float(ten.potential_energy(st, eps=EPS)) == pytest.approx(
        float(dense), rel=1e-12)


def _plummer256():
    return (jsys.plummer(256, seed=0, dtype=jnp.float64),
            tsys.plummer(256, seed=0, dtype=torch.float64, device="cpu"))


def _j_acc(p, m):
    return j_allpairs(p, m, eps=EPS, ti=128, tj=256, interpret=True)


def _t_acc(p, m):
    return t_allpairs(p, m, EPS)


def test_run_matches_jax():
    jst, tst = _plummer256()
    want = jlf.run(jst, 1e-3, 40, _j_acc)
    got = tlf.run(tst, 1e-3, 40, _t_acc)
    for name in ("pos", "vel", "time"):
        _close(getattr(got, name), getattr(want, name))


def test_run_with_diagnostics_matches_jax():
    jst, tst = _plummer256()
    wfinal, wd0, wdiags = jlf.run_with_diagnostics(jst, 1e-3, 40, _j_acc,
                                                   diag_every=10)
    final, d0, diags = tlf.run_with_diagnostics(tst, 1e-3, 40, _t_acc,
                                                diag_every=10)
    _close(final.pos, wfinal.pos)
    _close(final.vel, wfinal.vel)
    assert diags.e_kin.shape == (4,) and diags.momentum.shape == (4, 3)
    for field in tlf.StepDiagnostics._fields:
        # momentum and COM are zero by construction: the state's scale
        scale = 1.0 if field in ("momentum", "com") else None
        _close(getattr(d0, field), getattr(wd0, field), scale=scale)
        _close(getattr(diags, field), getattr(wdiags, field), scale=scale)
    with pytest.raises(ValueError, match="multiple"):
        tlf.run_with_diagnostics(tst, 1e-3, 10, _t_acc, diag_every=3)


def test_run_adaptive_matches_jax():
    """The e = 0.7 Kepler orbit to t = 1 yr: the same number of steps,
    the same smallest and largest step and the same final state."""
    G = units.SOLAR.G
    want = jad.run_adaptive(
        jsys.two_body(e=0.7), 1.0,
        lambda p, m: (j_direct_acc(p, m, eps=1e-4, G=G), None),
        eps=1e-2, eta=0.05)
    got = tad.run_adaptive(
        tsys.two_body(e=0.7, device="cpu"), 1.0,
        lambda p, m: (t_direct_acc(p, m, eps=1e-4, G=G), None),
        eps=1e-2, eta=0.05)
    assert int(got.n_steps) == int(want.n_steps) > 100
    assert got.n_steps.dtype == torch.int32
    assert float(got.state.time) == float(want.state.time) == 1.0
    assert float(got.dt_min) == pytest.approx(float(want.dt_min), rel=1e-12)
    assert float(got.dt_max) == pytest.approx(float(want.dt_max), rel=1e-12)
    assert float(got.dt_min) < float(got.dt_max)
    _close(got.state.pos, want.state.pos)
    _close(got.state.vel, want.state.vel)


def test_run_adaptive_stops_at_max_steps():
    """Steps past max_steps are no-ops: they leave the state and the step
    counters as the JAX loop leaves them."""
    kw = dict(eps=1e-2, eta=0.05, max_steps=37)
    G = units.SOLAR.G
    want = jad.run_adaptive(
        jsys.two_body(e=0.7), 1.0,
        lambda p, m: (j_direct_acc(p, m, eps=1e-4, G=G), None), **kw)
    got = tad.run_adaptive(
        tsys.two_body(e=0.7, device="cpu"), 1.0,
        lambda p, m: (t_direct_acc(p, m, eps=1e-4, G=G), None), **kw)
    # 37 is not a multiple of the host-read stride: 11 no-op steps
    assert 37 % tad.CHECK_EVERY
    assert int(got.n_steps) == int(want.n_steps) == 37
    assert float(got.state.time) == pytest.approx(float(want.state.time),
                                                  rel=1e-12)
    assert float(got.dt_max) == pytest.approx(float(want.dt_max), rel=1e-12)
    _close(got.state.pos, want.state.pos)


def test_rung_population_matches_jax():
    rng = np.random.default_rng(6)
    acc = rng.normal(size=(500, 3)) * np.exp(rng.uniform(-8, 4, (500, 1)))
    want = jad.rung_population(jnp.asarray(acc), dt_base=0.1, eps=0.01,
                               n_rungs=8)
    got = tad.rung_population(torch.as_tensor(acc), dt_base=0.1, eps=0.01,
                              n_rungs=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == 500 and int((got > 0).sum()) > 3
    _close(tad.required_dt(torch.as_tensor(acc), 0.01),
           jad.required_dt(jnp.asarray(acc), 0.01), rtol=1e-14)


def test_adaptive_result_fields_match_jax():
    assert tad.AdaptiveResult._fields == jad.AdaptiveResult._fields
    assert tlf.StepDiagnostics._fields == jlf.StepDiagnostics._fields
    assert [f.name for f in dataclasses.fields(tsys.ParticleState)] == \
        ["pos", "vel", "mass", "time"]
