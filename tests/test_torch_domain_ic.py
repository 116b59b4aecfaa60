"""The torch port's slab-resident ICs and their realized spectrum against
the JAX package, on the CPU: ``lpt_ic_domain`` and
``realized_spectrum_domain`` from the JAX package's own per-slab noise,
the port's own domain draw (one draw for the ICs and the spectrum, not
the single-device draw), and the domain driver's realization correction.

The JAX package draws one threefry key a slab, which torch's Philox
cannot reproduce, so parity goes through the JAX noise handed to the
port.  Both sides compute in float32 (the JAX domain ICs are float32
whatever the x64 setting), so the tolerances are float32's: those of
tests/test_torch_ic.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.distributed.ic import lpt_ic_domain as j_lpt_ic_domain
from nbody.distributed.measure import (
    realized_spectrum_domain as j_realized,
)
from nbody.distributed.sharding import device_mesh as j_mesh
from nbody.driver.config import SimulationConfig as JConfig
from nbody.driver.simulate import _linear_power_fn as j_power_fn
from nbody.driver.simulate import _measurement_options
from nbody.ic.gaussian import GRFSpec as JSpec
from nbody_torch.distributed import ic as tic
from nbody_torch.distributed.measure import (
    measure_powerspec_domain,
    realized_spectrum_domain,
)
from nbody_torch.distributed.sharding import device_mesh as t_mesh
from nbody_torch.driver import OutputConfig, SimulationConfig
from nbody_torch.driver.simulate import _linear_power_fn as t_power_fn
from nbody_torch.driver.simulate import measure_powerspec_sharded
from nbody_torch.ic.gaussian import GRFSpec as TSpec
from nbody_torch.ic.gaussian import gaussian_delta_k
from nbody_torch.mesh.spectrum import power_spectrum

JCFG = JConfig(n_side=16)
TCFG = SimulationConfig.from_dict(JCFG.to_dict())
N, BOX = JCFG.n_side, JCFG.box
EDGES = _measurement_options(JCFG)[0]
# float32 positions of magnitude box carry ~box * 6e-8 rounding
POS_TOL = 1e-5
# float32 spectra binned in another order
PK_RTOL = 1e-5


def _jax_slab_noise(seed, D):
    """The JAX package's per-slab draws: one key a slab of the split."""
    keys = jax.random.split(jax.random.key(seed), D)
    return [np.asarray(jax.random.normal(k, (N // D, N, N), jnp.float32))
            for k in keys]


def _tpower():
    return t_power_fn(TCFG.cosmology(), TCFG.transfer)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("D", [2, 4])
def test_lpt_ic_domain_matches_jax(D, order):
    """Row for row from the JAX noise: every shard's particles and parked
    rows, positions and momenta to float32, masses exact, no overflow."""
    want, ov = j_lpt_ic_domain(
        jax.random.key(0), JSpec(nmesh=N, box=BOX),
        j_power_fn(JCFG.cosmology(), JCFG.transfer), JCFG.cosmology(),
        JCFG.a_begin, j_mesh(D), order=order)
    shards, tov = tic.lpt_ic_domain(
        0, TSpec(nmesh=N, box=BOX), _tpower(), TCFG.cosmology(),
        TCFG.a_begin, t_mesh(D, device="cpu"), order=order,
        noise=_jax_slab_noise(0, D))
    assert int(ov) == 0 and tov == 0
    assert shards[0].pos.shape[0] == tic.ic_capacities(N, D)[0]
    pos = torch.cat([s.pos for s in shards]).numpy()
    vel = torch.cat([s.vel for s in shards]).numpy()
    mass = torch.cat([s.mass for s in shards]).numpy()
    np.testing.assert_array_equal(mass, np.asarray(want.mass))
    assert (mass > 0).sum() == N**3
    d = pos - np.asarray(want.pos)
    d -= BOX * np.round(d / BOX)
    assert np.abs(d).max() < POS_TOL * BOX
    wv = np.asarray(want.vel)
    np.testing.assert_allclose(vel, wv, rtol=0,
                               atol=POS_TOL * np.abs(wv).max())
    assert all(float(s.time) == pytest.approx(JCFG.a_begin) for s in shards)


@pytest.mark.parametrize("D", [2, 4])
def test_realized_spectrum_domain_matches_jax(D):
    want = j_realized(jax.random.key(0), JSpec(nmesh=N, box=BOX),
                      j_power_fn(JCFG.cosmology(), JCFG.transfer), j_mesh(D),
                      EDGES)
    got = realized_spectrum_domain(0, TSpec(nmesh=N, box=BOX), _tpower(),
                                   t_mesh(D, device="cpu"), EDGES,
                                   noise=_jax_slab_noise(0, D))
    modes = np.asarray(want.n_modes)
    np.testing.assert_array_equal(got.n_modes.numpy(), modes)
    m = modes > 0
    np.testing.assert_allclose(got.power.numpy()[m],
                               np.asarray(want.power)[m], rtol=PK_RTOL)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k),
                               rtol=PK_RTOL)


def test_domain_draw_is_one_for_ics_and_spectrum():
    """lpt_ic_domain(seed) and realized_spectrum_domain(seed) draw the
    same noise, slab_noise(seed): the spectrum is that of the ICs' own
    delta(k), and differs from the single-device draw of the same seed."""
    D = 4
    group = t_mesh(D, device="cpu")
    spec = TSpec(nmesh=N, box=BOX)
    own = tic.slab_noise(0, N, group)
    ics, _ = tic.lpt_ic_domain(0, spec, _tpower(), TCFG.cosmology(),
                               TCFG.a_begin, group)
    ics_n, _ = tic.lpt_ic_domain(0, spec, _tpower(), TCFG.cosmology(),
                                 TCFG.a_begin, group, noise=own)
    for a, b in zip(ics, ics_n):
        assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)
    got = realized_spectrum_domain(0, spec, _tpower(), group, EDGES)
    dk = gaussian_delta_k(spec, _tpower(), noise=torch.cat(own).numpy(),
                          device="cpu", dtype=torch.float32)
    want = power_spectrum(dk, BOX, is_fourier=True, edges=EDGES)
    m = want.n_modes.numpy() > 0
    np.testing.assert_array_equal(got.n_modes.numpy(), want.n_modes.numpy())
    np.testing.assert_allclose(got.power.numpy()[m], want.power.numpy()[m],
                               rtol=PK_RTOL)
    host = power_spectrum(gaussian_delta_k(
        spec, _tpower(), generator=torch.Generator().manual_seed(0),
        device="cpu", dtype=torch.float32), BOX, is_fourier=True, edges=EDGES)
    assert not np.allclose(got.power.numpy()[m], host.power.numpy()[m],
                           rtol=1e-2)
    assert tic.slab_seed(0, 1) != tic.slab_seed(1, 0)


def test_domain_driver_corrects_by_the_domain_realization():
    """The sharded P(k) of a domain-realized run divides its corrected
    column by the domain draw's own spectrum, not the host draw's."""
    D = 2
    group = t_mesh(D, device="cpu")
    cfg = TCFG.replace(devices=D, ic_realization="domain",
                       output=OutputConfig(realization_correction=True))
    shards, _ = tic.lpt_ic_domain(0, TSpec(nmesh=N, box=BOX), _tpower(),
                                  TCFG.cosmology(), TCFG.a_begin, group)
    k, _, _, pc, _ = measure_powerspec_sharded(shards, group, cfg,
                                               cfg.a_begin, seed=0)
    _, _, _, pc0, _ = measure_powerspec_sharded(
        shards, group, cfg.replace(output=OutputConfig()), cfg.a_begin,
        seed=0)
    _, _, _, pc_host, _ = measure_powerspec_sharded(
        shards, group, cfg.replace(ic_realization="host"), cfg.a_begin,
        seed=0)
    raw, _ = measure_powerspec_domain(
        shards, group, box=BOX, nmesh=cfg.mesh_size, n_global=N**3,
        edges=EDGES)
    realized = realized_spectrum_domain(0, TSpec(nmesh=N, box=BOX),
                                        _tpower(), group, EDGES)
    # the measurement's bins; those the n_side grid leaves empty keep 1
    pr = realized.power.numpy()[raw.n_modes.numpy() > 0].astype(np.float64)
    want = np.where(pr > 0, _tpower()(k) / np.where(pr > 0, pr, 1.0), 1.0)
    assert (pr > 0).sum() > 10
    np.testing.assert_allclose(pc / pc0, want, rtol=1e-5)
    assert not np.allclose(pc, pc_host, rtol=1e-2)


class _Stop(Exception):
    pass


def test_domain_driver_takes_base_at_both_ic_routes(monkeypatch, tmp_path):
    """``run_simulation(member, base=anchor)`` on two shards: the slab ICs
    take the anchor's cosmology at the amplitude A_s / base.A_s (the run
    equals the member's own run, so A_s counts once), and the host route
    hands ``base`` to ``realize_ics``."""
    import nbody_torch.distributed.ic as dic
    from nbody_torch.driver import simulate as tsim

    anchor = TCFG.replace(devices=2, a_begin=0.5, n_steps=1,
                          step_dla_max=0.35,
                          output=OutputConfig(snapshot=False,
                                              powerspec=False))
    member = anchor.replace(A_s=2.0 * anchor.A_s)
    seen = []
    real = dic.lpt_ic_domain

    def spy(*args, **kw):
        seen.append((args[3].A_s, kw["amplitude"]))
        return real(*args, **kw)

    monkeypatch.setattr(dic, "lpt_ic_domain", spy)
    dom = member.replace(ic_realization="domain")
    got = tsim.run_simulation(dom, 0, str(tmp_path / "b"), device="cpu",
                              base=anchor.replace(ic_realization="domain"))
    own = tsim.run_simulation(dom, 0, str(tmp_path / "o"), device="cpu")
    assert seen == [(pytest.approx(anchor.A_s), pytest.approx(2.0)),
                    (pytest.approx(member.A_s), 1.0)]
    np.testing.assert_allclose(got.state.pos.numpy(), own.state.pos.numpy(),
                               rtol=POS_TOL, atol=POS_TOL * BOX)

    def stop(config, seed, **kw):
        seen.append(kw["base"])
        raise _Stop

    monkeypatch.setattr(tsim, "realize_ics", stop)
    with pytest.raises(_Stop):
        tsim.run_simulation(member, 0, str(tmp_path / "h"), device="cpu",
                            base=anchor)
    assert seen[-1] is anchor
