"""The torch port's ensembles against the JAX package, on the CPU: the
sidecar files byte for byte, ``realize_ics(base=)`` and its refusal, the
batched plain K1 against single calls and the dense oracle,
``run_members_batched`` against the JAX package's ``vmap`` tier in
float64 from the JAX white noise (``'pm'``, every ``'p3m'`` tier and
``'pp'``; JAX's kernels in interpret mode), ``run_ensemble``'s batched
tier against its sequential one with resume by skip, ``find_missing_jobs``,
a batched chunk that fails its retries, and ``param_compat`` on param
text written here (the JAX package's ``.param`` tests read an absent
reference checkout), config for config against the JAX package's.

Tiny sizes: n_side 8, mesh 16 (32 for the plane tiers), 4 steps, 2-3
members."""

import dataclasses
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.driver import ensemble as jens
from nbody.driver import param_compat as jpc
from nbody.driver.config import OutputConfig as JOutput
from nbody.driver.config import SimulationConfig as JConfig
from nbody.driver.simulate import realize_ics as j_realize_ics
from nbody.io import sidecars as jside
from nbody_torch.driver import SimulationConfig as TConfig
from nbody_torch.driver import ensemble as tens
from nbody_torch.driver import param_compat as tpc
from nbody_torch.driver.simulate import realize_ics, run_simulation
from nbody_torch.forces.p3m import p3m_short_direct, p3m_short_plain
from nbody_torch.io import sidecars as tside

TINY = JConfig(n_side=8, box=200.0, pm_grid=16, n_steps=4,
               output=JOutput(snapshot_times=(1.0,), powerspec_bins=8,
                              snapshot=False))
MEMBERS = 3
# float64 runs through both packages from the same noise.  The JAX
# package transforms its float32 noise in complex64 (the port in
# complex128), so the ICs differ at ~1e-7; 4 steps amplify that: the
# positions to 1e-6 of the box (tests/test_driver.py's bound on the JAX
# package's two tiers), the velocities, which the short-range pairs at
# the cutoff amplify most, to 1e-4 of the largest
POS_RTOL = 1e-6
VEL_TOL = 1e-4


def _t(jcfg):
    return TConfig.from_dict(jcfg.to_dict())


def _noise(seeds, n):
    """The JAX package's white noise of each member's seed (the float32
    draw inside lpt_ic)."""
    return np.stack([np.asarray(jax.random.normal(
        jax.random.key(int(s)), (n,) * 3, jnp.float32)) for s in seeds])


def test_sidecars_byte_for_byte(tmp_path):
    A_s = jens.draw_A_s(5)
    labels = np.column_stack([A_s, np.full(5, 0.965), np.full(5, 0.12)])
    box = (jside.BoxParams(z=0.0, L=500.0, N=32),
           tside.BoxParams(z=0.0, L=500.0, N=32))
    mm = [cls(A_s_min=float(A_s.min()), A_s_max=float(A_s.max()),
              n_s_min=0.965, n_s_max=0.965, omega_cdm_min=0.12,
              omega_cdm_max=0.12, n_samples=5)
          for cls in (jside.MaxMinParams, tside.MaxMinParams)]
    for pkg, side, b, m in (("j", jside, box[0], mm[0]),
                            ("t", tside, box[1], mm[1])):
        side.write_box_params(tmp_path / pkg / "BoxParams.txt", b)
        side.write_maxmin_params(tmp_path / pkg / "MaxMinParams.txt", m)
        side.write_param_table(tmp_path / pkg / "TrainingParams.txt", labels)
    for name in ("BoxParams.txt", "MaxMinParams.txt", "TrainingParams.txt"):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes()
    assert tside.read_box_params(tmp_path / "j" / "BoxParams.txt") == box[1]
    got = tside.read_maxmin_params(tmp_path / "j" / "MaxMinParams.txt")
    want = jside.read_maxmin_params(tmp_path / "t" / "MaxMinParams.txt")
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    np.testing.assert_array_equal(got.maxima(), want.maxima())
    np.testing.assert_array_equal(
        tside.read_param_table(tmp_path / "j" / "TrainingParams.txt"), labels)
    assert np.array_equal(tens.make_seeds(7, 3), jens.make_seeds(7, 3))
    assert np.array_equal(tens.draw_A_s(4, draw_seed=tens.TEST_DRAW_SEED),
                          jens.draw_A_s(4, draw_seed=jens.TEST_DRAW_SEED))


def test_realize_ics_base_matches_jax():
    """A member (A_s of its own) realized on the ensemble's anchor: the
    anchor's power at the amplitude ratio, from the JAX noise."""
    member = TINY.replace(A_s=2.6e-9)
    seed = 5
    ref = j_realize_ics(member, seed, base=TINY)
    got = realize_ics(_t(member), seed, device="cpu", dtype=torch.float64,
                      noise=_noise([seed], 8)[0], base=_t(TINY))
    d = got.pos.numpy() - np.asarray(ref.pos)
    d -= 200.0 * np.round(d / 200.0)
    assert np.abs(d).max() <= 1e-6 * 200.0
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(ref.vel),
                               rtol=1e-6, atol=1e-6 * np.abs(ref.vel).max())
    # P(k) scales with A_s: the member's own ICs, and the anchor's with
    # the displacement scaled by sqrt(A_s / base.A_s) (1LPT)
    kw = dict(device="cpu", dtype=torch.float64, noise=_noise([seed], 8)[0])
    own = realize_ics(_t(member), seed, **kw)
    anchor = realize_ics(_t(TINY), seed, **kw)
    torch.testing.assert_close(own.vel, got.vel, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(anchor.vel * (2.6e-9 / TINY.A_s) ** 0.5,
                               got.vel, rtol=1e-12, atol=0.0)
    for bad in (TINY.replace(n_steps=5), TINY.replace(box=100.0)):
        with pytest.raises(ValueError, match="only in A_s"):
            j_realize_ics(member, seed, base=bad)
        with pytest.raises(ValueError, match="only in A_s"):
            realize_ics(_t(member), seed, device="cpu", base=_t(bad))
        with pytest.raises(ValueError, match="only in A_s"):
            run_simulation(_t(member), seed, "", _t(bad), device="cpu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_plain_k1_equals_single_calls(dtype):
    rng = np.random.default_rng(2)
    box, eps, r_s, r_cut = 60.0, 0.4, 2.5, 11.25
    pos = torch.tensor(rng.uniform(0, box, (MEMBERS, 300, 3)), dtype=dtype)
    mass = torch.tensor(rng.uniform(0.5, 1.5, (MEMBERS, 300)), dtype=dtype)
    for split, soft in (("spline", "spline"), ("gaussian", "plummer")):
        got = p3m_short_plain(pos, mass, box, eps, r_s, r_cut, G=2.0,
                              split=split, softening=soft)
        for b in range(MEMBERS):
            one = p3m_short_plain(pos[b], mass[b], box, eps, r_s, r_cut,
                                  G=2.0, split=split, softening=soft)
            assert torch.equal(got[b], one)
            if dtype == torch.float64:
                ref = p3m_short_direct(pos[b], mass[b], box, eps, r_s, r_cut,
                                       G=2.0, split=split, softening=soft)
                assert float((one - ref).abs().max()) <= \
                    1e-12 * float(ref.abs().max())


#: the batched tier's configs: pm, the dense P3M tier at mesh 16 (box /
#: r_cut = 2.8, below 3, where every tier runs dense), the plane tiers at
#: mesh 32 (box / r_cut = 5.7) and PP
BATCHED_CONFIGS = {
    "pm": dict(solver="pm"),
    "p3m": dict(solver="p3m"),
    "cells": dict(solver="p3m", shortrange="cells", pm_grid=32),
    "columns": dict(solver="p3m", shortrange="columns", pm_grid=32),
    "supercell": dict(solver="p3m", shortrange="supercell", pm_grid=32),
    "pp": dict(solver="pp"),
}


@pytest.fixture(scope="module")
def jax_batched():
    """The JAX package's vmap tier of each of BATCHED_CONFIGS, run once:
    name -> (config, seeds, A_s, final state)."""
    done = {}

    def run(name):
        if name not in done:
            cfg = TINY.replace(**BATCHED_CONFIGS[name])
            seeds = jens.make_seeds(MEMBERS, 4)
            A_s = jens.draw_A_s(MEMBERS)
            done[name] = (cfg, seeds, A_s, jens.run_members_batched(
                cfg, seeds, A_s, base=cfg))
        return done[name]

    return run


@pytest.mark.parametrize("solver", list(BATCHED_CONFIGS))
def test_run_members_batched_matches_jax(jax_batched, solver):
    """The batched tier against the JAX package's vmap of one member's
    run, float64, from the JAX noise: positions to POS_RTOL, on pm, every
    P3M tier (each resolved as by the JAX package) and PP."""
    from nbody.driver.simulate import _resolved_shortrange as j_tier
    from nbody_torch.driver.simulate import _resolved_shortrange as t_tier

    cfg, seeds, A_s, ref = jax_batched(solver)
    if cfg.solver == "p3m":
        assert t_tier(_t(cfg)) == j_tier(cfg)
        assert t_tier(_t(cfg)) == cfg.shortrange.replace("auto", "allpairs")
    lines = []
    got = tens.run_members_batched(_t(cfg), seeds, A_s, base=_t(cfg),
                                   device="cpu", dtype=torch.float64,
                                   noise=_noise(seeds, 8), log=lines.append)
    assert got.pos.shape == (MEMBERS, 512, 3)
    assert not any("re-running" in line for line in lines)
    d = got.pos.numpy() - np.asarray(ref.pos)
    d -= cfg.box * np.round(d / cfg.box)
    assert np.abs(d).max() <= POS_RTOL * cfg.box
    assert np.abs(got.vel.numpy() - np.asarray(ref.vel)).max() <= \
        VEL_TOL * np.abs(ref.vel).max()
    assert float(got.time) == pytest.approx(1.0)


def test_batched_matches_sequential_and_resumes(tmp_path):
    """run_ensemble's batched tier against its sequential tier (snapshots
    written with h5py), then a resume that skips every member, and the
    sidecars."""
    pytest.importorskip("h5py")
    from nbody_torch.io.snapshot import read_snapshot

    cfg = _t(TINY.replace(solver="p3m", output=TINY.output.replace(
        snapshot=True)))
    A_s = tens.draw_A_s(MEMBERS, draw_seed=11)
    kw = dict(A_s_values=A_s, master_seed=5, device="cpu",
              dtype=torch.float64)
    seq = tens.run_ensemble(cfg, MEMBERS, str(tmp_path / "seq"), **kw)
    bat = tens.run_ensemble(cfg, MEMBERS, str(tmp_path / "bat"), batch=2,
                            **kw)
    assert not seq.failed and not bat.failed
    tag = f"snapshot_a={cfg.a_end:.2f}.hdf5"
    for rs, rb in zip(seq.run_dirs, bat.run_dirs):
        ss, _ = read_snapshot(os.path.join(rs, "snapshots", tag),
                              dtype=torch.float64)
        sb, _ = read_snapshot(os.path.join(rb, "snapshots", tag),
                              dtype=torch.float64)
        np.testing.assert_allclose(sb.pos.numpy(), ss.pos.numpy(),
                                   rtol=1e-6, atol=1e-6 * cfg.box)
        ps = np.loadtxt(os.path.join(rs, "powerspec", "powerspec_a=1.00"))
        pb = np.loadtxt(os.path.join(rb, "powerspec", "powerspec_a=1.00"))
        np.testing.assert_allclose(pb, ps, rtol=1e-6)
        assert TConfig.load(os.path.join(rb, "config.json")) == \
            TConfig.load(os.path.join(rs, "config.json"))
    again = tens.run_ensemble(cfg, MEMBERS, str(tmp_path / "bat"), batch=2,
                              **kw)
    assert again.skipped == list(range(MEMBERS)) and not again.failed
    assert tens.find_missing_jobs(str(tmp_path / "bat"), cfg,
                                  bat.params) == []
    for name in ("BoxParams.txt", "MaxMinParams.txt", "TrainingParams.txt"):
        assert os.path.exists(tmp_path / "seq" / name)


def test_find_missing_jobs(tmp_path):
    cfg = _t(TINY)
    params = np.column_stack([tens.draw_A_s(4), np.full(4, 0.965),
                              np.full(4, 0.12)])
    for i in (1, 3):
        p = tens._final_snapshot(tens._run_dir(str(tmp_path), i,
                                               float(params[i, 0])), cfg)
        os.makedirs(os.path.dirname(p))
        open(p, "w").close()
    got = tens.find_missing_jobs(str(tmp_path), cfg, params)
    assert got == [0, 2] == jens.find_missing_jobs(str(tmp_path), TINY,
                                                   params)
    assert tens._run_dir("r", 3, 2.1e-9) == jens._run_dir("r", 3, 2.1e-9)


def test_failed_chunk_recorded_after_retries(tmp_path, monkeypatch):
    """A batched chunk that fails every retry: each member recorded as
    failed and the error in failures.log."""
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("a planted failure of the batched runner")

    monkeypatch.setattr(tens, "run_members_batched", broken)
    res = tens.run_ensemble(_t(TINY), 2, str(tmp_path), batch=2,
                            max_retries=2, device="cpu")
    assert res.failed == [0, 1] and len(calls) == 2
    assert "planted failure" in (tmp_path / "failures.log").read_text()


PARAM = textwrap.dedent("""\
    # a CONCEPT parameter file in the reference's style
    boxsize = 500*Mpc
    initial_conditions = {'species': 'matter', 'N': _size**3}
    select_forces = {'matter': {'gravity': 'p3m'}}
    realization_options = {'LPT': 2}
    a_begin = 0.02
    output_times = {'snapshot': [0.5, 1.0]}
    primordial_spectrum = {'A_s': 2.3e-9, 'n_s': 0.9649}
    potential_options = {
        'gridsize': {'global': {2*_size}},
        'interlace': {'gravity': {'p3m': (True, True)}},
        'deconvolve': {'gravity': {'p3m': (True, True)}},
        'differentiation': {'all': {'gravity': {'p3m': 'Fourier'}}},
    }
    powerspec_options = {
        'interpolation': {'default': 'PCS'},
        'interlace': {'default': True},
        'realization correction': {'default': True},
        'k_max': {'default': 'nyquist'},
        'bins per decade': {'default': {'  4*k_min': 4, '100*k_min': 40}},
        'tophat': {'default': 8*Mpc/h},
    }
    softening_kernel = {'matter': 'plummer'}
    cell_centered = False
    H0 = 67.36*km/(s*Mpc)
    Ωb = 0.02237/h**2
    Ωcdm = 0.12/h**2
    unknown_thing = undefined_name + 1
    autosave_interval = 6*hr
    """)


@pytest.mark.parametrize("defines,overrides", [
    ({"_size": 32}, None), ({"_size": 16}, {"n_steps": 10}),
])
def test_param_compat_matches_jax(tmp_path, defines, overrides):
    path = tmp_path / "NN.param"
    path.write_text(PARAM, encoding="utf-8")
    jns = jpc.parse_concept_param(str(path), defines=defines)
    tns = tpc.parse_concept_param(str(path), defines=defines)
    for key in ("boxsize", "h", "Ωb", "Ωcdm", "a_begin", "H0"):
        assert tns[key] == jns[key]
    assert "unknown_thing" not in tns
    got = tpc.load_concept_param(str(path), defines=defines,
                                 overrides=overrides)
    want = jpc.load_concept_param(str(path), defines=defines,
                                  overrides=overrides)
    assert got.to_dict() == want.to_dict()
    assert got == TConfig.from_dict(want.to_dict())
    assert got.n_side == defines["_size"]
    assert got.solver == "p3m" and got.interlace and got.deconvolve_p == 4
    assert got.pm_gradient == "spectral" and got.lpt_order == 2
    assert got.output.powerspec_interpolation == "pcs"
    assert tpc.config_from_param_namespace(tns) == TConfig.from_dict(
        jpc.config_from_param_namespace(jns).to_dict())
