"""The torch port's whole slice against the JAX package, on the CPU:
``run_simulation`` for the pm, p3m and pp solvers from one float64 initial
state, the config JSON, the I/O formats, the energy diagnostics and the
paths that are not ported yet."""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.core.types import ParticleState as JState
from nbody.diagnostics import layzer_irvine as jli
from nbody.driver import run_simulation as j_run
from nbody.driver.config import OutputConfig as JOutput
from nbody.driver.config import SimulationConfig as JConfig
from nbody.driver.simulate import realize_ics as j_realize_ics
from nbody.io import checkpoint as jckpt
from nbody.io import snapshot as jsnap
from nbody.io.powerspec import read_powerspec as j_read_powerspec
from nbody_torch.convert import state_from_numpy, state_to_numpy
from nbody_torch.core.cosmology import Cosmology as TCosmology
from nbody_torch.diagnostics import layzer_irvine as tli
from nbody_torch.driver import SimulationConfig as TConfig
from nbody_torch.driver import run_simulation as t_run
from nbody_torch.io import checkpoint as tckpt
from nbody_torch.io import snapshot as tsnap
from nbody_torch.io.powerspec import read_powerspec, write_powerspec

# tests/test_driver.py's TINY geometry
TINY = JConfig(
    n_side=8, box=200.0, solver="pm", pm_grid=16, n_steps=4,
    output=JOutput(snapshot_times=(0.3, 1.0), powerspec_bins=8,
                   snapshot=False),
)
# float64 runs of the same state through both packages: only summation
# order differs, amplified over 4 steps
RUN_RTOL = 1e-9


def _tconfig(jcfg):
    return TConfig.from_dict(jcfg.to_dict())


def _initial_state64(jcfg, seed=0):
    st = j_realize_ics(jcfg, seed)
    arrays = [np.asarray(x, np.float64) for x in (st.pos, st.vel, st.mass, st.time)]
    return JState.create(*arrays, dtype=jnp.float64), arrays


@pytest.mark.parametrize("solver", ["pm", "p3m", "pp"])
def test_run_simulation_matches_jax(solver, tmp_path):
    """The whole slice: ICs in, final state, P(k) files at both output
    times, energy samples and run.log lines out."""
    jcfg = TINY.replace(solver=solver)
    jstate, arrays = _initial_state64(jcfg)
    want = j_run(jcfg, 0, str(tmp_path / "jax"), initial_state=jstate)
    got = t_run(_tconfig(jcfg), 0, str(tmp_path / "torch"), device="cpu",
                dtype=torch.float64,
                initial_state=state_from_numpy(*arrays, device="cpu",
                                               dtype=torch.float64))
    pos, vel, _, time_ = state_to_numpy(got.state)
    d = pos - np.asarray(want.state.pos)
    d -= jcfg.box * np.round(d / jcfg.box)
    assert np.abs(d).max() <= RUN_RTOL * jcfg.box
    wvel = np.asarray(want.state.vel)
    assert np.abs(vel - wvel).max() <= RUN_RTOL * np.abs(wvel).max()
    assert float(time_) == pytest.approx(1.0, rel=1e-15)

    assert [os.path.basename(p) for p in got.powerspecs] == \
        [os.path.basename(p) for p in want.powerspecs]
    for gp, wp in zip(got.powerspecs, want.powerspecs):
        g, w = np.loadtxt(gp), np.loadtxt(wp)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 1], w[:, 1])  # modes
        np.testing.assert_allclose(g, w, rtol=RUN_RTOL, atol=0)
        gt, wt = read_powerspec(gp), j_read_powerspec(wp)
        assert (gt.sigma8, gt.a) == (wt.sigma8, wt.a)

    np.testing.assert_allclose(np.array(got.energy_samples),
                               np.array(want.energy_samples), rtol=RUN_RTOL)

    def log_lines(run_dir):
        with open(os.path.join(run_dir, "run.log")) as f:
            return [line.split("(")[0] for line in f if "written" not in line]

    assert log_lines(tmp_path / "torch") == log_lines(tmp_path / "jax")
    assert got.config_run == got.config


def test_config_json_round_trips_across_packages(tmp_path):
    jcfg = TINY.replace(solver="p3m", A_s=1.9e-9, force_split="gaussian")
    path = str(tmp_path / "config.json")
    jcfg.save(path)
    tcfg = TConfig.load(path)
    assert tcfg.to_dict() == jcfg.to_dict()
    tcfg.save(path)
    assert JConfig.load(path) == jcfg
    assert (tcfg.eps, tcfg.mesh_size, tcfg.n_particles) == \
        (jcfg.eps, jcfg.mesh_size, jcfg.n_particles)


@pytest.mark.parametrize("change,match,error", [
    pytest.param(dict(solver="pp", devices=2, ic_realization="domain"),
                 "pp", NotImplementedError, id="change0-pp"),
    # subcycles, the domain ICs, adaptive steps and the compact kicks run
    # (tests/test_torch_subcycle.py, tests/test_torch_adaptive.py);
    # adaptive steps with subcycles and no rungs on several devices raise
    # ValueError, as in the JAX package
    pytest.param(dict(solver="p3m", subcycles=2, time_stepping="adaptive"),
                 None, None, id="change1-subcycles"),
    pytest.param(dict(solver="p3m", rungs=2, rung_active_capacity=64,
                      box=60.0, pm_grid=32), None, None, id="change2-rungs"),
    pytest.param(dict(time_stepping="adaptive"), None, None,
                 id="change3-adaptive"),
    pytest.param(dict(devices=2, subcycles=2, time_stepping="adaptive"),
                 "devices", ValueError, id="change4-devices"),
    pytest.param(dict(solver="p3m", rungs=3, time_stepping="adaptive",
                      box=60.0, pm_grid=32), None, None,
                 id="change5-adaptive"),
    pytest.param(dict(solver="p3m", box=500.0, pm_grid=64,
                      shortrange="supercell", subcycles=2,
                      time_stepping="adaptive"), None, None,
                 id="change6-subcycles"),
])
def test_unported_paths_raise(change, match, error, tmp_path):
    """What the port does not run raises, naming it; the paths that used
    to raise here (``error`` None) run from a = 0.75 to a_end on the CPU
    and end there."""
    cfg = _tconfig(TINY).replace(**change)
    if error is not None:
        with pytest.raises(error, match=match):
            t_run(cfg, 0, str(tmp_path), device="cpu")
        return
    cfg = cfg.replace(a_begin=0.75, n_steps=2, step_dla_max=0.35)
    res = t_run(cfg, 0, str(tmp_path), device="cpu")
    assert float(res.state.time) == pytest.approx(cfg.a_end)
    assert bool(torch.isfinite(res.state.pos).all())


def test_cuda_path_is_float32_only():
    with pytest.raises(ValueError, match="float32"):
        t_run(_tconfig(TINY), 0, None, device="cuda", dtype=torch.float64)


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    arrays = (rng.normal(size=(5, 3)), rng.normal(size=(5, 3)),
              rng.uniform(size=5), np.float64(0.5))
    st = state_from_numpy(*arrays, device="cpu", dtype=torch.float64)
    for got, want in zip(state_to_numpy(st), arrays):
        np.testing.assert_array_equal(got, want)
    st32 = state_from_numpy(*arrays, device="cpu", dtype=torch.float32)
    assert st32.dtype == torch.float32 and st32.time.ndim == 0


def test_io_formats_read_back_in_both_packages(tmp_path):
    """Powerspec text, checkpoint .npz and the HDF5 snapshot written by the
    port read back through the JAX package's readers."""
    rng = np.random.default_rng(1)
    k = np.geomspace(0.01, 1.0, 6)
    cols = rng.uniform(1.0, 100.0, (3, 6))
    path = str(tmp_path / "powerspec_a=1.00")
    write_powerspec(path, k, np.arange(6) + 1, cols[0], cols[1], cols[2],
                    a=1.0, gridsize=16, sigma8=0.8, sigma8_corrected=0.81,
                    sigma8_linear=0.79)
    tab = j_read_powerspec(path)
    np.testing.assert_allclose(tab.P_linear, cols[2], rtol=1e-7)
    assert (tab.sigma8, tab.sigma8_linear, tab.a) == (0.8, 0.79, 1.0)

    st = state_from_numpy(rng.uniform(0, 50, (7, 3)), rng.normal(size=(7, 3)),
                          np.full(7, 2.0), 0.25, device="cpu",
                          dtype=torch.float64)
    ck = tckpt.save_checkpoint(str(tmp_path / "ck" / "checkpoint.npz"), st,
                               {"grid_index": 3})
    jst, extra = jckpt.load_checkpoint(ck)
    assert extra == {"grid_index": 3}
    np.testing.assert_array_equal(np.asarray(jst.vel), st.vel.numpy())
    back, _ = tckpt.load_checkpoint(ck)
    assert torch.equal(back.pos, st.pos) and float(back.time) == 0.25

    pytest.importorskip("h5py")
    meta = tsnap.SnapshotMeta.from_cosmology(TCosmology(), 50.0, a=0.25)
    snap = str(tmp_path / "snapshots" / "snapshot_a=0.25.hdf5")
    tsnap.write_snapshot(snap, st, meta)
    jst, jmeta = jsnap.read_snapshot(snap, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(jst.vel), st.vel.numpy(), rtol=1e-14)
    assert jmeta == jsnap.SnapshotMeta(**dataclasses.asdict(meta))
    tst, _ = tsnap.read_snapshot(snap, dtype=torch.float64)
    assert torch.allclose(tst.pos, st.pos, rtol=1e-14)


def test_snapshot_without_h5py_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    st = state_from_numpy(np.zeros((2, 3)), np.zeros((2, 3)), np.ones(2), 1.0,
                          device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        tsnap.write_snapshot(str(tmp_path / "s.hdf5"), st, tsnap.SnapshotMeta())


def test_layzer_irvine_energies():
    """(T, W) of one state and the residual of a sampled trajectory."""
    jstate, arrays = _initial_state64(TINY.replace(n_side=16, box=300.0))
    want = jli.peculiar_energies(jstate, TINY.cosmology(), 300.0, 32)
    st = state_from_numpy(*arrays, device="cpu", dtype=torch.float64)
    got = tli.peculiar_energies(st, TCosmology(), 300.0, 32)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-10)
    raw = tli.peculiar_energies(st, TCosmology(), 300.0, 32, subtract_self=False)
    assert float(raw[1]) == pytest.approx(
        float(jli.peculiar_energies(jstate, TINY.cosmology(), 300.0, 32,
                                    subtract_self=False)[1]), rel=1e-10)
    a = np.geomspace(0.1, 1.0, 9)
    T, W = a**0.5, -2.0 * a**0.5 + 0.01 * a
    assert tli.layzer_irvine_residual(a, T, W) == jli.layzer_irvine_residual(a, T, W)


def test_result_fields_match_the_jax_result():
    from nbody.driver.simulate import SimulationResult as JResult
    from nbody_torch.driver import SimulationResult as TResult

    # the port adds the largest frozen-plan staleness count it noted
    assert [f.name for f in dataclasses.fields(TResult)] == \
        [f.name for f in dataclasses.fields(JResult)] + ["stale_max"]


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """A run resumed from its autosave ends where the uninterrupted run
    does, bit for bit; the resumed run starts at the stored index."""
    cfg = _tconfig(TINY).replace(solver="p3m", n_steps=6, output=_tconfig(
        TINY).output.replace(snapshot_times=(1.0,)))
    full = t_run(cfg, 3, str(tmp_path / "full"), device="cpu",
                 dtype=torch.float64, checkpoint_every_steps=4)
    ck = tckpt.latest_checkpoint(str(tmp_path / "full"))
    assert tckpt.load_checkpoint(ck)[1]["grid_index"] == 4
    os.makedirs(tmp_path / "resumed")
    os.rename(os.path.dirname(ck), tmp_path / "resumed" / "autosave")
    resumed = t_run(cfg, 3, str(tmp_path / "resumed"), device="cpu",
                    dtype=torch.float64, resume=True)
    assert torch.equal(resumed.state.pos, full.state.pos)
    assert torch.equal(resumed.state.vel, full.state.vel)
    with open(tmp_path / "resumed" / "run.log") as f:
        assert "start_idx=4" in f.readline()


def test_run_writes_config_and_snapshot(tmp_path):
    """A run directory holds the config JSON both packages load and the
    HDF5 snapshot of the final state (readable by the JAX package)."""
    pytest.importorskip("h5py")
    cfg = _tconfig(TINY).replace(n_steps=2, output=_tconfig(TINY).output.replace(
        snapshot_times=(1.0,), snapshot=True, powerspec=False,
        energy_log=False))
    res = t_run(cfg, 3, str(tmp_path), device="cpu", dtype=torch.float64)
    with open(tmp_path / "config.json") as f:
        assert JConfig.from_dict(json.load(f)).to_dict() == cfg.to_dict()
    assert res.energy_samples is None and res.powerspecs == []
    assert [os.path.basename(p) for p in res.snapshots] == ["snapshot_a=1.00.hdf5"]
    jst, meta = jsnap.read_snapshot(res.snapshots[0], dtype=np.float64)
    np.testing.assert_allclose(np.asarray(jst.pos), res.state.pos.numpy(),
                               rtol=1e-15)
    assert meta.a == 1.0 and meta.boxsize == cfg.box
