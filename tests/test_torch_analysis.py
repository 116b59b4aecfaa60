"""The torch port's analysis layer against the JAX package, on the CPU:
``compare.py``'s numeric helpers (runtime parsing, Nyquist k, relative
and signed errors) equal to the JAX package's, ``density_projection``
against the JAX projection and bit for bit over two calls,
``ensemble_scatter`` on powerspec files written here, and the comparison
studies (``compare_solver_spectra``, ``lpt_comparison``,
``resolution_study``) through the port's ``run_simulation`` and
``measure_powerspec`` at a tiny size, with and without their figures."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.analysis import compare as jcmp
from nbody.analysis import render as jren
from nbody_torch import analysis as tana
from nbody_torch.analysis import compare as tcmp
from nbody_torch.driver import OutputConfig, SimulationConfig
from nbody_torch.io.powerspec import write_powerspec

TINY = SimulationConfig(n_side=4, box=100.0, pm_grid=8, n_steps=2,
                        a_begin=0.1,
                        output=OutputConfig(snapshot=False,
                                            powerspec_bins=4))


@pytest.mark.parametrize("text", ["2 days, 23:27:37", "4:18 min", "12.1 s",
                                  "7 min", "1:02:03", "3 days, 0:00:01"])
def test_parse_runtime_matches_jax(text):
    assert tcmp.parse_runtime(text) == jcmp.parse_runtime(text)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    k = np.sort(rng.uniform(0.01, 1.0, 40))
    P = rng.uniform(1e2, 1e4, 40)
    kt = np.linspace(0.005, 1.2, 100)
    Pt = 1e4 * np.exp(-kt)
    assert tcmp.nyquist_k(64, 500.0) == jcmp.nyquist_k(64, 500.0)
    for k_max in (None, 0.5):
        for name in ("relative_error", "signed_deviation_percent"):
            got = getattr(tcmp, name)(k, P, kt, Pt, k_max)
            want = getattr(jcmp, name)(k, P, kt, Pt, k_max)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        assert tcmp.mean_relative_error(k, P, kt, Pt, k_max) == \
            jcmp.mean_relative_error(k, P, kt, Pt, k_max)
    assert np.isnan(tcmp.mean_relative_error(k, P, kt, Pt, 0.0))
    with pytest.raises(ValueError):
        tcmp.parse_runtime("")


@pytest.mark.parametrize("axis", [0, 2])
def test_density_projection_matches_jax(axis):
    rng = np.random.default_rng(1)
    pos = rng.uniform(-20.0, 120.0, (3000, 3))
    w = rng.uniform(0.5, 1.5, 3000)
    got = tana.density_projection(torch.tensor(pos), 100.0, res=32,
                                  axis=axis, weights=torch.tensor(w))
    want = np.asarray(jren.density_projection(jnp.asarray(pos), 100.0,
                                              res=32, axis=axis,
                                              weights=jnp.asarray(w)))
    assert got.shape == (32, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * want.max())
    again = tana.density_projection(torch.tensor(pos), 100.0, res=32,
                                    axis=axis, weights=torch.tensor(w))
    assert torch.equal(got, again)
    assert float(got.sum()) == pytest.approx(w.sum(), rel=1e-12)


def test_ensemble_scatter(tmp_path):
    """Mean and spread of the members' final corrected spectra, as the JAX
    package's, from the same files; figure with the linear spectrum."""
    pytest.importorskip("matplotlib")
    k = np.linspace(0.02, 0.5, 12)
    rng = np.random.default_rng(2)
    for i in range(3):
        d = tmp_path / f"id{i:04d}" / "powerspec"
        d.mkdir(parents=True)
        P = 1e3 * (1 + 0.1 * rng.normal(size=12))
        write_powerspec(str(d / "powerspec_a=1.00"), k, np.full(12, 10), P,
                        P_corrected=1.01 * P, P_linear=P)
    got = tana.ensemble_scatter(str(tmp_path), TINY,
                                fig_path=str(tmp_path / "scatter.png"))
    want = jcmp.ensemble_scatter(str(tmp_path))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3] == 3
    assert os.path.getsize(tmp_path / "scatter.png") > 0
    with pytest.raises(ValueError, match="no powerspec"):
        tana.ensemble_scatter(str(tmp_path / "id0000" / "powerspec"))


def test_studies_run_the_port(tmp_path):
    """The three studies at 4^3 through the port's driver on the CPU:
    their keys, finite spectra against the linear column, runtimes, and
    one figure each."""
    pytest.importorskip("matplotlib")
    kw = dict(device="cpu", dtype=torch.float64)
    out = tana.compare_solver_spectra(
        TINY, solvers=("pm", "p3m"), fig_path=str(tmp_path / "solvers.png"),
        hist_fig_path=str(tmp_path / "hist.png"), **kw)
    assert set(out) == {"pm", "p3m"}
    k_ny = tcmp.nyquist_k(TINY.mesh_size, TINY.box)
    for r in out.values():
        assert np.all(np.isfinite(r["P"])) and r["wall_s"] > 0
        assert r["mean_rel_err"] == tcmp.mean_relative_error(
            r["k"], r["P"], r["k"], r["P_linear"], k_max=k_ny)
        assert np.all(r["k_dev"] <= k_ny)
    lpt = tana.lpt_comparison(TINY, fig_path=str(tmp_path / "lpt.png"), **kw)
    assert set(lpt) == {"1lpt", "2lpt"}
    res = tana.resolution_study(TINY, n_sides=(4, 6),
                                fig_path=str(tmp_path / "res.png"), **kw)
    assert set(res) == {4, 6} and res[6]["k_ny"] == tcmp.nyquist_k(12, 100.0)
    for name in ("solvers.png", "hist.png", "lpt.png", "res.png"):
        assert os.path.getsize(tmp_path / name) > 0
