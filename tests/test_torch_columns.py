"""The torch port's columns tier against the JAX package, on the CPU: the
column plane's intermediates, the geometry helpers, K4's plain version
(the CPU path of p3m_short_columns) and a 3-step 'columns' run.

Inputs are made with numpy from a seed and handed to both packages in
float32, the type both column planes are built in; the JAX kernels run
in Pallas interpret mode, as tests/test_columns.py runs them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.core.types import ParticleState as JState
from nbody.driver import run_simulation as j_run
from nbody.driver import simulate as jsim
from nbody.driver.config import OutputConfig as JOutput
from nbody.driver.config import SimulationConfig as JConfig
from nbody.forces import p3m_columns as jc
from nbody.forces import pm_supercell as js
from nbody_torch.convert import state_from_numpy
from nbody_torch.driver import SimulationConfig as TConfig
from nbody_torch.driver import run_simulation as t_run
from nbody_torch.driver import simulate as tsim
from nbody_torch.forces import p3m_columns as tc

# float32 forces through the same plane: summation order only (the plain
# version sums the in-cutoff pairs, the kernel whole windows); the JAX
# package's tier-vs-tier tolerance (tests/test_supercell.py)
ACC_TOL = 2e-5
# float32 runs of 3 steps from one state, positions in units of the box
RUN_TOL = 1e-5
BOX, NMESH = 100.0, 32

PLANE_FIELDS = ("plane", "ws", "nch", "overflow_bucket", "overflow_window",
                "gidx", "counts")


@pytest.fixture(autouse=True)
def _clear_port_capacity_memory():
    yield
    tsim._CAPACITY_MEMORY.clear()


def _uniform(n, box, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, box, (n, 3)).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32))


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", ["sized", "tiny_capacity"])
def test_build_column_plane_matches_jax(case):
    """Plane values, window starts, chunk counts, overflow words, slot map
    and counts equal the JAX package's exactly.  The tiny capacity (128
    slots, 128-slot chunks) spills both overflow fields."""
    pos, mass = _uniform(2500, BOX, seed=1)
    r_cut = 0.999 * BOX / 4
    if case == "sized":
        ck, w, chunk = 640, 512, 128
    else:
        ck, w, chunk = 128, 128, 128
    # jitted: one compile instead of one per operation (~5x faster here)
    build = jax.jit(jc.build_column_plane, static_argnums=(2, 3, 4, 5, 6),
                    static_argnames=("chunk",))
    want = build(jnp.asarray(pos), jnp.asarray(mass), BOX, r_cut, 4, ck, w,
                 chunk=chunk)
    got = tc.build_column_plane(torch.tensor(pos), torch.tensor(mass), BOX,
                                r_cut, 4, ck, w, chunk=chunk)
    for name, g, wv in zip(PLANE_FIELDS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv), err_msg=name)
    if case == "tiny_capacity":
        assert int(got[3]) > 0 and int(got[4]) > 0


@pytest.mark.parametrize("args", [
    (500.0, 128, 2**18), (500.0, 64, 32768), (200.0, 32, 512),
    (100.0, 32, 6000), (500.0, 127, 110592),
])
def test_column_geometry_helpers_match_jax(args):
    box, nmesh, n = args
    assert tc.column_params(box, nmesh, n) == jc.column_params(box, nmesh, n)
    r_cut = tc.column_params(box, nmesh, n)[1]
    for ck in (128, 1280, 20480, 65536):
        assert tc.ghost_slots(ck, (r_cut / box) * ck) == \
            jc.ghost_slots(ck, (r_cut / box) * ck)
        assert tc.ghost_slots(ck) == jc.ghost_slots(ck)
        assert tc.column_window(box, r_cut, ck) == \
            jc.column_window(box, r_cut, ck)
        assert tc.columns_stride_ok(box, r_cut, ck) == \
            jc.columns_stride_ok(box, r_cut, ck)


@pytest.mark.parametrize("split,softening", [("spline", "spline"),
                                             ("gaussian", "plummer")])
def test_p3m_short_columns_matches_jax(split, softening):
    """K4's plain version through p3m_short_columns against the JAX
    package's column kernel, on the supercell geometry of the JAX tests."""
    n = 2000
    pos, mass = _uniform(n, BOX, seed=3)
    r_s, r_cut, ncell, ck, w = js.supercell_params(BOX, NMESH, n)
    kw = dict(ncell=ncell, col_capacity=ck, window=w, split=split,
              softening=softening)
    want, wov = jc.p3m_short_columns_pallas(
        jnp.asarray(pos), jnp.asarray(mass), BOX, 0.1, float(r_s),
        float(r_cut), G=1.5, **kw)
    got, gov = tc.p3m_short_columns(torch.tensor(pos), torch.tensor(mass),
                                    BOX, 0.1, float(r_s), float(r_cut),
                                    G=1.5, **kw)
    assert int(gov) == int(wov) == 0
    assert _max_rel(got.numpy(), want) <= ACC_TOL


def _tiny_run_config(shortrange):
    return JConfig(n_side=8, box=200.0, solver="p3m", pm_grid=32, n_steps=3,
                   shortrange=shortrange,
                   output=JOutput(snapshot_times=(1.0,), powerspec_bins=8,
                                  snapshot=False))


def run_both(jcfg, tmp_path, state_arrays):
    """The same config and float32 initial state through both drivers."""
    jstate = JState.create(*[jnp.asarray(a) for a in state_arrays],
                           dtype=jnp.float32)
    want = j_run(jcfg, 0, str(tmp_path / "jax"), initial_state=jstate)
    got = t_run(TConfig.from_dict(jcfg.to_dict()), 0,
                str(tmp_path / "torch"), device="cpu",
                initial_state=state_from_numpy(*state_arrays, device="cpu"))
    return want, got


def check_run(want, got, box):
    d = got.state.pos.double().numpy() - np.asarray(want.state.pos,
                                                    np.float64)
    d -= box * np.round(d / box)
    assert np.abs(d).max() <= RUN_TOL * box
    assert float(got.state.time) == pytest.approx(1.0, rel=1e-6)
    assert got.config_run.to_dict() == want.config_run.to_dict()


def test_columns_run_matches_jax(tmp_path):
    """run_simulation(shortrange='columns') for 3 steps from the JAX
    package's ICs: the same final positions and healed config."""
    jcfg = _tiny_run_config("columns")
    st = jsim.realize_ics(jcfg, 0)
    arrays = [np.asarray(x, np.float32) for x in (st.pos, st.vel, st.mass,
                                                  st.time)]
    want, got = run_both(jcfg, tmp_path, arrays)
    check_run(want, got, jcfg.box)
    assert tsim._resolved_shortrange(got.config) == "columns"
    assert os.path.exists(got.powerspecs[0])
