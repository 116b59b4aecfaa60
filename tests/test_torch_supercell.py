"""The torch port's supercell tier against the JAX package, on the CPU:
the tier geometry and resolution rules, K2's plain version (deposit +
fold), p3m_supercell_acc (K2 + FFT + K3's plain version), a 3-step
'supercell' run, the driver's pre-warm and heal sequence, and the 16^3
supercell run against the committed JAX P(k).

Inputs are made with numpy from a seed and handed to both packages in
float32 (the column plane's type in both); the JAX kernels run in Pallas
interpret mode, as tests/test_supercell.py runs them.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.driver import simulate as jsim
from nbody.driver.config import OutputConfig as JOutput
from nbody.driver.config import SimulationConfig as JConfig
from nbody.forces import p3m as jp3m
from nbody.forces import pm_supercell as js
from nbody_torch.driver import OutputConfig as TOutput
from nbody_torch.driver import SimulationConfig as TConfig
from nbody_torch.driver import run_simulation as t_run
from nbody_torch.driver import simulate as tsim
from nbody_torch.driver.simulate import realize_ics
from nbody_torch.forces import p3m as tp3m
from nbody_torch.forces import p3m_columns as tc
from nbody_torch.forces import pm_supercell as ts
from test_torch_columns import (
    ACC_TOL,
    _max_rel,
    _tiny_run_config,
    _uniform,
    check_run,
    run_both,
)

# mass grids: float32 node weights summed in another order (matrix
# products in both, grouped differently), relative to the largest node
DEPOSIT_TOL = 5e-5
# the 16^3 run's P(k) against the JAX run's, bin by bin for k <= k_Nyq/2
# (float32 in both; see chip_smoke.py)
PK_REL_TOL = 1e-3
BOX, NMESH = 100.0, 32
PORT_DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")


@pytest.fixture(autouse=True)
def _clear_port_capacity_memory():
    yield
    tsim._CAPACITY_MEMORY.clear()


BIG = JConfig(n_side=48, box=500.0, solver="p3m", pm_grid=128)
CONFIGS = {
    "production": BIG,
    "prime_mesh": BIG.replace(pm_grid=127),
    "small_n": BIG.replace(n_side=8),
    "healed_capacity": BIG.replace(column_capacity=65536),
    "healed_window": BIG.replace(column_capacity=2560, column_window=3072),
    "cfg64": JConfig(n_side=64, box=500.0, pm_grid=128, n_steps=142,
                     softening_kernel="spline"),
    "n16_supercell": JConfig(n_side=16, shortrange="supercell"),
    "tiny_supercell": _tiny_run_config("supercell"),
    "tiny_columns": _tiny_run_config("columns"),
    "small_box": BIG.replace(box=50.0, pm_grid=8, shortrange="supercell"),
    "cells": BIG.replace(shortrange="cells"),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tier_rules_match_jax(name):
    """The driver's tier, chaining grid and capacity knob, and the force
    side's geometry helpers, equal the JAX package's on a table of
    configs (prime mesh, small N, healed capacities among them)."""
    jcfg = CONFIGS[name]
    tcfg = TConfig.from_dict(jcfg.to_dict())
    tier = jsim._resolved_shortrange(jcfg)
    assert tsim._resolved_shortrange(tcfg) == tier
    assert tsim._tier_capacity(tcfg) == jsim._tier_capacity(jcfg)
    box, nmesh, n = jcfg.box, jcfg.mesh_size, jcfg.n_particles
    if tier in ("columns", "supercell"):
        assert tsim._tier_ncell(tcfg, tier) == jsim._tier_ncell(jcfg, tier)
    r_cut = tp3m.p3m_short_params(box, nmesh, n)[1]
    sc = tp3m.supercell_ncell(box, nmesh, r_cut)
    assert sc == jp3m.supercell_ncell(box, nmesh, r_cut)
    assert ts.supercell_params(box, nmesh, n) == \
        js.supercell_params(box, nmesh, n)
    for ncell in {sc or 4, 3, 8, 16, 22}:
        assert ts.supercell_geometry(nmesh, ncell) == \
            js.supercell_geometry(nmesh, ncell)
    ck = jcfg.column_capacity or 1280
    assert ts.supercell_stride_ok(box, r_cut, ck) == \
        js.supercell_stride_ok(box, r_cut, ck)


@pytest.fixture(scope="module")
def plane_case():
    """One seeded plane on the supercell geometry, built by the port (its
    equality with the JAX plane is tested in test_torch_columns.py)."""
    n = 1500
    pos, mass = _uniform(n, BOX, seed=7)
    r_s, r_cut, ncell, ck, w = js.supercell_params(BOX, NMESH, n)
    CK, gz, stride, W, maxch, chunk = tc.plane_geometry(BOX, r_cut, ck, w)
    plane, ws, nch, ovb, ovw, gidx, counts = tc.build_column_plane(
        torch.tensor(pos), torch.tensor(mass), BOX, r_cut, ncell, CK, W,
        chunk=chunk)
    assert int(ovb) == int(ovw) == 0
    return dict(pos=pos, mass=mass, r_s=r_s, r_cut=r_cut, ncell=ncell,
                ck=ck, w=w, gz=gz, stride=stride, plane=plane, counts=counts)


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_deposit_matches_jax(plane_case, shift):
    """K2's plain version + fold against the JAX package's deposit kernel
    and fold on the same plane; the mass is conserved."""
    c = plane_case
    kw = dict(box=BOX, nmesh=NMESH, ncell=c["ncell"], stride=c["stride"],
              gz=c["gz"], shift=shift)
    want = js.supercell_deposit_from_plane(
        jnp.asarray(c["plane"].numpy()), jnp.asarray(c["counts"].numpy()),
        **kw)
    got = ts.supercell_deposit_from_plane(c["plane"], c["counts"], **kw)
    assert _max_rel(got.numpy(), want) <= DEPOSIT_TOL
    assert float(got.sum()) == pytest.approx(float(c["mass"].sum()),
                                             rel=1e-5)


@pytest.mark.parametrize("variant", [
    ("spline", False, False), ("spline", True, False),
    ("gaussian", False, False), ("gaussian", True, False),
    ("spline", True, True),
])
def test_p3m_supercell_acc_matches_jax(plane_case, variant):
    """The fused tier, both splits x interlacing, and part_split (the long
    and short halves from one evaluation)."""
    split, interlace, part_split = variant
    c = plane_case
    kw = dict(eps=0.1, r_s=float(c["r_s"]), r_cut=float(c["r_cut"]),
              split=split, softening="spline", ncell=c["ncell"],
              col_capacity=c["ck"], window=c["w"], interlace=interlace,
              part_split=part_split)
    want = js.p3m_supercell_acc(jnp.asarray(c["pos"]), jnp.asarray(c["mass"]),
                                BOX, NMESH, G=1.3, **kw)
    got = ts.p3m_supercell_acc(torch.tensor(c["pos"]),
                               torch.tensor(c["mass"]), BOX, NMESH, G=1.3,
                               **kw)
    assert int(got[-1]) == int(want[-1]) == 0
    if part_split:
        scale = np.abs(np.asarray(want[0]) + np.asarray(want[1])).max()
        for g, w in zip(got[:2], want[:2]):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= ACC_TOL * scale
    else:
        assert _max_rel(got[0].numpy(), want[0]) <= ACC_TOL


def test_supercell_run_matches_jax(tmp_path):
    """run_simulation(shortrange='supercell') for 3 steps from the JAX
    package's ICs: the same final positions and healed config."""
    jcfg = _tiny_run_config("supercell")
    st = jsim.realize_ics(jcfg, 0)
    arrays = [np.asarray(x, np.float32) for x in (st.pos, st.vel, st.mass,
                                                  st.time)]
    want, got = run_both(jcfg, tmp_path, arrays)
    check_run(want, got, jcfg.box)
    assert tsim._resolved_shortrange(got.config) == "supercell"


def _heal_lines(run_dir):
    with open(os.path.join(run_dir, "run.log")) as f:
        return [line for line in f
                if "pre-warming" in line or "re-running segment" in line]


@pytest.mark.parametrize("case", ["blob", "forced_small"])
def test_capacity_heal_matches_jax(tmp_path, case):
    """The driver's pre-warm and heal lines and healed config equal the
    JAX driver's.  'blob': 200 particles near z = 0 in one column; the
    pre-warm grows the capacity and the window, the blob's wrap ghosts
    then spill the ghost band (bucket field), and the heal doubles the
    capacity and widens the window.  'forced_small': a uniform state with
    column_capacity and column_window forced to 128 slots, which the
    pre-warm grows."""
    jcfg = _tiny_run_config("supercell").replace(
        a_begin=0.5, n_steps=2,
        output=JOutput(snapshot_times=(), powerspec=False, snapshot=False))
    rng = np.random.default_rng(5)
    n = jcfg.n_particles
    pos = rng.uniform(0.0, jcfg.box, (n, 3))
    if case == "blob":
        pos[:200] = [60.0, 60.0, 2.0] + rng.uniform(0.0, 25.0, (200, 3)) * [
            1.0, 1.0, 0.5]
    else:
        jcfg = jcfg.replace(column_capacity=128, column_window=128)
    mass = float(np.asarray(jsim.realize_ics(jcfg, 0).mass)[0])
    arrays = [pos.astype(np.float32), np.zeros((n, 3), np.float32),
              np.full(n, mass, np.float32), np.float32(0.5)]
    want, got = run_both(jcfg, tmp_path, arrays)
    lines = _heal_lines(tmp_path / "torch")
    assert lines == _heal_lines(tmp_path / "jax")
    assert lines
    if case == "blob":
        assert any("re-running segment" in line for line in lines)
    assert got.config_run.to_dict() == want.config_run.to_dict()
    assert got.config_run.column_capacity > 0


def test_n16_supercell_pk_matches_committed_jax_reference(tmp_path):
    """The 16^3 supercell run (142 steps) on the CPU from the committed
    JAX white noise: its P(k) at a = 1 matches the committed JAX P(k)."""
    cfg = TConfig(n_side=16, shortrange="supercell",
                  output=TOutput(snapshot=False))
    noise = np.load(os.path.join(PORT_DATA, "white_noise_n16_seed0.npy"))
    ref = np.loadtxt(os.path.join(PORT_DATA,
                                  "powerspec_a=1.00_n16_supercell_seed0"))
    state = realize_ics(cfg, 0, device="cpu", noise=noise)
    res = t_run(cfg, 0, str(tmp_path), device="cpu", initial_state=state)
    got = np.loadtxt(res.powerspecs[0])
    np.testing.assert_array_equal(got[:, 1], ref[:, 1])
    m = ref[:, 0] <= 0.5 * np.pi * cfg.mesh_size / cfg.box
    assert np.abs(got[m, 2] / ref[m, 2] - 1.0).max() <= PK_REL_TOL
