"""The torch port's frozen column plans against the JAX package, on the
CPU: freeze_column_plan and plan_drift_ok, K5's plain version (the masked
column pair sum) and the frozen evaluations p3m_short_columns_frozen
[_masked], p3m_supercell_frozen and p3m_supercell_acc(with_plan=True), at
the freeze positions and at a drift just under skin/2 (where the plane's
coordinates leave the box and the frozen columns); and a rung run whose
boundaries ride frozen plans refrozen by freeze_column_plan.

Inputs are made with numpy from a seed; one JAX plan feeds both packages
(``nbody_torch.convert.plan_from_numpy``).  Plans are equal exactly.  The
masked pair sum is compared with the JAX package's column kernel on a
float64 copy of one plane (relative L2 1e-9, summation order only); the
whole functions sum float32 planes in both packages (ACC_TOL, as in
tests/test_torch_columns.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.forces import p3m_columns as jc
from nbody.forces import pm_supercell as js
from nbody_torch.convert import plan_from_numpy
from nbody_torch.driver import simulate as tsim
from nbody_torch.forces import p3m_columns as tc
from nbody_torch.forces import pm_supercell as ts
from test_torch_rungs import supercell_rung_run_check

KERNEL_REL_L2 = 1e-9
ACC_TOL = 2e-5
BOX, NMESH, N = 100.0, 32, 1500
EPS = 0.3
R_S, R_CUT, NCELL, CK, W = js.supercell_params(BOX, NMESH, N)
# below the xy slack 0.49 (box / ncell - r_cut) = 3.63 and 1.8 mesh cells
SKIN = 3.0
GEO = dict(ncell=NCELL, col_capacity=CK, window=W)


@pytest.fixture(autouse=True)
def _clear_port_capacity_memory():
    yield
    tsim._CAPACITY_MEMORY.clear()


def _state(seed=11):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, BOX, (N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, N).astype(np.float32)
    return pos, mass


def _drifted(pos, frac, seed=12):
    """pos moved by frac * skin/2 in random directions (float32)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=pos.shape)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return (pos + frac * 0.5 * SKIN * u).astype(np.float32)


def _jplan(pos, mass, ck=CK, w=W):
    return jc.freeze_column_plan(jnp.asarray(pos), jnp.asarray(mass), BOX,
                                 R_CUT, NCELL, ck, w, skin=SKIN)


def _port_plan(jplan):
    return plan_from_numpy(*[np.asarray(f) for f in jplan], device="cpu")


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", ["sized", "tiny_capacity"])
def test_freeze_column_plan_matches_jax(case):
    pos, mass = _state()
    ck, w = (CK, W) if case == "sized" else (128, 128)
    want = _jplan(pos, mass, ck, w)
    got = tc.freeze_column_plan(torch.tensor(pos), torch.tensor(mass), BOX,
                                R_CUT, NCELL, ck, w, skin=SKIN)
    assert got._fields == want._fields
    for name, g, wv in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv),
                                      err_msg=name)
    assert (int(got.ov) > 0) == (case == "tiny_capacity")


@pytest.mark.parametrize("frac", [0.0, 0.99, 1.01])
def test_plan_drift_ok_matches_jax(frac):
    pos, mass = _state()
    jplan = _jplan(pos, mass)
    moved = pos.copy()
    moved[:40] = _drifted(pos, frac)[:40]
    want = bool(jc.plan_drift_ok(jnp.asarray(moved), jplan, BOX, SKIN))
    got = bool(tc.plan_drift_ok(torch.tensor(moved), _port_plan(jplan), BOX,
                                SKIN))
    assert got == want == (frac < 1.0)


@pytest.fixture(scope="module")
def frozen_case():
    pos, mass = _state()
    jplan = _jplan(pos, mass)
    act = np.random.default_rng(13).uniform(size=N) < 0.004
    return pos, mass, jplan, _port_plan(jplan), act


@pytest.mark.parametrize("frac", [0.0, 0.99])
def test_masked_pair_sum_matches_jax_kernel(frozen_case, frac):
    """K5's plain version on the frozen plane at the drifted positions, in
    float64, against the JAX package's column kernel on the same plane
    restricted to the active chunks."""
    pos, mass, jplan, plan, act = frozen_case
    CKq, gz, stride, Wq, maxch, chunk = tc.plane_geometry(BOX, R_CUT, CK, W)
    plane, interior, _ = tc.frozen_plane(torch.tensor(_drifted(pos, frac)),
                                         torch.tensor(mass), plan, BOX, R_CUT,
                                         NCELL, CKq, gz, stride)
    nch_act, cht = tc.active_chunk_table(
        torch.tensor(act), plan, interior, ncell=NCELL, CK=CKq, gz=gz,
        maxch=maxch, chunk=chunk)
    kw = dict(ncell=NCELL, stride=stride, W=Wq, maxch=maxch, gz=gz,
              chunk=chunk, eps=EPS, r_s=R_S, r_cut=R_CUT, split="spline",
              softening="spline")
    p64 = plane.double()
    got = tc.run_column_plane_masked(p64, plan.ws, nch_act, cht, **kw)
    full = np.asarray(jc._run_column_kernel(
        jnp.asarray(p64.numpy()), jnp.asarray(plan.ws.numpy()),
        jnp.asarray(plan.nch.numpy()), interpret=True, **kw))
    _, _, first = tc.interior_slots(NCELL, stride, gz, chunk, nch_act,
                                    cht=cht, maxch=maxch)
    slots = (first[:, None] + torch.arange(chunk)[None, :]).reshape(-1)
    assert 0 < int(nch_act.sum()) < int(plan.nch.sum())
    want = np.zeros_like(full)
    want[:3, slots.numpy()] = full[:3, slots.numpy()]
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) \
        <= KERNEL_REL_L2


@pytest.mark.parametrize("frac", [0.0, 0.99])
def test_frozen_columns_match_jax(frozen_case, frac):
    """p3m_short_columns_frozen and its masked form at the freeze
    positions and near skin/2: the active rows' forces, zero rows outside
    the active chunks, and the plan's overflow word."""
    pos, mass, jplan, plan, act = frozen_case
    moved = _drifted(pos, frac)
    kw = dict(G=1.5, split="spline", softening="spline", **GEO)
    args = (BOX, EPS, R_S, R_CUT)
    want, wov = jc.p3m_short_columns_frozen(
        jnp.asarray(moved), jnp.asarray(mass), jplan, *args, **kw)
    got, gov = tc.p3m_short_columns_frozen(
        torch.tensor(moved), torch.tensor(mass), plan, *args, **kw)
    assert int(gov) == int(wov) == 0
    assert _max_rel(got.numpy(), want) <= ACC_TOL
    wm, _ = jc.p3m_short_columns_frozen_masked(
        jnp.asarray(moved), jnp.asarray(mass), jnp.asarray(act), jplan,
        *args, **kw)
    gm, _ = tc.p3m_short_columns_frozen_masked(
        torch.tensor(moved), torch.tensor(mass), torch.tensor(act), plan,
        *args, **kw)
    wm, gm = np.asarray(wm), gm.numpy()
    np.testing.assert_array_equal(gm == 0.0, wm == 0.0)
    assert np.abs(gm - wm).max() <= ACC_TOL * np.abs(wm).max()
    # the active rows carry the unmasked force
    assert np.abs(gm[act] - got.numpy()[act]).max() <= \
        ACC_TOL * np.abs(wm).max()


def test_all_chunks_active_equals_frozen_k4(frozen_case):
    """K5 with every chunk in the table is K4 on the same frozen plane."""
    pos, mass, _, plan, _ = frozen_case
    moved = torch.tensor(_drifted(pos, 0.5))
    kw = dict(split="spline", softening="spline", **GEO)
    full, _ = tc.p3m_short_columns_frozen(moved, torch.tensor(mass), plan,
                                          BOX, EPS, R_S, R_CUT, **kw)
    masked, _ = tc.p3m_short_columns_frozen_masked(
        moved, torch.tensor(mass), torch.ones(N, dtype=torch.bool), plan,
        BOX, EPS, R_S, R_CUT, **kw)
    assert torch.equal(full, masked)


@pytest.mark.parametrize("interlace", [False, True])
def test_p3m_supercell_frozen_matches_jax(frozen_case, interlace):
    """The frozen supercell evaluation (K2 + FFT + K3 on the frozen plane,
    both halves) near skin/2, and the port's against a fresh evaluation
    at the same positions."""
    pos, mass, jplan, plan, _ = frozen_case
    moved = _drifted(pos, 0.99)
    kw = dict(G=1.3, eps=EPS, r_s=R_S, r_cut=R_CUT, split="spline",
              softening="spline", part_split=True, interlace=interlace, **GEO)
    want = js.p3m_supercell_frozen(jnp.asarray(moved), jnp.asarray(mass),
                                   jplan, BOX, NMESH, **kw)
    got = ts.p3m_supercell_frozen(torch.tensor(moved), torch.tensor(mass),
                                  plan, BOX, NMESH, **kw)
    fresh = ts.p3m_supercell_acc(torch.tensor(moved), torch.tensor(mass),
                                 BOX, NMESH, **kw)
    assert int(got[2]) == int(want[2]) == int(fresh[2]) == 0
    scale = np.abs(np.asarray(want[0]) + np.asarray(want[1])).max()
    for g, w, f in zip(got[:2], want[:2], fresh[:2]):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= ACC_TOL * scale
        assert float((g - f).abs().max()) <= ACC_TOL * scale


def test_p3m_supercell_acc_with_plan_matches_jax(frozen_case):
    """The fresh evaluation that emits the next plan: the same forces and
    a plan equal to freeze_column_plan's at the same positions."""
    pos, mass, jplan, _, _ = frozen_case
    kw = dict(G=1.3, eps=EPS, r_s=R_S, r_cut=R_CUT, split="spline",
              softening="spline", part_split=True, skin=SKIN,
              with_plan=True, **GEO)
    want = js.p3m_supercell_acc(jnp.asarray(pos), jnp.asarray(mass), BOX,
                                NMESH, **kw)
    got = ts.p3m_supercell_acc(torch.tensor(pos), torch.tensor(mass), BOX,
                               NMESH, **kw)
    for name, g, w in zip(jplan._fields, got[3], want[3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for name, g, w in zip(jplan._fields, got[3], jplan):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    scale = np.abs(np.asarray(want[0]) + np.asarray(want[1])).max()
    for g, w in zip(got[:2], want[:2]):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= ACC_TOL * scale


def test_supercell_rung_run_refreezes_plans_like_jax(tmp_path):
    """The rung tier on the supercell tier where the skin cannot cover a
    step's deepest-rung drift (mesh 24: S = 6 mesh cells a column, skin
    0.46 Mpc): the boundaries ride frozen plans, refrozen by
    freeze_column_plan when they drift, and the interior ticks run K6."""
    supercell_rung_run_check(tmp_path, 24, 3)

