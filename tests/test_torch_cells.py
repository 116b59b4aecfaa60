"""The torch port's cell tier against the JAX package, on the CPU: the cell
list and the ghost-padded cell plane (exactly equal), K6's plain version
in its one- and two-plane forms against the JAX package's cell kernel,
and p3m_short_cells_pallas[_masked], the CPU path of the 'cells' tier and
of the rung tier's interior ticks.

Inputs are made with numpy from a seed.  Both packages build their cell
planes in float32.  The kernels themselves are compared on float64 copies
of the same planes (the JAX kernel in Pallas interpret mode, as
tests/test_cells.py runs it), where only the summation order differs:
relative L2 1e-9.  The whole functions sum float32 planes in both
packages, so they agree to float32 summation order: ACC_TOL, the JAX
package's own tier-vs-tier tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.forces import p3m as jp3m
from nbody.mesh import cells as jcells
from nbody_torch.forces import p3m as tp3m
from nbody_torch.mesh import cells as tcells

# float64 kernels on the same plane: summation order only
KERNEL_REL_L2 = 1e-9
# float32 planes in both packages (tests/test_torch_columns.py)
ACC_TOL = 2e-5
BOX, EPS, R_S = 100.0, 0.3, 4.0
R_CUT = 0.999 * BOX / 4


def _particles(n, seed):
    """Uniform positions plus a clump (so that cells spill at small
    capacities), some of them outside [0, box), and masses."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.1 * BOX, 1.1 * BOX, (n, 3))
    pos[: n // 20] = rng.normal(0.3 * BOX, 2.0, (n // 20, 3))
    return pos.astype(np.float32), rng.uniform(0.5, 2.0, n).astype(np.float32)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("case", ["all", "valid", "spill"])
def test_build_cell_list_matches_jax(case):
    pos, _ = _particles(700, seed=1)
    valid = np.random.default_rng(2).uniform(size=700) < 0.4
    cap = 4 if case == "spill" else 64
    v = valid if case == "valid" else None
    want = jcells.build_cell_list(jnp.asarray(pos), BOX, 4, cap,
                                  valid=None if v is None else jnp.asarray(v))
    got = tcells.build_cell_list(torch.tensor(pos), BOX, 4, cap,
                                 valid=None if v is None else torch.tensor(v))
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (int(got.overflow) > 0) == (case == "spill")
    assert tcells.cell_capacity(32768, 11) == jcells.cell_capacity(32768, 11)


@pytest.mark.parametrize("case", ["all", "valid", "spill"])
def test_build_padded_plane_matches_jax(case):
    """Plane, overflow, K and slot map equal the JAX package's; the counts
    the port adds are those of the plane's massive slots."""
    pos, mass = _particles(700, seed=3)
    valid = np.random.default_rng(4).uniform(size=700) < 0.3
    cap = 5 if case == "spill" else 48
    v = valid if case == "valid" else None
    build = jax.jit(jp3m.build_padded_plane, static_argnums=(2, 3, 4, 5))
    want = build(jnp.asarray(pos), jnp.asarray(mass), BOX, R_CUT, 4, cap,
                 None if v is None else jnp.asarray(v))
    got = tp3m.build_padded_plane(torch.tensor(pos), torch.tensor(mass), BOX,
                                  R_CUT, 4, cap,
                                  valid=None if v is None else torch.tensor(v))
    plane, ov, K, gidx, counts = got
    np.testing.assert_array_equal(plane.numpy(), np.asarray(want[0]))
    assert int(ov) == int(want[1]) and K == want[2] == 128
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(want[3]))
    massive = (plane[3].reshape(-1, K) > 0).sum(dim=1)
    np.testing.assert_array_equal(counts.numpy(), massive.numpy())
    assert (int(ov) > 0) == (case == "spill")


@pytest.fixture(scope="module")
def planes():
    """A full plane and an active-target plane of one seeded state."""
    pos, mass = _particles(900, seed=5)
    act = np.random.default_rng(6).uniform(size=900) < 0.25
    full = tp3m.build_padded_plane(torch.tensor(pos), torch.tensor(mass),
                                   BOX, R_CUT, 4, 96)
    tgt = tp3m.build_padded_plane(torch.tensor(pos), torch.tensor(mass), BOX,
                                  R_CUT, 4, 32, valid=torch.tensor(act))
    assert int(full[1]) == int(tgt[1]) == 0
    return full, tgt


@pytest.mark.parametrize("two_plane", [False, True])
@pytest.mark.parametrize("split,softening", [("spline", "spline"),
                                             ("gaussian", "plummer")])
def test_cell_plane_plain_matches_jax_kernel(planes, two_plane, split,
                                             softening):
    (plane, _, K, _, counts), (plane_i, _, K_i, gidx_i, counts_i) = planes
    kw = dict(nx=4, ncell=4, eps2=EPS**2, r_s=R_S, r_cut=R_CUT, split=split,
              softening=softening)
    if two_plane:
        want = jp3m.run_cell_plane(jnp.asarray(plane_i.double().numpy()),
                                   K=K_i, plane_j=jnp.asarray(
                                       plane.double().numpy()), K_j=K, **kw)
        got = tp3m.run_cell_plane(plane_i.double(), counts_i, K=K_i,
                                  plane_j=plane.double(), K_j=K,
                                  counts_j=counts, **kw)
    else:
        want = jp3m.run_cell_plane(jnp.asarray(plane.double().numpy()), K=K,
                                   **kw)
        got = tp3m.run_cell_plane(plane.double(), counts, K=K, **kw)
    # the real cells' slots (the JAX kernel leaves ghost cells unwritten)
    cells = tp3m._real_cells(4, 4, "cpu")
    slots = (cells[:, None] * got.shape[1] // 6**3
             + torch.arange(got.shape[1] // 6**3)[None, :]).reshape(-1)
    w = np.asarray(want)[:3, slots.numpy()]
    assert _rel_l2(got[:3, slots].numpy(), w) <= KERNEL_REL_L2
    assert float(got[3:].abs().max()) == 0.0
    if two_plane:
        # the targets' own slots carry every nonzero sum
        assert float(got[:3, gidx_i[gidx_i < got.shape[1]]].abs().sum()) > 0


@pytest.mark.parametrize("split", ["spline", "gaussian"])
def test_p3m_short_cells_matches_jax(split):
    pos, mass = _particles(900, seed=7)
    kw = dict(ncell=4, capacity=40, split=split, softening="spline")
    want, wov = jp3m.p3m_short_cells_pallas(
        jnp.asarray(pos), jnp.asarray(mass), BOX, EPS, R_S, R_CUT, G=1.5,
        **kw)
    got, gov = tp3m.p3m_short_cells_pallas(
        torch.tensor(pos), torch.tensor(mass), BOX, EPS, R_S, R_CUT, G=1.5,
        **kw)
    assert int(gov) == int(wov) > 0  # the clump spills
    assert np.abs(got.numpy() - np.asarray(want)).max() <= \
        ACC_TOL * np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("target_capacity", [32, 8])
def test_p3m_short_cells_masked_matches_jax(target_capacity):
    """Forces on the targets, zeros elsewhere; the source and target
    overflows and the densest target cell are the JAX package's (8 slots
    spill the target plane)."""
    pos, mass = _particles(900, seed=8)
    act = np.random.default_rng(9).uniform(size=900) < 0.3
    kw = dict(ncell=4, capacity=96, target_capacity=target_capacity,
              split="spline", softening="spline")
    want = jp3m.p3m_short_cells_pallas_masked(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(act), BOX, EPS,
        R_S, R_CUT, G=1.5, **kw)
    got = tp3m.p3m_short_cells_pallas_masked(
        torch.tensor(pos), torch.tensor(mass), torch.tensor(act), BOX, EPS,
        R_S, R_CUT, G=1.5, **kw)
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]
    assert (int(got[2]) > 0) == (target_capacity == 8)
    g, w = got[0].numpy(), np.asarray(want[0])
    assert np.abs(g - w).max() <= ACC_TOL * np.abs(w).max()
    assert np.all(g[~act] == 0.0)


def test_cells_tier_resolves_and_runs():
    """p3m_acc's 'cells' tier is the cell plane's force plus the PM part,
    and agrees with the dense tier where nothing spills."""
    pos, mass = _particles(600, seed=10)
    pos = torch.tensor(pos).double().remainder(BOX)
    mass = torch.tensor(mass).double()
    kw = dict(G=1.0, eps=EPS, split="spline", softening="spline",
              with_overflow=True)
    assert tp3m.resolve_shortrange("cells", 600, BOX, 24.0, 32) == "cells"
    cells, ov = tp3m.p3m_acc(pos, mass, BOX, 32, shortrange="cells",
                             capacity=128, **kw)
    dense, _ = tp3m.p3m_acc(pos, mass, BOX, 32, shortrange="allpairs", **kw)
    assert int(ov) == 0
    assert float((cells - dense).abs().max()) <= \
        ACC_TOL * float(dense.abs().max())


def test_cells_run_matches_jax(tmp_path):
    """run_simulation(shortrange='cells') for 3 steps from the JAX
    package's ICs: the same final positions, pre-warm lines and healed
    config (float32, tests/test_torch_columns.py's run tolerance)."""
    import os

    from nbody.driver import simulate as jsim
    from test_torch_columns import _tiny_run_config, check_run, run_both

    # a 4^3 cell grid (r_cut 46.9 Mpc)
    jcfg = _tiny_run_config("cells").replace(pm_grid=24)
    st = jsim.realize_ics(jcfg, 0)
    arrays = [np.asarray(x, np.float32) for x in (st.pos, st.vel, st.mass,
                                                  st.time)]
    want, got = run_both(jcfg, tmp_path, arrays)
    check_run(want, got, jcfg.box)

    def prewarm(run):
        with open(os.path.join(tmp_path, run, "run.log")) as f:
            return [line for line in f if "pre-warming" in line]

    assert prewarm("torch") == prewarm("jax") and prewarm("torch")
