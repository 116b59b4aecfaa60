"""The torch port's CUDA kernels on the card: K1-K8 against their plain
versions, their wrappers' checks and launch counts, and tiny runs on the
GPU against the same runs on the CPU.  Skipped without a GPU.  On a machine
with one (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from nbody_torch.driver import OutputConfig, SimulationConfig, run_simulation
from nbody_torch.forces.p3m import p3m_short_acc, p3m_short_plain

pytestmark = pytest.mark.cuda

VARIANTS = [(s, k) for s in ("gaussian", "spline") for k in ("plummer", "spline")]
# float32 kernel against the float64 plain version (see chip_smoke.py)
K1_REL_L2_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _particles(n, box, cuda, seed=0):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 3), generator=g, dtype=torch.float64) * box
    mass = 0.5 + torch.rand(n, generator=g, dtype=torch.float64)
    return pos.to(cuda, torch.float32), mass.to(cuda, torch.float32)


@pytest.mark.parametrize("split,softening", VARIANTS)
@pytest.mark.parametrize("n", [5, 3001])
def test_k1_matches_plain(cuda, split, softening, n):
    box, r_s, r_cut, eps = 100.0, 3.0, 13.5, 0.3
    pos, mass = _particles(n, box if n > 5 else 10.0, cuda)
    before = p3m_short_acc.launches
    got = p3m_short_acc(pos, mass, box, eps, r_s, r_cut, G=2.0, split=split,
                        softening=softening)
    torch.cuda.synchronize()
    assert p3m_short_acc.launches == before + 1
    ref = p3m_short_plain(pos.double(), mass.double(), box, eps, r_s, r_cut,
                          G=2.0, split=split, softening=softening)
    assert got.shape == (n, 3) and got.dtype == torch.float32
    assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL


def _k1_set(kind, n, box, cuda, seed=0):
    """Clustered (Plummer spheres of scale 0.02 box around 6 centres) or
    edge-straddling (a slab and a clump across the periodic edges, and
    particles at the box side) positions, float32 on the card."""
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        c = rng.uniform(0.0, box, (6, 3))
        u = rng.uniform(1e-3, 0.999, n)
        r = np.minimum(0.02 * box / np.sqrt(u ** (-2.0 / 3.0) - 1.0),
                       0.3 * box)
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pos = (c[rng.integers(0, 6, n)] + r[:, None] * v) % box
    else:
        pos = rng.uniform(0.0, box, (n, 3))
        pos[: n // 2, 0] = rng.normal(0.0, 0.02 * box, n // 2) % box
        pos[n // 2:] = rng.normal(0.0, 0.05 * box, (n - n // 2, 3)) % box
        pos[:8] = box * np.array([1.0, 0.0, 1.0 - 1e-7])
    mass = rng.uniform(0.5, 1.5, n)
    return (torch.tensor(pos, dtype=torch.float32, device=cuda),
            torch.tensor(mass, dtype=torch.float32, device=cuda))


@pytest.mark.parametrize("split,softening", VARIANTS)
@pytest.mark.parametrize("kind", ["clustered", "edge"])
@pytest.mark.parametrize("r_frac", [0.088, 0.4999])
def test_k1_culled_sets_match_plain(cuda, split, softening, kind, r_frac):
    """K1's sort and cull on clustered and edge-straddling sets, at the P3M
    site's r_cut / box (the culled form) and the Ewald site's (the dense
    form): relative L2 and each target (1e-3 of the RMS force, where one
    dropped pair reads O(1e-2)) against float64, two launches equal bit
    for bit."""
    n, box, eps = 3001, 100.0, 0.3
    r_cut = r_frac * box
    r_s = r_cut / 4.5
    pos, mass = _k1_set(kind, n, box, cuda)
    args = (box, eps, r_s, r_cut, 2.0, split, softening)
    got = p3m_short_acc(pos, mass, *args)
    again = p3m_short_acc(pos, mass, *args)
    torch.cuda.synchronize()
    ref = p3m_short_plain(pos.double(), mass.double(), *args)
    assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL
    per_target = ((got.double() - ref).norm(dim=1).max()
                  / ref.norm(dim=1).square().mean().sqrt())
    assert float(per_target) <= 1e-3
    assert torch.equal(got, again)


@pytest.mark.parametrize("box,r_cut", [(500.0, 43.9453125), (500.0, 249.95),
                                       (1.0, 0.0)])
def test_k1_reach_and_tile_are_the_library_s(cuda, box, r_cut):
    """The CPU model of K1's cull (``k1_reach``, ``K1_TILE``, what
    ``k1_plan`` and the CPU tests use) is the kernel library's."""
    import ctypes

    from nbody_torch._kernels import load_library
    from nbody_torch.forces import p3m

    lib = load_library()
    reach = (ctypes.c_double * 1)()
    assert lib.p3m_short_reach(box, r_cut, reach) == 0
    assert reach[0] == p3m.k1_reach(box, r_cut)
    pos = torch.zeros((1, 3), device=cuda)
    assert p3m.k1_card_geometry(pos, box, max(r_cut, 1e-3)).tile \
        == p3m.K1_TILE


def test_k1_wrapper_rejects(cuda):
    pos, mass = _particles(64, 50.0, cuda)
    args = (50.0, 0.1, 2.0, 9.0)
    with pytest.raises(TypeError):
        p3m_short_acc(pos.double(), mass.double(), *args)
    with pytest.raises(ValueError):
        p3m_short_acc(pos.T.contiguous().T, mass, *args)
    with pytest.raises(ValueError):
        p3m_short_acc(pos[:, :2].contiguous(), mass, *args)
    with pytest.raises(ValueError):
        p3m_short_acc(pos, mass[:10], *args)


def test_tiny_run_on_gpu_matches_cpu(cuda, tmp_path):
    cfg = SimulationConfig(n_side=8, box=200.0, solver="p3m", pm_grid=16,
                           n_steps=4, output=OutputConfig(snapshot=False,
                                                          powerspec_bins=8))
    before = p3m_short_acc.launches
    gpu = run_simulation(cfg, 0, str(tmp_path / "gpu"), device=cuda)
    assert p3m_short_acc.launches == before + cfg.n_steps + 1
    cpu = run_simulation(cfg, 0, str(tmp_path / "cpu"), device="cpu")
    d = gpu.state.pos.cpu().double() - cpu.state.pos.double()
    d -= cfg.box * torch.round(d / cfg.box)
    # float32 on both, different summation order, 4 steps
    assert float(d.abs().max()) < 1e-4 * cfg.box
    pg, pc = np.loadtxt(gpu.powerspecs[0]), np.loadtxt(cpu.powerspecs[0])
    np.testing.assert_allclose(pg[:, 2], pc[:, 2], rtol=1e-3)


def _column_case(cuda, n=6000, box=100.0, nmesh=32, seed=2):
    """A uniform plane on the supercell geometry of the JAX tests, with
    the keyword arguments of K3/K4."""
    from nbody_torch.forces.p3m_columns import build_column_plane, plane_geometry
    from nbody_torch.forces.pm_supercell import supercell_geometry, supercell_params

    pos, mass = _particles(n, box, cuda, seed=seed)
    r_s, r_cut, ncell, ck, w = supercell_params(box, nmesh, n)
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut, ck, w)
    plane, ws, nch, ovb, ovw, _, counts = build_column_plane(
        pos, mass, box, r_cut, ncell, CK, W, chunk=chunk)
    assert int(ovb) == int(ovw) == 0
    kw = dict(ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
              chunk=chunk, eps=0.1, r_s=r_s, r_cut=r_cut)
    S = supercell_geometry(nmesh, ncell)[0]
    return plane, ws, nch, counts, kw, S, box, nmesh


@pytest.mark.parametrize("split,softening", VARIANTS)
def test_k4_matches_plain(cuda, split, softening):
    from nbody_torch.forces.p3m_columns import column_plane_plain, run_column_plane

    plane, ws, nch, _, kw, _, box, _ = _column_case(cuda)
    kw.update(split=split, softening=softening)
    before = run_column_plane.launches
    got = run_column_plane(plane, ws, nch, box=box, **kw)
    torch.cuda.synchronize()
    assert run_column_plane.launches == before + 1
    ref = column_plane_plain(plane.double(), ws, nch, **kw)
    assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL


@pytest.mark.parametrize("interlaced,split_out", [(False, False), (True, False),
                                                  (False, True), (True, True)])
def test_k3_matches_plain(cuda, interlaced, split_out):
    from nbody_torch.forces.pm_supercell import (
        fused_column_plane_plain,
        run_fused_column_plane,
    )

    plane, ws, nch, _, kw, S, box, nmesh = _column_case(cuda)
    g = torch.Generator().manual_seed(3)
    grids = torch.randn((6 if interlaced else 3,) + (nmesh,) * 3, generator=g)
    grids = grids.to(cuda)
    kw.update(split="spline", softening="spline", S=S, scale=nmesh / box,
              interlaced=interlaced, split_out=split_out)
    before = run_fused_column_plane.launches
    got = run_fused_column_plane(plane, ws, nch, grids, **kw)
    torch.cuda.synchronize()
    assert run_fused_column_plane.launches == before + 1
    ref = fused_column_plane_plain(plane.double(), ws, nch, grids.double(), **kw)
    assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_k2_matches_plain(cuda, shift):
    from nbody_torch.forces.pm_supercell import (
        deposit_node_masses_plain,
        fold_node_masses,
        supercell_deposit_from_plane,
        supercell_geometry,
    )

    plane, _, _, counts, kw, _, box, nmesh = _column_case(cuda)
    ncell, stride, gz = kw["ncell"], kw["stride"], kw["gz"]
    before = supercell_deposit_from_plane.launches
    got = supercell_deposit_from_plane(plane, counts, box=box, nmesh=nmesh,
                                       ncell=ncell, stride=stride, gz=gz,
                                       shift=shift)
    torch.cuda.synchronize()
    assert supercell_deposit_from_plane.launches == before + 1
    S, ZP = supercell_geometry(nmesh, ncell)
    nodes = deposit_node_masses_plain(plane, counts, ncell=ncell, S=S, ZP=ZP,
                                      stride=stride, gz=gz, scale=nmesh / box,
                                      shift=shift)
    ref = fold_node_masses(nodes, ncell=ncell, S=S, ZP=ZP, nmesh=nmesh)
    # the plain version's float32 sums against the kernel's exact sums
    # rounded once, see chip_smoke.py
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_k2_slots_far_outside_their_column(cuda, shift):
    """Real slots moved 2.5 and 3 cells out of their column in x, y and z
    and by several columns: the deposit matches the CIC deposit of the
    plane's real slots in float64 (the plain version's node grid reaches
    one node past a column, so it cannot hold these), conserves the mass
    and leaves no node unwritten (the output starts unfilled)."""
    from nbody_torch.forces.pm_supercell import supercell_deposit_from_plane
    from nbody_torch.mesh.cic import cic_deposit

    plane, _, _, counts, kw, _, box, nmesh = _column_case(cuda)
    ncell, stride, gz = kw["ncell"], kw["stride"], kw["gz"]
    P = ncell + 2
    cell = box / nmesh
    c = torch.arange(ncell * ncell, device=cuda)
    first = ((c // ncell + 1) * P + c % ncell + 1) * stride + gz
    moved = plane.clone()
    for k, (row, d) in enumerate([(0, 2.5), (0, -3.0), (1, 2.5), (1, -3.0),
                                  (2, 2.5), (2, -3.0), (0, 11.0),
                                  (2, -23.0)]):
        moved[row, first[(3 * k + 1) % first.numel()] + k % 3] += d * cell
    garbage = torch.full((nmesh**3,), float("nan"), device=cuda)
    del garbage
    got = supercell_deposit_from_plane(moved, counts, box=box, nmesh=nmesh,
                                       ncell=ncell, stride=stride, gz=gz,
                                       shift=shift)
    torch.cuda.synchronize()
    slots = torch.cat([first[i] + torch.arange(int(counts[i]), device=cuda)
                       for i in range(ncell * ncell)])
    pos = moved[0:3, slots].T.double()
    ref = cic_deposit(pos, box, nmesh, weights=moved[3, slots].double(),
                      shift=shift)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert float(got.sum()) == pytest.approx(float(moved[3, slots].sum()),
                                             rel=1e-5)


def test_column_wrappers_reject(cuda):
    from nbody_torch.forces.p3m_columns import run_column_plane
    from nbody_torch.forces.pm_supercell import run_fused_column_plane

    plane, ws, nch, _, kw, S, box, nmesh = _column_case(cuda, n=2000)
    kw.update(split="spline", softening="spline")
    with pytest.raises(TypeError):
        run_column_plane(plane.double(), ws, nch, box=box, **kw)
    with pytest.raises(TypeError):
        run_column_plane(plane, ws.long(), nch, box=box, **kw)
    with pytest.raises(ValueError):
        run_column_plane(plane[:4].contiguous(), ws, nch, box=box, **kw)
    with pytest.raises(ValueError):  # the reach search needs the box
        run_column_plane(plane, ws, nch, **kw)
    with pytest.raises(ValueError):  # the drift is one float32 on the card
        run_column_plane(plane, ws, nch, box=box,
                         drift=torch.zeros((), dtype=torch.float64,
                                           device=cuda), **kw)
    with pytest.raises(ValueError):
        run_fused_column_plane(plane, ws, nch,
                               torch.zeros((2, nmesh, nmesh, nmesh), device=cuda),
                               S=S, scale=nmesh / box, **kw)


@pytest.mark.parametrize("shortrange", ["supercell", "columns"])
def test_tiny_column_tier_run_on_gpu_matches_cpu(cuda, tmp_path, shortrange):
    from nbody_torch.forces.p3m_columns import run_column_plane
    from nbody_torch.forces.pm_supercell import run_fused_column_plane

    cfg = SimulationConfig(n_side=8, box=200.0, solver="p3m", pm_grid=32,
                           n_steps=3, shortrange=shortrange,
                           output=OutputConfig(snapshot=False,
                                               powerspec_bins=8))
    kernel = (run_fused_column_plane if shortrange == "supercell"
              else run_column_plane)
    before = kernel.launches
    gpu = run_simulation(cfg, 0, str(tmp_path / "gpu"), device=cuda)
    assert kernel.launches >= before + cfg.n_steps + 1
    cpu = run_simulation(cfg, 0, str(tmp_path / "cpu"), device="cpu")
    d = gpu.state.pos.cpu().double() - cpu.state.pos.double()
    d -= cfg.box * torch.round(d / cfg.box)
    assert float(d.abs().max()) < 1e-4 * cfg.box
    assert gpu.config_run == cpu.config_run


def _cell_case(cuda, n=6000, box=100.0, seed=4, kind="uniform"):
    """A full cell plane (4^3 cells) and an active-target plane of one
    state on the card: uniform; clustered (half the particles in a clump
    of 3 box / 100 around one point); a cell filled to its capacity K (256
    particles in cell (0, 0, 0), the rest outside it); or sparse (uniform,
    9 active particles scattered over the cells)."""
    from nbody_torch.forces.p3m import build_padded_plane

    pos, mass = _particles(n, box, cuda, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    act = torch.rand(n, generator=gen) < 0.1
    cap, tcap = 256, 64
    c = box / 4
    if kind == "clustered":
        pos[: n // 2] = (0.6 * box + 0.03 * box * torch.randn(
            (n // 2, 3), generator=gen)).to(cuda, torch.float32)
        cap = tcap = 3072
    elif kind == "full":
        pos[(pos < c).all(dim=1), 0] += c
        pos[:cap] = (c * (0.3 + 0.4 * torch.rand((cap, 3), generator=gen))
                     ).to(cuda, torch.float32)
    elif kind == "sparse":
        act = torch.zeros(n, dtype=torch.bool)
        act[torch.randperm(n, generator=gen)[:9]] = True
    r_cut = 0.999 * box / 4
    full = build_padded_plane(pos, mass, box, r_cut, 4, cap)
    tgt = build_padded_plane(pos, mass, box, r_cut, 4, tcap,
                             valid=act.to(cuda))
    assert int(full[1]) == int(tgt[1]) == 0
    if kind == "full":
        assert int(full[4].max()) == full[2] == cap
    return full, tgt, dict(nx=4, ncell=4, eps2=0.01, r_s=4.0, r_cut=r_cut)


@pytest.mark.parametrize("split,softening", VARIANTS)
@pytest.mark.parametrize("kind,two_plane", [
    ("uniform", False), ("uniform", True), ("clustered", False),
    ("clustered", True), ("full", False), ("sparse", True)])
def test_k6_matches_plain(cuda, split, softening, kind, two_plane):
    """Relative L2 and per target (1e-3 of the RMS force) against the
    float64 plain version, two launches equal bit for bit."""
    from nbody_torch.forces.p3m import cell_plane_plain, run_cell_plane

    (plane, _, K, _, counts), (plane_i, _, K_i, _, counts_i), kw = \
        _cell_case(cuda, kind=kind)
    kw.update(split=split, softening=softening)
    if two_plane:
        kw.update(plane_j=plane, K_j=K, counts_j=counts)
        plane, K, counts = plane_i, K_i, counts_i
    before = run_cell_plane.launches
    got = run_cell_plane(plane, counts, K=K, **kw)
    again = run_cell_plane(plane, counts, K=K, **kw)
    torch.cuda.synchronize()
    assert run_cell_plane.launches == before + 2
    assert torch.equal(got, again)
    if two_plane:
        kw["plane_j"] = kw["plane_j"].double()
    ref = cell_plane_plain(plane.double(), counts, K=K, **kw)
    assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL
    d = (got[:3].double() - ref[:3]).norm(dim=0)
    r = ref[:3].norm(dim=0)
    assert float(d.max() / r[r > 0].square().mean().sqrt()) <= 1e-3
    assert float(got[3:].abs().max()) == 0.0


@pytest.mark.parametrize("nx,ncell", [(2, 8), (5, 20), (11, 11), (22, 22)])
def test_k6_geometry_on_the_card(cuda, nx, ncell):
    """The library's tile is K6_TILE and the launch shape at the four
    sites' shapes follows k6_geometry's rule on this card's numbers."""
    from nbody_torch._kernels import load_library
    from nbody_torch.forces.p3m import K6_TILE, K6_WARPS, _k6_info, \
        k6_geometry

    info = _k6_info(load_library(), torch.cuda.current_device(), 1, 1)
    assert info[0] == K6_TILE and info[1] > 0 and min(info[2:]) >= 1
    geo = k6_geometry(nx, ncell, info)
    assert geo.warps in K6_WARPS and geo.blocks == nx * ncell * ncell


def test_cell_wrapper_rejects(cuda):
    from nbody_torch.forces.p3m import run_cell_plane

    (plane, _, K, _, counts), _, kw = _cell_case(cuda, n=1000)
    with pytest.raises(TypeError):
        run_cell_plane(plane.double(), counts, K=K, **kw)
    with pytest.raises(TypeError):
        run_cell_plane(plane, counts.long(), K=K, **kw)
    with pytest.raises(ValueError):
        run_cell_plane(plane, counts[:-1].contiguous(), K=K, **kw)
    with pytest.raises(ValueError):
        run_cell_plane(plane, counts, K=K, plane_j=plane, **kw)


def _frozen_case(cuda, frac, n=6000, box=100.0, nmesh=32, seed=5, stale=0):
    """A frozen plan of a uniform state, the plane at positions drifted by
    frac * skin/2 (and ``stale`` particles moved a column side down in z),
    and its active-chunk table (2% of the particles)."""
    from nbody_torch.forces.p3m_columns import (
        active_chunk_table,
        freeze_column_plan,
        frozen_plane,
        plane_geometry,
    )
    from nbody_torch.forces.pm_supercell import supercell_params

    pos, mass = _particles(n, box, cuda, seed=seed)
    r_s, r_cut, ncell, ck, w = supercell_params(box, nmesh, n)
    skin = 3.0
    plan = freeze_column_plan(pos, mass, box, r_cut, ncell, ck, w, skin=skin)
    g = torch.Generator().manual_seed(seed)
    u = torch.randn((n, 3), generator=g, dtype=torch.float64)
    u = (u / u.norm(dim=1, keepdim=True)).to(cuda, torch.float32)
    moved = pos + frac * 0.5 * skin * u
    if stale:  # particles far past skin/2 in z
        moved[torch.randperm(n, generator=g)[:stale], 2] -= box / ncell
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut, ck, w)
    plane, interior, drift = frozen_plane(moved, mass, plan, box, r_cut,
                                          ncell, CK, gz, stride)
    act = (torch.rand(n, generator=g) < 0.02).to(cuda)
    nch_act, cht = active_chunk_table(act, plan, interior, ncell=ncell, CK=CK,
                                      gz=gz, maxch=maxch, chunk=chunk)
    kw = dict(ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
              chunk=chunk, eps=0.1, r_s=r_s, r_cut=r_cut, split="spline",
              softening="spline")
    return plane, plan, nch_act, cht, kw, dict(box=box, drift=drift)


@pytest.mark.parametrize("frac", [0.0, 0.99])
def test_k5_matches_plain(cuda, frac):
    from nbody_torch.forces.p3m_columns import (
        column_plane_plain,
        run_column_plane_masked,
    )

    plane, plan, nch_act, cht, kw, kk = _frozen_case(cuda, frac)
    assert 0 < int(nch_act.sum()) < int(plan.nch.sum())
    before = run_column_plane_masked.launches
    got = run_column_plane_masked(plane, plan.ws, nch_act, cht, **kk, **kw)
    torch.cuda.synchronize()
    assert run_column_plane_masked.launches == before + 1
    ref = column_plane_plain(plane.double(), plan.ws, nch_act, cht=cht, **kw)
    assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL


def test_k5_with_every_chunk_is_k4(cuda):
    from nbody_torch.forces.p3m_columns import (
        run_column_plane,
        run_column_plane_masked,
    )

    plane, plan, _, _, kw, kk = _frozen_case(cuda, 0.5)
    ncol, maxch = kw["ncell"] ** 2, kw["maxch"]
    cht = torch.arange(maxch, device=cuda, dtype=torch.int32).repeat(ncol)
    got = run_column_plane_masked(plane, plan.ws, plan.nch, cht, **kk, **kw)
    assert torch.equal(got, run_column_plane(plane, plan.ws, plan.nch, **kk,
                                             **kw))


def _target_err(got, ref):
    """The largest per-slot |got - ref| over the RMS of |ref| over the
    slots where it is nonzero (chip_smoke.target_err)."""
    d = (got[:6].double() - ref[:6].double()).norm(dim=0)
    r = ref[:6].double().norm(dim=0)
    return float(d.max()) / float(r[r > 0].square().mean().sqrt())


@pytest.mark.parametrize("frac,stale", [(0.0, 0), (0.99, 0), (0.99, 16)])
def test_column_kernels_hold_every_target(cuda, frac, stale):
    """K4 on the fresh plane and K5 on the frozen one (drifted by frac *
    skin/2, with ``stale`` particles a column side past it) hold every
    target to 1e-3 of the RMS force against float64 (one pair dropped from
    a target reads 1e-2 or more) and give the same bits twice: each block
    visits only its targets' reach, widened by the measured drift."""
    from nbody_torch.forces.p3m_columns import (
        column_plane_plain,
        run_column_plane,
        run_column_plane_masked,
    )

    plane, ws, nch, _, kw4, _, box, _ = _column_case(cuda)
    kw4.update(split="spline", softening="spline")
    got = run_column_plane(plane, ws, nch, box=box, **kw4)
    assert torch.equal(got, run_column_plane(plane, ws, nch, box=box, **kw4))
    ref = column_plane_plain(plane.double(), ws, nch, **kw4)
    assert _target_err(got, ref) <= 1e-3
    plane, plan, nch_act, cht, kw, kk = _frozen_case(cuda, frac, stale=stale)
    got = run_column_plane_masked(plane, plan.ws, nch_act, cht, **kk, **kw)
    assert torch.equal(got, run_column_plane_masked(plane, plan.ws, nch_act,
                                                    cht, **kk, **kw))
    ref = column_plane_plain(plane.double(), plan.ws, nch_act, cht=cht, **kw)
    assert _target_err(got, ref) <= 1e-3


def test_tiny_rung_run_on_gpu_matches_cpu(cuda, tmp_path):
    """rungs=3 on the dense tier (K1 boundaries, K6 interior ticks): the
    same populations and positions as the CPU run, in float32."""
    from nbody_torch.forces.p3m import run_cell_plane

    cfg = SimulationConfig(n_side=12, box=60.0, solver="p3m", pm_grid=32,
                           n_steps=4, rungs=3, a_begin=0.2, a_end=0.3,
                           output=OutputConfig(snapshot=False,
                                               powerspec_bins=8))
    before = run_cell_plane.launches
    gpu = run_simulation(cfg, 0, str(tmp_path / "gpu"), device=cuda)
    assert run_cell_plane.launches > before
    cpu = run_simulation(cfg, 0, str(tmp_path / "cpu"), device="cpu")
    d = gpu.state.pos.cpu().double() - cpu.state.pos.double()
    d -= cfg.box * torch.round(d / cfg.box)
    assert float(d.abs().max()) < 1e-4 * cfg.box

    def pops(run):
        with open(tmp_path / run / "run.log") as f:
            return [line.split("   ")[-1] for line in f
                    if "Rung population" in line]

    assert pops("gpu") == pops("cpu") and len(pops("gpu")) == cfg.n_steps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("box", [0.0, 30.0])
@pytest.mark.parametrize("n", [2, 7, 3001])
def test_k7_matches_plain(cuda, dtype, box, n):
    """allpairs_pallas (acc, phi) in both instantiations against the
    float64 plain version; the last source tile is cut, not padded."""
    from nbody_torch.forces.pallas_pp import allpairs_pallas, pp_block_plain

    pos, mass = _particles(n, 100.0, cuda, seed=n)
    pos, mass = pos.to(dtype), mass.to(dtype)
    before = allpairs_pallas.launches
    acc, phi = allpairs_pallas(pos, mass, 0.3, 2.0, box=box)
    torch.cuda.synchronize()
    assert allpairs_pallas.launches == before + 1
    assert acc.dtype == phi.dtype == dtype and acc.shape == (n, 3)
    raw, pot = pp_block_plain(pos.double(), pos.double(), mass.double(), 0.3,
                              box)
    ref_phi = -2.0 * (pot - mass.double() / 0.3)
    tol = K1_REL_L2_TOL if dtype == torch.float32 else 1e-12
    assert float((acc.double() - 2.0 * raw).norm() / (2.0 * raw).norm()) <= tol
    assert float((phi.double() - ref_phi).norm() / ref_phi.norm()) <= tol


def test_k7_block_acc_matches_plain(cuda):
    from nbody_torch.forces.pallas_pp import block_acc_pallas, pp_block_plain

    ti, _ = _particles(300, 10.0, cuda, seed=1)
    tj, mj = _particles(1000, 10.0, cuda, seed=2)
    before = block_acc_pallas.launches
    acc, pot = block_acc_pallas(ti, tj, mj, 0.1)
    torch.cuda.synchronize()
    assert block_acc_pallas.launches == before + 1
    ref = pp_block_plain(ti.double(), tj.double(), mj.double(), 0.1)
    for got, want in zip((acc, pot), ref):
        assert float((got.double() - want).norm() / want.norm()) <= K1_REL_L2_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("box", [0.0, 30.0])
@pytest.mark.parametrize("ni,nj", [(3001, 5000), (700, 1), (2, 200),
                                   (65, 70001)])
def test_k7_sliced_launch_matches_plain(cuda, dtype, box, ni, nj):
    """K7 where its launch cuts the sources into slices: 3,001 targets (not
    a multiple of a block's R x 128), one source, fewer source tiles than
    the card's slots want, and 70,001 sources (not a multiple of S x 128),
    with and without a box, against the float64 plain version; a second
    launch on the same inputs gives the same bits."""
    from nbody_torch.forces.pallas_pp import (
        block_acc_pallas,
        card_geometry,
        pp_block_plain,
    )

    ti, _ = _particles(ni, 100.0, cuda, seed=ni)
    tj, mj = _particles(nj, 100.0, cuda, seed=nj + 1)
    ti, tj, mj = ti.to(dtype), tj.to(dtype), mj.to(dtype)
    geo = card_geometry(ti, tj, box)
    tiles = -(-nj // geo.threads)
    assert 1 <= geo.slices <= tiles and (geo.slices > 1) == (tiles > 1)
    first = block_acc_pallas(ti, tj, mj, 0.3, box=box)
    second = block_acc_pallas(ti, tj, mj, 0.3, box=box)
    torch.cuda.synchronize()
    ref = pp_block_plain(ti.double(), tj.double(), mj.double(), 0.3, box)
    tol = K1_REL_L2_TOL if dtype == torch.float32 else 1e-12
    for got, again, want in zip(first, second, ref):
        assert got.dtype == dtype and torch.equal(got, again)
        assert float((got.double() - want).norm() / want.norm()) <= tol


def test_k7_wrapper_rejects(cuda):
    from nbody_torch.forces.pallas_pp import allpairs_pallas, block_acc_pallas

    pos, mass = _particles(64, 5.0, cuda)
    with pytest.raises(TypeError):
        allpairs_pallas(pos.half(), mass.half(), 0.1)
    with pytest.raises(TypeError):
        block_acc_pallas(pos, pos.double(), mass, 0.1)
    with pytest.raises(ValueError):
        allpairs_pallas(pos.T.contiguous().T, mass, 0.1)
    with pytest.raises(ValueError):
        allpairs_pallas(pos, mass[:10], 0.1)
    with pytest.raises(ValueError):
        block_acc_pallas(pos, pos, mass, 0.1, box=-1.0)


def test_newtonian_drive_on_gpu_matches_cpu(cuda):
    """run_with_diagnostics on plummer(512) through K7 against the same
    drive through the plain version on the CPU (float32 both)."""
    from nbody_torch.forces.pallas_pp import allpairs_pallas
    from nbody_torch.ic import systems
    from nbody_torch.integrate.leapfrog import run_with_diagnostics

    def acc_fn(p, m):
        return allpairs_pallas(p, m, eps=0.05)

    st = systems.plummer(512, seed=3)
    gpu = run_with_diagnostics(st, 1e-3, 40, acc_fn, diag_every=10)
    cpu = run_with_diagnostics(st.to("cpu"), 1e-3, 40, acc_fn, diag_every=10)
    assert float((gpu[0].pos.cpu() - cpu[0].pos).abs().max()) < 1e-5
    eg = (gpu[2].e_kin + gpu[2].e_pot).cpu()
    ec = cpu[2].e_kin + cpu[2].e_pot
    assert float((eg - ec).abs().max() / ec.abs().max()) < 1e-5


def test_tiny_pp_run_on_gpu_matches_cpu(cuda, tmp_path):
    """The Ewald PP solver through run_simulation: K1 launched once per
    evaluation, the same run on the CPU (float32 both)."""
    cfg = SimulationConfig(n_side=8, box=200.0, solver="pp", pm_grid=16,
                           n_steps=4, output=OutputConfig(snapshot=False,
                                                          powerspec_bins=8))
    before = p3m_short_acc.launches
    gpu = run_simulation(cfg, 0, str(tmp_path / "gpu"), device=cuda)
    assert p3m_short_acc.launches == before + cfg.n_steps + 1
    cpu = run_simulation(cfg, 0, str(tmp_path / "cpu"), device="cpu")
    d = gpu.state.pos.cpu().double() - cpu.state.pos.double()
    d -= cfg.box * torch.round(d / cfg.box)
    assert float(d.abs().max()) < 1e-4 * cfg.box


def test_adaptive_kepler_on_gpu_matches_cpu(cuda):
    """run_adaptive on the e = 0.7 Kepler orbit through the float64 K7
    against the same run through the plain version on the CPU."""
    from nbody_torch.core import units
    from nbody_torch.forces.pallas_pp import allpairs_pallas
    from nbody_torch.ic import systems
    from nbody_torch.integrate.adaptive import run_adaptive

    def acc_fn(p, m):
        return allpairs_pallas(p, m, 1e-4, units.SOLAR.G)

    st = systems.two_body(e=0.7)
    gpu = run_adaptive(st, 1.0, acc_fn, eps=1e-2, eta=0.05)
    cpu = run_adaptive(st.to("cpu"), 1.0, acc_fn, eps=1e-2, eta=0.05)
    assert int(gpu.n_steps) == int(cpu.n_steps) > 100
    assert float(gpu.state.time) == 1.0
    assert float((gpu.state.pos.cpu() - cpu.state.pos).abs().max()) < 1e-9


# K8 against the float64 plain version: the JAX package's float32
# envelope for this kernel (tests/test_forces.py), per-particle relative
# force error, and E_pot to 1e-5 (see chip_smoke.py)
K8_MEDIAN_TOL, K8_MAX_TOL, K8_EPOT_TOL = 1e-4, 1e-2, 1e-5


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("n", [1500, 32768])
def test_k8_matches_plain(cuda, n, sort):
    """allpairs_pallas_mxu uniform in a 500 box (eps 0.5, unit masses)
    against its float64 plain version; N = 1,500 is ragged against the
    tiles."""
    from nbody_torch.forces.pallas_mxu import (
        allpairs_pallas_mxu,
        gram_allpairs_plain,
    )

    rng = np.random.default_rng(n)
    pos = torch.tensor(rng.uniform(0, 500.0, (n, 3)), dtype=torch.float32,
                       device=cuda)
    mass = torch.ones(n, device=cuda)
    before = allpairs_pallas_mxu.launches
    acc, phi = allpairs_pallas_mxu(pos, mass, 0.5, sort=sort)
    torch.cuda.synchronize()
    assert allpairs_pallas_mxu.launches == before + 1
    assert acc.dtype == phi.dtype == torch.float32 and acc.shape == (n, 3)
    ref, ref_phi = gram_allpairs_plain(pos.double(), mass.double(), 0.5,
                                       sort=sort)
    err = (acc.double() - ref).norm(dim=1) / ref.norm(dim=1)
    assert float(err.median()) < K8_MEDIAN_TOL
    assert float(err.max()) < K8_MAX_TOL
    e_pot, e_ref = float(torch.sum(phi.double())), float(torch.sum(ref_phi))
    assert abs(e_pot / e_ref - 1.0) <= K8_EPOT_TOL


@pytest.mark.parametrize("n", [1000, 70001])
def test_k8_ragged_and_close_pairs(cuda, n):
    """allpairs_pallas_mxu at an N that is not a multiple of 128, with
    close pairs planted across the edges of the 128-source tiles (each
    pair's two particles a few ulp apart: a pair far closer together than
    to its tile centre, which must be taken from its separation), against
    the float64 oracle; two launches equal bit for bit."""
    from nbody_torch.forces.allpairs import direct_acc_chunked
    from nbody_torch.forces.pallas_mxu import (
        _sorted_tiles,
        allpairs_pallas_mxu,
        morton_codes,
    )

    rng = np.random.default_rng(n)
    pos = torch.tensor(rng.uniform(0, 500.0, (n, 3)), dtype=torch.float32,
                       device=cuda)
    mass = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                        device=cuda)
    # the sorted order's tile edges: each pair's second particle put next
    # to the first, so that the sort keeps them on both sides of an edge
    order = torch.argsort(morton_codes(pos), stable=True)
    for e in range(128, n - 1, 128 * 7):
        a, b = order[e - 1], order[e]
        pos[b] = pos[a] + torch.tensor([1e-3, -2e-3, 5e-4], device=cuda)
    eps = 1e-3
    acc, phi = allpairs_pallas_mxu(pos, mass, eps)
    again = allpairs_pallas_mxu(pos, mass, eps)
    torch.cuda.synchronize()
    assert torch.equal(acc, again[0]) and torch.equal(phi, again[1])
    perm, pos_s, _, _ = _sorted_tiles(pos, mass, 256, 1024, True, 6)
    assert pos_s.shape[0] % 1024 == 0 and n % 128
    ref = direct_acc_chunked(pos.double(), mass.double(), eps)[0]
    err = (acc.double() - ref).norm(dim=1) / ref.norm(dim=1)
    assert float(err.median()) < K8_MEDIAN_TOL
    assert float(err.max()) < K8_MAX_TOL


def test_k8_wrapper_rejects(cuda):
    from nbody_torch.forces.pallas_mxu import allpairs_pallas_mxu

    pos, mass = _particles(256, 5.0, cuda)
    before = allpairs_pallas_mxu.launches
    with pytest.raises(TypeError):
        allpairs_pallas_mxu(pos.double(), mass.double(), 0.1)
    with pytest.raises(ValueError):
        allpairs_pallas_mxu(pos, mass, 0.0)
    with pytest.raises(ValueError):
        allpairs_pallas_mxu(pos.T.contiguous().T, mass, 0.1)
    with pytest.raises(ValueError):
        allpairs_pallas_mxu(pos, mass, 0.1, ti=192)
    assert allpairs_pallas_mxu.launches == before
    for _ in range(3):
        allpairs_pallas_mxu(pos, mass, 0.1)
    assert allpairs_pallas_mxu.launches == before + 3


# ---------------------------------------------------------------------------
# the slab sites of K2, K3, K4 and K6: four shards on the card
# ---------------------------------------------------------------------------


def _domain_case(cuda, D=4, n=20000, box=500.0, nmesh=64, seed=6):
    """Clustered particles decomposed into D shards on the card, and the
    domain geometry (cells tier ncell 8, supercell grid 8 = S 8)."""
    from nbody_torch.core.types import ParticleState
    from nbody_torch.distributed import domain as td
    from nbody_torch.distributed.sharding import device_mesh

    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 3), generator=g, dtype=torch.float64) * box
    pos[: n // 4] = torch.remainder(
        pos[: n // 4] * 0.2 + torch.tensor([100.0, 250.0, 490.0]), box)
    st = ParticleState.create(pos, torch.zeros_like(pos),
                              torch.ones(n, dtype=torch.float64), 0.5,
                              device=cuda, dtype=torch.float32)
    group = device_mesh(D)
    geom = td.domain_p3m_geometry(box, nmesh, D, n)
    shards = td.domain_decompose(st, group, box, geom.ncell)
    return group, geom, shards


def _slab_column_planes(cuda, ncell, ck=4096, w=4096):
    from nbody_torch.distributed import domain as td

    group, geom, shards = _domain_case(cuda)
    D = group.size
    built = td.build_local_column_plane(
        [s.pos for s in shards], [s.mass for s in shards], box=geom.box,
        r_cut=geom.r_cut, ncell=ncell, group=group, col_capacity=ck,
        window=w)
    from nbody_torch.forces.p3m_columns import plane_geometry

    CK, gz, stride, W, maxch, chunk = plane_geometry(geom.box, geom.r_cut,
                                                     ck, w)
    kw = dict(ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
              chunk=chunk, eps=0.5, r_s=geom.r_s, r_cut=geom.r_cut,
              split="spline", softening="spline", nx=ncell // D)
    for b in built:
        assert int(b[3]) == 0 and int(b[4]) == 0
    return group, geom, built, kw


def test_k4_slab_matches_plain(cuda):
    from nbody_torch.forces.p3m_columns import column_plane_plain, run_column_plane

    group, geom, built, kw = _slab_column_planes(cuda, 8)
    before = run_column_plane.launches
    for plane, ws, nch, *_ in built:
        got = run_column_plane(plane, ws, nch, box=geom.box, **kw)
        torch.cuda.synchronize()
        ref = column_plane_plain(plane.double(), ws, nch, **kw)
        assert float(ref.norm()) > 0
        assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL
    assert run_column_plane.launches == before + group.size


def _slab_supercell(cuda):
    """The supercell tier's slab planes (box coordinates)."""
    group, geom, built, kw = _slab_column_planes(cuda, 8)
    return group, geom, built, [b[0] for b in built], kw


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_k2_slab_matches_plain(cuda, shift):
    from nbody_torch.forces.pm_supercell import (
        deposit_node_masses_plain,
        fold_slab_node_masses,
        slab_halo_fold,
        supercell_deposit_from_plane,
        supercell_geometry,
    )

    group, geom, built, planes, kw = _slab_supercell(cuda)
    nmesh, nx = geom.nmesh, kw["nx"]
    S, ZP = supercell_geometry(nmesh, 8)
    dkw = dict(box=geom.box, nmesh=nmesh, ncell=8, stride=kw["stride"],
               gz=kw["gz"], chunk=kw["chunk"], shift=shift, nx=nx)
    before = supercell_deposit_from_plane.launches
    got, ref = [], []
    for d, (b, p) in enumerate(zip(built, planes)):
        got.append(supercell_deposit_from_plane(p, b[6], row0=d * nx, **dkw))
        nodes = deposit_node_masses_plain(
            p, b[6], ncell=8, S=S, ZP=ZP, stride=kw["stride"], gz=kw["gz"],
            scale=nmesh / geom.box, shift=shift, nx=nx, row0=d * nx)
        ref.append(fold_slab_node_masses(nodes, nx=nx, ncell=8, S=S, ZP=ZP,
                                         nmesh=nmesh))
    torch.cuda.synchronize()
    assert supercell_deposit_from_plane.launches == before + group.size
    assert got[0].shape == (nx * S + 3, nmesh, nmesh)
    g = torch.cat(slab_halo_fold(got, group))
    r = torch.cat(slab_halo_fold(ref, group))
    # the plain version's float32 sums against the kernel's exact sums
    # rounded once, see chip_smoke.py
    assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
    assert abs(float(g.sum()) - 20000.0) < 1e-2


@pytest.mark.parametrize("interlaced,split_out", [(False, True), (True, True),
                                                  (False, False)])
def test_k3_slab_matches_plain(cuda, interlaced, split_out):
    from nbody_torch.forces.pm_supercell import (
        extract_local_subgrids,
        fused_column_plane_plain,
        run_fused_column_plane,
    )

    group, geom, built, planes, kw = _slab_supercell(cuda)
    nmesh = geom.nmesh
    g = torch.Generator().manual_seed(3)
    grids = torch.randn((6 if interlaced else 3,) + (nmesh,) * 3, generator=g)
    halo = extract_local_subgrids(
        list(torch.chunk(grids.to(cuda), group.size, dim=1)), group)
    kw = dict(kw, S=8, scale=nmesh / geom.box, interlaced=interlaced,
              split_out=split_out)
    before = run_fused_column_plane.launches
    for d, (b, p, h) in enumerate(zip(built, planes, halo)):
        row0 = d * kw["nx"]
        got = run_fused_column_plane(p, b[1], b[2], h, row0=row0, **kw)
        torch.cuda.synchronize()
        ref = fused_column_plane_plain(p.double(), b[1], b[2], h.double(),
                                       row0=row0, **kw)
        assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL
    assert run_fused_column_plane.launches == before + group.size


def test_k6_slab_matches_plain(cuda):
    from nbody_torch.distributed import domain as td
    from nbody_torch.forces.p3m import cell_plane_plain, run_cell_plane

    group, geom, shards = _domain_case(cuda)
    kw = dict(nx=geom.ncell // group.size, ncell=geom.ncell, eps2=0.25,
              r_s=geom.r_s, r_cut=geom.r_cut, split="spline",
              softening="spline")
    before = run_cell_plane.launches
    for plane, ov, K, _, counts in td.build_local_plane(
            [s.pos for s in shards], [s.mass for s in shards],
            box=geom.box, r_cut=geom.r_cut, ncell=geom.ncell, group=group,
            capacity=8192):
        assert int(ov) == 0
        got = run_cell_plane(plane, counts, K=K, **kw)
        torch.cuda.synchronize()
        ref = cell_plane_plain(plane.double(), counts, K=K, **kw)
        assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL
    assert run_cell_plane.launches == before + group.size


@pytest.mark.parametrize("shortrange", ["cells", "supercell", "columns"])
def test_tiny_domain_run_on_gpu_matches_cpu(cuda, tmp_path, shortrange):
    """A short 16^3 run on four shards on the card against the same run
    on the CPU, with every slab site's launches = 4 x the evaluations."""
    from nbody_torch.forces.p3m import run_cell_plane
    from nbody_torch.forces.p3m_columns import run_column_plane
    from nbody_torch.forces.pm_supercell import (
        run_fused_column_plane,
        supercell_deposit_from_plane,
    )

    cfg = SimulationConfig(n_side=16, devices=4, n_steps=6, a_begin=0.3,
                           shortrange=shortrange,
                           output=OutputConfig(snapshot=False))
    fns = {"cells": [run_cell_plane], "columns": [run_column_plane],
           "supercell": [supercell_deposit_from_plane,
                         run_fused_column_plane]}[shortrange]
    before = [f.launches for f in fns]
    gpu = run_simulation(cfg, 0, str(tmp_path / "gpu"))
    evals = int((tmp_path / "gpu" / "run.log").read_text().split(
        "Domain force evaluations: ")[1].split()[0])
    assert [f.launches - b for f, b in zip(fns, before)] == [4 * evals] * len(fns)
    cpu = run_simulation(cfg, 0, str(tmp_path / "cpu"), device="cpu")
    assert bool(torch.isfinite(gpu.state.pos).all())
    pg, pc = (np.loadtxt(r.powerspecs[-1]) for r in (gpu, cpu))
    m = pc[:, 0] <= 0.5 * np.pi * cfg.mesh_size / cfg.box
    assert np.array_equal(pg[:, 1], pc[:, 1])
    assert np.abs(pg[m, 2] / pc[m, 2] - 1.0).max() < 1e-3


# ---------------------------------------------------------------------------
# the rung tier's slab sites: K5 on frozen local plans, K6's two-plane form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frac", [0.0, 0.99])
def test_k5_slab_matches_plain(cuda, frac):
    """K5 on every shard's frozen local plane (nx = ncell / D) at
    positions drifted by frac * skin/2, the targets a random tenth."""
    from nbody_torch.forces.p3m_columns import (
        _frozen_buf,
        _local_plane_from_buf,
        active_chunk_table,
        column_plane_plain,
        freeze_local_column_plan,
        plane_geometry,
        run_column_plane_masked,
    )

    group, geom, shards = _domain_case(cuda)
    D, box, ncell, skin = group.size, geom.box, geom.ncell, 8.0
    # the clump's ghost demand at the skin-widened margin spills 4,096
    ck = w = 8192
    plans = freeze_local_column_plan(
        [s.pos for s in shards], [s.mass for s in shards], box=box,
        r_cut=geom.r_cut, ncell=ncell, group=group, col_capacity=ck,
        window=w, skin=skin)
    assert all(int(pl.ov) == 0 for pl in plans)
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, geom.r_cut, ck, w)
    g = torch.Generator().manual_seed(8)
    moved, act = [], []
    for s in shards:
        u = torch.randn(tuple(s.pos.shape), generator=g, dtype=torch.float64)
        u = (u / u.norm(dim=1, keepdim=True)).to(s.pos)
        moved.append(s.pos + frac * 0.5 * skin * u)
        act.append((torch.rand(s.mass.shape[0], generator=g) < 0.1).to(cuda)
                   & (s.mass > 0))
    frozen = [_frozen_buf(p, s.mass, pl, box, geom.r_cut, CK, gz, stride)
              for p, s, pl in zip(moved, shards, plans)]
    planes = _local_plane_from_buf([b for b, _, _ in frozen], box=box,
                                   r_cut=geom.r_cut, ncell=ncell, group=group,
                                   stride=stride)
    drifts = group.pmax([dr for _, _, dr in frozen])
    kw = dict(ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
              chunk=chunk, eps=0.5, r_s=geom.r_s, r_cut=geom.r_cut,
              split="spline", softening="spline", nx=ncell // D)
    before = run_column_plane_masked.launches
    for (plane, _), pl, a, (_, interior, _), drift in zip(planes, plans, act,
                                                           frozen, drifts):
        nch_act, cht = active_chunk_table(a, pl, interior, ncell=ncell,
                                          CK=CK, gz=gz, maxch=maxch,
                                          chunk=chunk, nx=ncell // D)
        got = run_column_plane_masked(plane, pl.ws, nch_act, cht, box=box,
                                      drift=drift, **kw)
        torch.cuda.synchronize()
        ref = column_plane_plain(plane.double(), pl.ws, nch_act, cht=cht,
                                 **kw)
        assert float(ref.norm()) > 0
        assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL
    assert run_column_plane_masked.launches == before + D


def test_k6_masked_slab_matches_plain(cuda):
    """K6's two-plane form on every shard's slab: a plane of a random
    fifth of the particles against the slab's cell plane (nx = ncell /
    D)."""
    from nbody_torch.distributed import domain as td
    from nbody_torch.forces.p3m import cell_plane_plain, run_cell_plane

    group, geom, shards = _domain_case(cuda)
    g = torch.Generator().manual_seed(9)
    act = [(torch.rand(s.mass.shape[0], generator=g) < 0.2).to(cuda)
           & (s.mass > 0) for s in shards]
    pos, mass = [s.pos for s in shards], [s.mass for s in shards]
    pkw = dict(box=geom.box, r_cut=geom.r_cut, ncell=geom.ncell, group=group)
    src = td.build_local_plane(pos, mass, capacity=8192, **pkw)
    tgt = td.build_local_plane(pos, mass, capacity=2048, valid=act, **pkw)
    kw = dict(nx=geom.ncell // group.size, ncell=geom.ncell, eps2=0.25,
              r_s=geom.r_s, r_cut=geom.r_cut, split="spline",
              softening="spline")
    before = run_cell_plane.launches
    for (pj, ovj, K_j, _, cj), (pi, ovi, K_i, _, ci) in zip(src, tgt):
        assert int(ovj) == 0 and int(ovi) == 0
        got = run_cell_plane(pi, ci, K=K_i, plane_j=pj, K_j=K_j, counts_j=cj,
                             **kw)
        torch.cuda.synchronize()
        ref = cell_plane_plain(pi.double(), ci, K=K_i, plane_j=pj.double(),
                               K_j=K_j, counts_j=cj, **kw)
        assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL
    assert run_cell_plane.launches == before + group.size


@pytest.mark.parametrize("skin", [-1.0, 0.0])
def test_tiny_domain_rung_run_on_gpu_matches_cpu(cuda, tmp_path, skin):
    """The 16^3 rung run (a = 0.3 to 1 in 6 steps) on four shards on the
    card, on frozen local plans (auto skin) or the masked cell planes
    (skin 0), against the same run on the CPU: K5's launches = 4 x the
    frozen-plan interior evaluations of run.log, K6's = 4 x its boundary
    and masked interior evaluations."""
    import re

    from nbody_torch.forces.p3m import run_cell_plane
    from nbody_torch.forces.p3m_columns import run_column_plane_masked

    cfg = SimulationConfig(n_side=16, devices=4, rungs=3, n_steps=6,
                           a_begin=0.3, column_skin=skin,
                           output=OutputConfig(snapshot=False))
    before = (run_column_plane_masked.launches, run_cell_plane.launches)
    gpu = run_simulation(cfg, 0, str(tmp_path / "gpu"))
    log = (tmp_path / "gpu" / "run.log").read_text()
    B, F, M = (int(x) for x in re.search(
        r"Domain rung stepping: (\d+) boundary, (\d+) frozen-plan interior "
        r"and (\d+) masked interior", log).groups())
    assert (F > 0) == (skin < 0) and (M > 0) == (skin == 0)
    assert (run_column_plane_masked.launches - before[0],
            run_cell_plane.launches - before[1]) == (4 * F, 4 * (B + M))
    cpu = run_simulation(cfg, 0, str(tmp_path / "cpu"), device="cpu")
    assert bool(torch.isfinite(gpu.state.pos).all())
    pg, pc = (np.loadtxt(r.powerspecs[-1]) for r in (gpu, cpu))
    m = pc[:, 0] <= 0.5 * np.pi * cfg.mesh_size / cfg.box
    assert np.array_equal(pg[:, 1], pc[:, 1])
    assert np.abs(pg[m, 2] / pc[m, 2] - 1.0).max() < 1e-3


def test_ring_site_matches_plain(cuda):
    """make_ring_acc_fn on four shards of the card (K7's ring site, 16
    launches) against the same ring on the CPU (the plain version,
    float64)."""
    from nbody_torch.distributed.sharding import device_mesh, make_ring_acc_fn
    from nbody_torch.forces.pallas_pp import block_acc_pallas
    from nbody_torch.ic import systems

    st = systems.plummer(2048, seed=4)
    before = block_acc_pallas.launches
    acc, phi = make_ring_acc_fn(device_mesh(4, cuda), eps=0.05)(st.pos,
                                                                st.mass)
    torch.cuda.synchronize()
    assert block_acc_pallas.launches == before + 16
    ref = make_ring_acc_fn(device_mesh(4, "cpu"), eps=0.05)(
        st.pos.cpu().double(), st.mass.cpu().double())
    for got, want in zip((acc, phi), ref):
        assert float((got.cpu().double() - want).norm() / want.norm()) \
            <= K1_REL_L2_TOL


def test_replicated_grid_site_matches_plain(cuda):
    """make_sharded_p3m_cosmo_force on four shards of the card (K6's
    replicated-grid site, 4 launches) against the same force on the CPU
    (the plain version), float32 both, 2e-5 of max |g|; the planted
    capacity 8 reports dropped particles on both."""
    from nbody_torch.core.cosmology import Cosmology
    from nbody_torch.distributed.sharding import (
        device_mesh,
        make_sharded_p3m_cosmo_force,
    )
    from nbody_torch.forces.p3m import run_cell_plane

    box, nmesh = 80.0, 48
    pos, mass = _particles(2048, box, cuda, seed=5)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        for cap in (None, 8):
            fn = make_sharded_p3m_cosmo_force(
                Cosmology(), box, nmesh, device_mesh(4, dev), eps=0.1,
                capacity=cap, checked=True)
            before = run_cell_plane.launches
            out[dev.type, cap] = fn(pos.to(dev), mass.to(dev), 0.5)
            assert run_cell_plane.launches == before + (
                4 if dev.type == "cuda" else 0)
    g, ov = out["cuda", None]
    ref, ov_ref = out["cpu", None]
    assert int(ov) == int(ov_ref) == 0
    scale = float(ref.norm(dim=1).max())
    assert float((g.cpu() - ref).norm(dim=1).max()) <= 2e-5 * scale
    assert int(out["cuda", 8][1]) == int(out["cpu", 8][1]) > 0


@pytest.mark.parametrize("n,nmesh", [(32768, 64), (1 << 18, 128)])
def test_cic_deposit_deterministic(cuda, n, nmesh):
    """The fixed-point CIC deposit on the card: two calls equal bit for bit,
    and the float32 grid equal to the float64 deposit of the same
    positions to float32 rounding (the cell coordinate x nmesh / box
    rounds by up to 7.6e-6 at mesh 128, and each corner weight carries
    it)."""
    from nbody_torch.mesh.cic import cic_deposit

    box = 500.0
    pos, mass = _particles(n, box, cuda, seed=3)
    a = cic_deposit(pos, box, nmesh, weights=mass)
    b = cic_deposit(pos, box, nmesh, weights=mass)
    assert torch.equal(a, b)
    ref = cic_deposit(pos.double().cpu(), box, nmesh,
                      weights=mass.double().cpu())
    err = (a.double().cpu() - ref).abs().max() / ref.abs().max()
    assert float(err) <= 3e-5


def test_adaptive_run_on_gpu_matches_cpu(cuda, tmp_path):
    """A tiny adaptive rung run on the card against the same run on the
    CPU: the same step count, and the final time a_end itself."""
    cfg = SimulationConfig(n_side=12, box=60.0, pm_grid=32, a_begin=0.2,
                           a_end=0.3, rungs=3, time_stepping="adaptive",
                           output=OutputConfig(snapshot=False,
                                               powerspec=False,
                                               energy_log=False))
    gpu = run_simulation(cfg, 0, str(tmp_path / "gpu"))
    cpu = run_simulation(cfg, 0, str(tmp_path / "cpu"), device="cpu")
    assert float(gpu.state.time) == float(cpu.state.time) == float(
        np.float32(0.3))

    def total(run):
        with open(tmp_path / run / "run.log") as f:
            return [x for x in f if x.startswith("Total adaptive steps")]

    assert total("gpu") == total("cpu") and total("gpu")
    d = (gpu.state.pos.cpu() - cpu.state.pos).abs()
    assert float(torch.minimum(d, 60.0 - d).max()) < 1e-3


@pytest.mark.parametrize("site", ["box", "slab"])
def test_k2_twice_bit_for_bit(cuda, site):
    """K2's integer fixed-point sums: two launches on the same plane give
    the same node masses bit for bit, on the whole box and on every shard's
    slab plane."""
    from nbody_torch.forces.pm_supercell import supercell_deposit_from_plane

    if site == "box":
        plane, _, _, counts, kw, _, box, nmesh = _column_case(cuda)
        calls = [dict(plane=plane, counts=counts, box=box, nmesh=nmesh,
                      ncell=kw["ncell"], stride=kw["stride"], gz=kw["gz"])]
    else:
        group, geom, built, planes, kw = _slab_supercell(cuda)
        calls = [dict(plane=p, counts=b[6], box=geom.box, nmesh=geom.nmesh,
                      ncell=8, stride=kw["stride"], gz=kw["gz"],
                      nx=kw["nx"], row0=d * kw["nx"])
                 for d, (b, p) in enumerate(zip(built, planes))]
    for c in calls:
        plane, counts = c["plane"], c["counts"]
        kw2 = {k: v for k, v in c.items() if k not in ("plane", "counts")}
        for shift in (0.0, 0.5):
            a = supercell_deposit_from_plane(plane, counts, shift=shift, **kw2)
            b = supercell_deposit_from_plane(plane, counts, shift=shift, **kw2)
            assert torch.equal(a, b)
            assert float(a.abs().max()) > 0


@pytest.mark.parametrize("split,softening", [("spline", "spline"),
                                             ("gaussian", "plummer")])
@pytest.mark.parametrize("r_frac", [0.088, 0.4999])
def test_k1_batched_equals_single_launches(cuda, split, softening, r_frac):
    """K1's batched site: one launch over B members, each member's
    acceleration equal bit for bit to its own single-member launch, and
    against the float64 plain version."""
    box = 100.0
    r_cut = r_frac * box
    B, n = 3, 3001
    sets = [_particles(n, box, cuda, seed=s) for s in range(B)]
    pos = torch.stack([p for p, _ in sets]).contiguous()
    mass = torch.stack([m for _, m in sets]).contiguous()
    before = p3m_short_acc.launches
    got = p3m_short_acc(pos, mass, box, 0.3, r_cut / 4.5, r_cut, G=2.0,
                        split=split, softening=softening)
    torch.cuda.synchronize()
    assert p3m_short_acc.launches == before + 1
    assert got.shape == (B, n, 3)
    for b in range(B):
        one = p3m_short_acc(pos[b], mass[b], box, 0.3, r_cut / 4.5, r_cut,
                            G=2.0, split=split, softening=softening)
        assert torch.equal(got[b], one)
    ref = p3m_short_plain(pos.double(), mass.double(), box, 0.3, r_cut / 4.5,
                          r_cut, G=2.0, split=split, softening=softening)
    assert float((got.double() - ref).norm() / ref.norm()) <= K1_REL_L2_TOL


def test_batched_members_on_gpu_match_cpu(cuda):
    """run_members_batched on the card (K1's batched site, the batched PM)
    against the same members on the CPU."""
    from nbody_torch.driver.ensemble import draw_A_s, run_members_batched

    cfg = SimulationConfig(n_side=8, pm_grid=16, n_steps=4,
                           output=OutputConfig(snapshot=False))
    before = p3m_short_acc.launches
    gpu = run_members_batched(cfg, [1, 2], draw_A_s(2))
    assert p3m_short_acc.launches == before + cfg.n_steps + 1
    cpu = run_members_batched(cfg, [1, 2], draw_A_s(2), device="cpu")
    d = (gpu.pos.cpu() - cpu.pos).abs()
    assert float(torch.minimum(d, cfg.box - d).max()) < 1e-3


def test_profiling_on_cuda(cuda, tmp_path):
    """benchmark_fn waits for the card (its median exceeds the enqueue of
    a long kernel run), and trace writes a Chrome trace that names the
    kernel it saw."""
    import json

    from nbody_torch.diagnostics.profiling import benchmark_fn, trace

    pos, mass = _particles(32768, 500.0, cuda)
    args = (pos, mass, 500.0, 0.5, 9.0, 40.5)
    t = benchmark_fn(p3m_short_acc, *args, reps=3)
    assert t > 0
    with trace(str(tmp_path)) as prof:
        p3m_short_acc(*args)
    names = {e.key for e in prof.key_averages()}
    assert any("k1_pairs" in k for k in names)
    with open(tmp_path / "trace.json") as f:
        assert "k1_pairs" in f.read()
    json.loads(open(tmp_path / "trace.json").read())


@pytest.mark.parametrize("n", [32, 64, 128])
def test_rfft3_bits_do_not_depend_on_the_batch(cuda, n):
    """The PM transforms' batch axis: each grid of a batch of 2, 4 or 8
    transforms (forward and inverse) to the bits of the same grid alone,
    which a batched member's run relies on to equal its own run."""
    from nbody_torch.mesh.grids import irfft3, rfft3

    g = torch.Generator(device=cuda).manual_seed(n)
    for B in (2, 4, 8):
        x = torch.randn(B, n, n, n, device=cuda, generator=g)
        k = rfft3(x)
        r = irfft3(k, n)
        for b in range(B):
            assert torch.equal(k[b], rfft3(x[b]))
            assert torch.equal(r[b], irfft3(k[b], n))


def _lattice_state(cuda, side=16, box=100.0, nmesh=32, seed=8):
    """side^3 particles a little off the nmesh^3 mesh's nodes (the
    Zel'dovich ICs' layout, where the small CIC corner weights round),
    float32 on the card, unit masses."""
    rng = np.random.default_rng(seed)
    q = (np.indices((side,) * 3).reshape(3, -1).T + 0.5) * (box / side)
    q = q + rng.normal(0.0, 1e-3 * box / nmesh, q.shape)
    pos = torch.tensor(q, dtype=torch.float32, device=cuda)
    return pos, torch.ones(pos.shape[0], device=cuda)


def _capacity_planes(pos, mass, box, nmesh):
    """The supercell geometry's column planes of one state at the auto
    capacity and at twice it (each with its auto window): a list of
    (built, kernel keywords)."""
    from nbody_torch.forces.p3m_columns import (
        build_column_plane,
        column_window,
        plane_geometry,
    )
    from nbody_torch.forces.pm_supercell import supercell_params

    n = pos.shape[0]
    r_s, r_cut, ncell, ck, w = supercell_params(box, nmesh, n)
    out = []
    for cap, win in ((ck, w), (2 * ck, column_window(box, r_cut, 2 * ck))):
        CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut, cap, win)
        built = build_column_plane(pos, mass, box, r_cut, ncell, CK, W,
                                   chunk=chunk)
        assert int(built[3]) == int(built[4]) == 0
        out.append((built, dict(ncell=ncell, stride=stride, W=W, maxch=maxch,
                                gz=gz, chunk=chunk, eps=0.1, r_s=r_s,
                                r_cut=r_cut, split="spline",
                                softening="spline")))
    return out


@pytest.mark.parametrize("site", ["K2", "K3", "K4", "K5"])
def test_column_sites_do_not_depend_on_the_capacity(cuda, site):
    """A state's planes at a column capacity CK and at 2 CK (other ghost
    bands, windows, chunks and window starts): K2's mass grid, and K3's,
    K4's and K5's per-particle sums, are equal bit for bit.  K2 scaled its
    fixed point by the plane's slot count (nx * ncell * CK) before, which
    parted two runs of one config started from other capacities."""
    from nbody_torch.forces.p3m_columns import (
        active_chunk_table,
        freeze_column_plan,
        frozen_plane,
        read_back,
        run_column_plane,
        run_column_plane_masked,
    )
    from nbody_torch.forces.pm_supercell import (
        run_fused_column_plane,
        supercell_deposit_from_plane,
        supercell_geometry,
    )

    box, nmesh = 100.0, 32
    pos, mass = _lattice_state(cuda, box=box, nmesh=nmesh)
    planes = _capacity_planes(pos, mass, box, nmesh)
    got = []
    g = torch.Generator().manual_seed(3)
    grids = torch.randn((3,) + (nmesh,) * 3, generator=g).to(cuda)
    act = (torch.rand(pos.shape[0], generator=g) < 0.1).to(cuda)
    for built, kw in planes:
        plane, ws, nch, gidx, counts = (built[i] for i in (0, 1, 2, 5, 6))
        if site == "K2":
            got.append(supercell_deposit_from_plane(
                plane, counts, box=box, nmesh=nmesh, ncell=kw["ncell"],
                stride=kw["stride"], gz=kw["gz"], chunk=kw["chunk"]))
        elif site == "K3":
            S = supercell_geometry(nmesh, kw["ncell"])[0]
            out = run_fused_column_plane(plane, ws, nch, grids, S=S,
                                         scale=nmesh / box, **kw)
            got.append(read_back(out, gidx, 3))
        elif site == "K4":
            out = run_column_plane(plane, ws, nch, box=box, **kw)
            got.append(read_back(out, gidx, 3))
        else:
            CK = kw["stride"] - 2 * kw["gz"]
            plan = freeze_column_plan(pos, mass, box, kw["r_cut"],
                                      kw["ncell"], CK, kw["W"], skin=3.0)
            fplane, interior, drift = frozen_plane(
                pos, mass, plan, box, kw["r_cut"], kw["ncell"], CK,
                kw["gz"], kw["stride"])
            nch_act, cht = active_chunk_table(
                act, plan, interior, ncell=kw["ncell"], CK=CK, gz=kw["gz"],
                maxch=kw["maxch"], chunk=kw["chunk"])
            out = run_column_plane_masked(fplane, plan.ws, nch_act, cht,
                                          box=box, drift=drift, **kw)
            got.append(read_back(out, plan.gidx, 3)[act])
    assert float(got[0].abs().max()) > 0
    assert torch.equal(got[0], got[1])


def _members(cuda, B=3, n=6000, box=100.0):
    """B members' uniform states, their masses at 1, 10^3 and 10^-3 times
    the first's (each member's K2 exponent its own), float32 on the
    card."""
    sets = [_particles(n, box, cuda, seed=10 + b) for b in range(B)]
    pos = torch.stack([p for p, _ in sets]).contiguous()
    scale = torch.tensor([1.0, 1e3, 1e-3][:B], device=cuda)[:, None]
    mass = (torch.stack([m for _, m in sets]) * scale).contiguous()
    return pos, mass


@pytest.mark.parametrize("site", ["K2", "K3", "K4", "K6"])
def test_batched_site_equals_single_launches(cuda, site):
    """The batched sites of the plane kernels: B members' planes (one
    build) in one launch, each member's output equal bit for bit to its
    own plane's single launch, and the batch against the float64 plain
    version (K2 to 1e-5 of the largest node, the sums to relative L2
    1e-4)."""
    from nbody_torch.forces.p3m import (
        build_padded_plane,
        cell_plane_plain,
        run_cell_plane,
    )
    from nbody_torch.forces.p3m_columns import (
        build_column_plane,
        column_plane_plain,
        plane_geometry,
        run_column_plane,
    )
    from nbody_torch.forces.pm_supercell import (
        fused_column_plane_plain,
        run_fused_column_plane,
        supercell_deposit_from_plane,
        supercell_geometry,
        supercell_params,
    )

    box, nmesh = 100.0, 32
    pos, mass = _members(cuda, box=box)
    B, n = pos.shape[:2]
    if site == "K6":
        r_cut = 0.999 * box / 4
        plane, ov, K, _, counts = build_padded_plane(pos, mass, box, r_cut,
                                                     4, 768)
        assert plane.shape[0] == B and int(ov.max()) == 0
        kw = dict(nx=4, ncell=4, K=K, eps2=0.01, r_s=r_cut / 4.5,
                  r_cut=r_cut, split="spline", softening="spline")
        fn, plain = run_cell_plane, cell_plane_plain
        args = lambda b: (plane[b], counts[b])  # noqa: E731
        batch = (plane, counts)
    else:
        r_s, r_cut, ncell, ck, w = supercell_params(box, nmesh, n)
        CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut, ck, w)
        built = build_column_plane(pos, mass, box, r_cut, ncell, CK, W,
                                   chunk=chunk)
        plane, ws, nch, counts = built[0], built[1], built[2], built[6]
        assert plane.shape[0] == B
        geo = dict(ncell=ncell, stride=stride, gz=gz, chunk=chunk)
        pair = dict(geo, W=W, maxch=maxch, eps=0.1, r_s=r_s, r_cut=r_cut,
                    split="spline", softening="spline")
        if site == "K2":
            kw = dict(geo, box=box, nmesh=nmesh)
            fn = supercell_deposit_from_plane
            args = lambda b: (plane[b], counts[b])  # noqa: E731
            batch = (plane, counts)
        elif site == "K3":
            g = torch.Generator().manual_seed(3)
            grids = torch.randn((B, 3) + (nmesh,) * 3, generator=g).to(cuda)
            kw = dict(pair, S=supercell_geometry(nmesh, ncell)[0],
                      scale=nmesh / box)
            fn, plain = run_fused_column_plane, fused_column_plane_plain
            args = lambda b: (plane[b], ws[b], nch[b], grids[b])  # noqa
            batch = (plane, ws, nch, grids)
        else:
            kw = dict(pair, box=box)
            fn, plain = run_column_plane, column_plane_plain
            args = lambda b: (plane[b], ws[b], nch[b])  # noqa: E731
            batch = (plane, ws, nch)
    before = fn.launches
    got = fn(*batch, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.shape[0] == B
    for b in range(B):
        assert torch.equal(got[b], fn(*args(b), **kw))
    if site == "K2":
        from nbody_torch.forces.pm_supercell import (
            deposit_node_masses_plain,
            fold_node_masses,
        )

        S, ZP = supercell_geometry(nmesh, ncell)
        for b in range(B):
            ref = fold_node_masses(deposit_node_masses_plain(
                plane[b].double(), counts[b], ncell=ncell, S=S, ZP=ZP,
                stride=stride, gz=gz, scale=nmesh / box),
                ncell=ncell, S=S, ZP=ZP, nmesh=nmesh)
            assert float((got[b].double() - ref).abs().max()) <= \
                1e-5 * float(ref.abs().max())
        return
    kw.pop("box", None)
    ref = plain(*(t.double() if t.is_floating_point() else t for t in batch),
                **kw)
    for b in range(B):
        assert float((got[b].double() - ref[b]).norm() / ref[b].norm()) \
            <= K1_REL_L2_TOL


def test_k2_batched_keeps_each_members_exponent(cuda):
    """Members whose masses differ by 10^6: each member's batched mass
    grid equals its single launch bit for bit (a batch-wide exponent,
    from the heaviest member, would round the light members' corner
    masses 2^20 times coarser)."""
    from nbody_torch.forces.p3m_columns import build_column_plane, plane_geometry
    from nbody_torch.forces.pm_supercell import (
        supercell_deposit_from_plane,
        supercell_params,
    )

    box, nmesh = 100.0, 32
    lat, ones = _lattice_state(cuda, box=box, nmesh=nmesh)
    pos = torch.stack([lat] * 3).contiguous()
    mass = (ones * torch.tensor([1.0, 1e3, 1e-3], device=cuda)[:, None]
            ).contiguous()
    r_s, r_cut, ncell, ck, w = supercell_params(box, nmesh, lat.shape[0])
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut, ck, w)
    built = build_column_plane(pos, mass, box, r_cut, ncell, CK, W,
                               chunk=chunk)
    kw = dict(box=box, nmesh=nmesh, ncell=ncell, stride=stride, gz=gz,
              chunk=chunk)
    rho = supercell_deposit_from_plane(built[0], built[6], **kw)
    for b in range(3):
        one = supercell_deposit_from_plane(built[0][b], built[6][b], **kw)
        assert torch.equal(rho[b], one)


def test_ewald_batched_equals_single_calls(cuda):
    """The Ewald PP force over B members: K1's Ewald site in one launch
    and each member's k-space sums, each member's force equal bit for bit
    to its own call."""
    from nbody_torch.forces.ewald import ewald_kspace_acc, ewald_pp_acc

    box = 100.0
    pos, mass = _members(cuda, n=3000, box=box)
    before = p3m_short_acc.launches
    got = ewald_pp_acc(pos, mass, box, eps=0.3)
    torch.cuda.synchronize()
    assert p3m_short_acc.launches == before + 1
    lr = ewald_kspace_acc(pos, mass, box)
    for b in range(pos.shape[0]):
        assert torch.equal(lr[b], ewald_kspace_acc(pos[b], mass[b], box))
        assert torch.equal(got[b], ewald_pp_acc(pos[b], mass[b], box,
                                                eps=0.3))


@pytest.mark.parametrize("tier", ["cells", "columns", "supercell", "pp"])
def test_batched_plane_tiers_on_gpu_match_cpu(cuda, tier):
    """run_members_batched on the plane tiers and PP on the card (one
    launch of the tier's kernel an evaluation) against the same members
    on the CPU."""
    from nbody_torch.driver.ensemble import draw_A_s, run_members_batched
    from nbody_torch.forces.p3m import run_cell_plane
    from nbody_torch.forces.p3m_columns import run_column_plane
    from nbody_torch.forces.pm_supercell import run_fused_column_plane

    kw = (dict(solver="pp") if tier == "pp"
          else dict(solver="p3m", shortrange=tier, pm_grid=32))
    cfg = SimulationConfig(n_side=8, box=200.0, n_steps=4,
                           output=OutputConfig(snapshot=False), **kw)
    fn = {"cells": run_cell_plane, "columns": run_column_plane,
          "supercell": run_fused_column_plane, "pp": p3m_short_acc}[tier]
    before = fn.launches
    gpu = run_members_batched(cfg, [1, 2], draw_A_s(2), log=lambda m: None)
    assert fn.launches == before + cfg.n_steps + 1
    cpu = run_members_batched(cfg, [1, 2], draw_A_s(2), device="cpu",
                              log=lambda m: None)
    d = (gpu.pos.cpu() - cpu.pos).abs()
    assert float(torch.minimum(d, cfg.box - d).max()) < 1e-3


# -- the emulator on the card ----------------------------------------------

EMU_F64_TOL = 1e-5  # chip_smoke.py's EMULATOR_F64_TOL


@pytest.mark.parametrize("kw", [{}, dict(heteroscedastic=True, n_out=2),
                                dict(global_pool=False, dim=16)],
                         ids=["mc", "nll", "flatten"])
def test_emulator_model_on_gpu_matches_float64(cuda, kw):
    """CosmoCNN in float32 on the card (cuDNN deterministic, no TF32)
    against the same weights in float64 on the CPU: the outputs and one
    step's gradients to 1e-5 relative L2."""
    from nbody_torch.emulator.model import (
        CosmoCNN,
        deterministic_cudnn,
        gaussian_nll,
        mse_loss,
    )

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 16, 16, 16, generator=g)
    y = 0.9 + 0.1 * torch.rand(3, kw.get("n_out", 1), generator=g)
    loss = gaussian_nll if kw.get("heteroscedastic") else mse_loss
    gpu = CosmoCNN(**kw).to(cuda)
    cpu = CosmoCNN(**kw).double()
    pg, _ = gpu(x.to(cuda))
    pc, _ = cpu(x.double())
    assert pg.dtype == torch.float32 and pc.dtype == torch.float64
    err = float((pg.cpu().double() - pc).norm() / pc.norm())
    assert err <= EMU_F64_TOL
    with deterministic_cudnn():
        loss(pg, y.to(cuda)).backward()
    loss(pc, y.double()).backward()
    gg = torch.cat([p.grad.reshape(-1).cpu().double()
                    for p in gpu.parameters()])
    gc = torch.cat([p.grad.reshape(-1) for p in cpu.parameters()])
    assert float((gg - gc).norm() / gc.norm()) <= EMU_F64_TOL


def test_emulator_augment_on_gpu_equals_cpu(cuda):
    from nbody_torch.emulator.data import augment_batch, augment_cases

    X = torch.randn(96, 8, 8, 8)
    combo = torch.arange(96)
    flips = torch.stack([(combo >> 2) & 1, (combo >> 1) & 1, combo & 1],
                        dim=1).bool()
    got = augment_cases(X.to(cuda), flips.to(cuda), (combo // 8).to(cuda))
    assert torch.equal(got.cpu(), augment_cases(X, flips, combo // 8))
    a = augment_batch(X.to(cuda), torch.Generator(cuda).manual_seed(2))
    b = augment_batch(X.to(cuda), torch.Generator(cuda).manual_seed(2))
    assert torch.equal(a, b)


def test_emulator_fit_on_gpu_repeats_its_bits(cuda):
    """Two fits of one seed (augmentation and dropout on) on the card:
    the same history and parameters, bit for bit."""
    from nbody_torch.emulator.data import DeltaDataset
    from nbody_torch.emulator.model import CosmoCNN
    from nbody_torch.emulator.train import fit

    rng = np.random.default_rng(0)
    ds = DeltaDataset(rng.normal(size=(24, 16, 16, 16)).astype(np.float32),
                      rng.uniform(0.9, 1.0, (24, 1)).astype(np.float32),
                      np.ones(1))
    va = DeltaDataset(ds.X[:5], ds.y[:5], ds.maxima)
    a = fit(CosmoCNN(), ds, va, epochs=3, batch_size=8, seed=4)
    b = fit(CosmoCNN(), ds, va, epochs=3, batch_size=8, seed=4)
    assert a.history == b.history
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert all(v.is_cuda for v in a.params.values())


def test_emulator_data_on_gpu_matches_cpu(cuda, tmp_path):
    """create_linear_dataset and state_to_delta on the card against the
    CPU: the same generators, float32 FFTs to 1e-5 of the largest
    value."""
    from nbody_torch.emulator.data import (
        create_linear_dataset,
        delta_path,
        state_to_delta,
    )

    kw = dict(z=0.0, box=500.0, nmesh=16, A_s_min=1.5e-9, A_s_max=2.7e-9)
    create_linear_dataset(str(tmp_path / "gpu"), 6, **kw)
    create_linear_dataset(str(tmp_path / "cpu"), 6, device="cpu", **kw)
    for i in range(1, 7):
        a = np.load(delta_path(str(tmp_path / "gpu"), i))
        b = np.load(delta_path(str(tmp_path / "cpu"), i))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    pos = torch.rand((2, 4096, 3), generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64).float() * 500.0
    got = state_to_delta(pos.to(cuda), 500.0, 16).cpu()
    ref = state_to_delta(pos, 500.0, 16)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
