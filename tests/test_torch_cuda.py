"""The torch port's CUDA kernels on the card: K1 against its plain
version, its wrapper's checks and launch count, and a tiny run on the GPU
against the same run on the CPU.  Skipped without a GPU.  On a machine
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

    plane, ws, nch, _, kw, _, _, _ = _column_case(cuda)
    kw.update(split=split, softening=softening)
    before = run_column_plane.launches
    got = run_column_plane(plane, ws, nch, **kw)
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
    # float32 sums in another order (atomic adds), see chip_smoke.py
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_column_wrappers_reject(cuda):
    from nbody_torch.forces.p3m_columns import run_column_plane
    from nbody_torch.forces.pm_supercell import run_fused_column_plane

    plane, ws, nch, _, kw, S, box, nmesh = _column_case(cuda, n=2000)
    kw.update(split="spline", softening="spline")
    with pytest.raises(TypeError):
        run_column_plane(plane.double(), ws, nch, **kw)
    with pytest.raises(TypeError):
        run_column_plane(plane, ws.long(), nch, **kw)
    with pytest.raises(ValueError):
        run_column_plane(plane[:4].contiguous(), ws, nch, **kw)
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
