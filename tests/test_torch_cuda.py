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
