"""The torch port's CIC deposit against the form it replaced, on the CPU:
the fixed-point ``scatter_sum`` (one function for every deposit and
P(k) binning of the port, deterministic on the card) against ``index_add_``
in float64, and the slab deposits of the domain decomposition against
the whole-box deposit cut into slabs.  tests/test_torch_cuda.py holds
it bit for bit over two calls on the card."""

import itertools

import numpy as np
import pytest
import torch

from nbody_torch.distributed.domain import slab_bspline_deposit
from nbody_torch.distributed.sharding import device_mesh
from nbody_torch.mesh.cic import bspline_deposit, cic_deposit, scatter_sum

# float64 sums in another order
TOL = 1e-12
BOX = 50.0


def _particles(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.uniform(0.0, BOX, (n, 3)))
    # a clump, so that cells sum many corners
    pos[: n // 4] = torch.remainder(
        torch.tensor(rng.normal(10.0, 0.7, (n // 4, 3))), BOX)
    return pos, torch.tensor(rng.uniform(0.5, 1.5, n))


def _index_add(size, index, values):
    out = torch.zeros(size, dtype=values.dtype)
    return out.index_add_(0, index, values)


def test_scatter_sum_matches_index_add():
    rng = np.random.default_rng(1)
    index = torch.tensor(rng.integers(0, 97, 5000))
    values = torch.tensor(rng.normal(size=5000))
    got, want = scatter_sum(100, index, values), _index_add(100, index,
                                                           values)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    assert torch.equal(got[97:], torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("order", [2, 3, 4])
def test_deposit_matches_index_add_form(order):
    """The deposit of each B-spline order against the same corners and
    weights added by ``index_add_``, with and without the half-cell
    shift of the interlaced pass."""
    from nbody_torch.mesh import cic

    pos, mass = _particles(3000)
    nmesh = 16
    for shift in (0.0, 0.5):
        got = bspline_deposit(pos, BOX, nmesh, order=order, weights=mass,
                              shift=shift)
        if order == 2:
            lin, w = cic._cic_corners(pos, BOX, nmesh, shift)
            lin, w = lin.reshape(-1), (w * mass).reshape(-1)
        else:
            s = pos * (nmesh / BOX) - shift
            offs = (-1, 0, 1) if order == 3 else (-1, 0, 1, 2)
            ic = torch.floor(s + 0.5 if order == 3 else s).to(torch.int64)
            lins, ws = [], []
            for o in itertools.product(offs, repeat=3):
                idx = [torch.remainder(ic[:, ax] + o[ax], nmesh)
                       for ax in range(3)]
                lins.append((idx[0] * nmesh + idx[1]) * nmesh + idx[2])
                ws.append(mass * torch.prod(torch.stack([
                    cic._bspline_weight(order, s[:, ax] - (ic[:, ax] + o[ax]))
                    for ax in range(3)]), dim=0))
            lin, w = torch.cat(lins), torch.cat(ws)
        want = _index_add(nmesh**3, lin, w).reshape(nmesh, nmesh, nmesh)
        assert float((got - want).abs().max()) <= TOL * float(
            want.abs().max())
    assert float(cic_deposit(pos, BOX, nmesh, weights=mass).sum()) == \
        pytest.approx(float(mass.sum()), rel=TOL)


@pytest.mark.parametrize("order", [2, 3])
def test_slab_deposits_match_the_whole_box(order):
    """Each shard's slab of the slab deposit (its particles, the spill
    planes exchanged) equals its slab of the whole-box deposit."""
    pos, mass = _particles(4000, seed=2)
    nmesh, D = 16, 4
    group = device_mesh(D, device="cpu")
    slab = (pos[:, 0] * (D / BOX)).to(torch.int64).clamp(0, D - 1)
    shards = [slab == d for d in range(D)]
    got = slab_bspline_deposit([pos[m] for m in shards],
                               [mass[m] for m in shards], box=BOX,
                               nmesh=nmesh, group=group, order=order)
    want = bspline_deposit(pos, BOX, nmesh, order=order, weights=mass)
    Xl = nmesh // D
    for d in range(D):
        assert float((got[d] - want[d * Xl:(d + 1) * Xl]).abs().max()) <= \
            TOL * float(want.abs().max())
