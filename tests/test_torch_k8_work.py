"""K8's vote, on the CPU: the plain counterpart of the rule by which the
redesigned kernel (nbody_torch/forces/csrc/pp_gram.cu) decides, once a
warp tile of 32 targets x 128 sources, whether to take the tile from the
Gram form or from the separations.

``pallas_mxu.k8_unsafe_tiles`` models the kernel's box test in float32.
The per-pair test flags a warp tile where some pair's Gram r^2 falls
below its target's lambda_i = max(eps^2, REFINE_K |xic|^2); the box test,
which spares the per-pair test where it clears a tile, must flag every
such tile (or the tile is the warp's own, which the kernel takes from
its separations in any case).  The Gram r^2 is taken here as
the plain version computes it (a float32 K = 8 product) and as the card
does (the 3xTF32 split of the kernel's operands, its two products summed
exactly and rounded once), on a Plummer set and a uniform set of 4,096
particles, Morton-sorted into the card's default tiles.
"""

import numpy as np
import pytest
import torch

from nbody_torch.forces import pallas_mxu as tmx
from nbody_torch.ic import systems

N = 4096
TI, TJ = 256, 1024


def _plummer():
    st = systems.plummer(N, seed=0, device="cpu")
    return st.pos, st.mass, 0.05


def _uniform():
    # scripts/exp_mxu.py's conditions at N = 4,096: a 500 box, eps
    # 0.03 box / N^(1/3)
    rng = np.random.default_rng(7)
    pos = torch.tensor(rng.uniform(0, 500.0, (N, 3)), dtype=torch.float32)
    return pos, torch.ones(N), 0.03 * 500.0 / 16


SETS = {"plummer": _plummer, "uniform": _uniform}


def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, ties away."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _gram_3xtf32(xic, xjc, eps2):
    """r^2 + eps^2 as the kernel's two TF32 products give it: A1 . B1 +
    A2 . B2 of the split operands (pp_gram.cu), summed in float64 and
    rounded once to float32."""
    q = xic[:, 2] * xic[:, 2] + (xic[:, 1] * xic[:, 1]
                                 + xic[:, 0] * xic[:, 0])
    Q = xjc[:, 2] * xjc[:, 2] + (xjc[:, 1] * xjc[:, 1]
                                 + xjc[:, 0] * xjc[:, 0])
    qh, ql = _split(q + eps2)
    Qh, Ql = _split(Q)
    xh, xl = _split(xic)
    sh, sl = _split(-2.0 * xjc)
    r2 = (qh.double() + ql.double())[:, None] \
        + (Qh.double() + Ql.double())[None, :]
    r2 = r2 + xh.double() @ (sh.double() + sl.double()).T \
        + xl.double() @ sh.double().T
    return r2.float()


def _pair_flags(pos_s, ctr, eps, gram):
    """(warps, tiles) bool: the warp tiles in which some pair's Gram r^2
    (``gram``: "f32" or "3xtf32") falls below its target's lambda."""
    npad = pos_s.shape[0]
    eps2 = float(eps) ** 2
    xic = pos_s - ctr.repeat_interleave(TI, dim=0)
    lam = torch.clamp(tmx.REFINE_K * (xic * xic).sum(1), min=eps2)
    below = torch.zeros((npad, npad), dtype=torch.bool)
    for t in range(npad // TI):
        rows = slice(t * TI, (t + 1) * TI)
        xjc = pos_s - ctr[t]
        if gram == "f32":
            a, b = tmx._gram_operands(xic[rows], xjc, eps2)
            r2 = a @ b.T
        else:
            r2 = _gram_3xtf32(xic[rows], xjc, eps2)
        below[rows] = r2 < lam[rows, None]
    w, k = tmx.K8_WARP_TARGETS, tmx.K8_TILE
    return below.view(npad // w, w, npad // k, k).any(3).any(1)


@pytest.fixture(scope="module", params=list(SETS))
def case(request):
    pos, mass, eps = SETS[request.param]()
    _, pos_s, _, ctr = tmx._sorted_tiles(pos, mass, TI, TJ, True, 6)
    return request.param, pos_s, ctr, eps


def _own():
    """(warps, tiles) bool: the tile of each warp's own targets."""
    w = torch.arange(N // tmx.K8_WARP_TARGETS)
    own = torch.zeros((N // tmx.K8_WARP_TARGETS, N // tmx.K8_TILE),
                      dtype=torch.bool)
    own[w, w * tmx.K8_WARP_TARGETS // tmx.K8_TILE] = True
    return own


@pytest.mark.parametrize("gram", ["f32", "3xtf32"])
def test_vote_flags_every_tile_the_pair_test_redoes(case, gram):
    """Every warp tile with a pair below its lambda is unsafe by the
    vote, or the warp's own (taken from its separations in any case)."""
    name, pos_s, ctr, eps = case
    vote = tmx.k8_unsafe_tiles(pos_s, ctr, TI, eps)
    pairs = _pair_flags(pos_s, ctr, eps, gram)
    assert vote.shape == pairs.shape == (N // 32, N // 128)
    missed = pairs & ~vote & ~_own()
    assert int(missed.sum()) == 0, (name, gram, int(missed.sum()))
    # a pair below lambda outside the warps' own tiles: the test has
    # something to catch
    assert bool((pairs & ~_own()).any())


def test_vote_without_refine_k_misses_tiles(case):
    """Planted: a vote that takes lambda as eps^2 alone (REFINE_K left
    out) clears uniform tiles whose pairs the per-pair test redoes: the
    test catches a vote that is not conservative."""
    name, pos_s, ctr, eps = case
    pairs = _pair_flags(pos_s, ctr, eps, "f32") & ~_own()
    vote = tmx.k8_unsafe_tiles(pos_s, ctr, TI, eps, refine_k=0.0)
    if name == "uniform":
        assert bool((pairs & ~vote).any())


def test_vote_on_uniform_positions_clears_most_tiles(case):
    name, pos_s, ctr, eps = case
    vote = tmx.k8_unsafe_tiles(pos_s, ctr, TI, eps)
    if name == "uniform":
        assert float(vote.float().mean()) < 0.5
