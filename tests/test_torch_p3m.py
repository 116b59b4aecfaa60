"""The torch port's P3M forces against the JAX package, on the CPU.

Same inputs (numpy, seeded) through both; float64.  The JAX K1 runs as
its own tests run it here (Pallas interpret mode); the port's CPU tensors
take K1's plain PyTorch version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.forces import p3m as jp3m
from nbody_torch.forces import p3m as tp3m

VARIANTS = [(s, k) for s in ("gaussian", "spline") for k in ("plummer", "spline")]

# float64 against float64 with the same algebra: only summation order
# differs (einsum vs the interpret-mode tile sums)
F64_RTOL = 1e-10


def _particles(n, box, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (n, 3))
    mass = rng.uniform(0.5, 1.5, n)
    return pos, mass


def _close(got, want, rtol=F64_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


@pytest.mark.parametrize("split,softening", VARIANTS)
def test_weight_functions(split, softening):
    """The weights are the physics: same values over 0 <= r <= 1.2 r_cut
    (r = 0 and the cutoff edge included), eps^2, r_s, r_cut as in P3M."""
    r_cut, r_s, eps = 13.5, 3.0, 0.4
    r = np.concatenate([[0.0, 1e-8], np.linspace(1e-3, 1.2 * r_cut, 2001)])
    want = jp3m._weight_fn(split, softening)(jnp.asarray(r * r), eps * eps, r_s, r_cut)
    got = tp3m._weight_fn(split, softening)(torch.tensor(r * r), eps * eps, r_s, r_cut)
    # the spline split's weight vanishes at r_cut by cancellation, so
    # the bound there is absolute, relative to the largest weight
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-13 * np.abs(want).max())
    assert np.all(got.numpy()[r >= r_cut] == 0.0)


@pytest.mark.parametrize("split,softening", VARIANTS)
def test_k1_plain_matches_jax_kernel(split, softening):
    """K1's plain version (the CPU path of p3m_short_acc) against the JAX
    Pallas kernel, N = 700 (not a multiple of any tile)."""
    box, r_s, r_cut, eps = 100.0, 3.0, 13.5, 0.3
    pos, mass = _particles(700, box)
    want = jp3m.p3m_short_acc(jnp.asarray(pos), jnp.asarray(mass), box, eps,
                              r_s, r_cut, G=2.0, split=split,
                              softening=softening)
    got = tp3m.p3m_short_acc(torch.tensor(pos), torch.tensor(mass), box, eps,
                             r_s, r_cut, G=2.0, split=split,
                             softening=softening)
    _close(got, want)


@pytest.mark.parametrize("split,softening", VARIANTS)
def test_short_direct_and_chunking(split, softening):
    """The dense oracle against the JAX oracle, and the plain version is
    independent of its target chunking (unwrapped positions too)."""
    box, r_s, r_cut, eps = 80.0, 2.5, 11.0, 0.25
    pos, mass = _particles(500, box, seed=1)
    pos = pos + box * np.random.default_rng(2).integers(-2, 3, pos.shape)
    want = jp3m.p3m_short_direct(jnp.asarray(pos), jnp.asarray(mass), box,
                                 eps, r_s, r_cut, G=1.5, split=split,
                                 softening=softening)
    tpos, tmass = torch.tensor(pos), torch.tensor(mass)
    direct = tp3m.p3m_short_direct(torch.remainder(tpos, box), tmass, box,
                                   eps, r_s, r_cut, G=1.5, split=split,
                                   softening=softening)
    _close(direct, want)
    for chunk in (997, 1 << 24):
        got = tp3m.p3m_short_plain(tpos, tmass, box, eps, r_s, r_cut, G=1.5,
                                   split=split, softening=softening,
                                   chunk_pairs=chunk)
        _close(got, want)


@pytest.mark.parametrize("part", ["both", "long", "short", "split"])
@pytest.mark.parametrize("split", ["gaussian", "spline"])
def test_p3m_acc_parts(part, split):
    """Full P3M (PM far field + dense short range) for every part."""
    box, nmesh = 60.0, 16
    pos, mass = _particles(512, box, seed=3)
    kw = dict(G=1.3, eps=0.2, split=split, softening="spline", part=part,
              shortrange="allpairs")
    want = jp3m.p3m_acc(jnp.asarray(pos), jnp.asarray(mass), box, nmesh, **kw)
    got = tp3m.p3m_acc(torch.tensor(pos), torch.tensor(mass), box, nmesh, **kw)
    if part == "split":
        _close(got[0], want[0])
        _close(got[1], want[1])
        assert got[2] == int(want[2]) == 0
    else:
        _close(got, want)


def test_p3m_short_params():
    for box, nmesh, n in ((500.0, 64, 32768), (200.0, 16, 512), (1e3, 128, 2**20)):
        assert tp3m.p3m_short_params(box, nmesh, n) == jp3m.p3m_short_params(box, nmesh, n)


@pytest.mark.parametrize("part", ["both", "short", "split"])
def test_unported_tiers_raise(part):
    """The cell tier (K6), which the port did not run before, now runs
    for every part and matches the JAX package's cell tier (float32 cell
    planes in both: the column tiers' tolerance, tests/test_torch_columns.
    py)."""
    pos, mass = _particles(400, 100.0)
    kw = dict(G=1.2, eps=0.2, split="spline", softening="spline",
              shortrange="cells", part=part)
    # a 4^3 cell grid (r_cut 23.4)
    got = tp3m.p3m_acc(torch.tensor(pos), torch.tensor(mass), 100.0, 24, **kw)
    want = jp3m.p3m_acc(jnp.asarray(pos), jnp.asarray(mass), 100.0, 24, **kw)
    if part != "split":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor) and g.ndim:
            _close(g, w, rtol=2e-5)
        else:
            assert int(g) == int(w) == 0


def test_auto_beyond_allpairs_raises_and_small_box_falls_back():
    """'auto' above ALLPAIRS_MAX_N resolves as the JAX package does:
    supercell where the mesh tiles a chaining grid, columns where it does
    not; a box under 3 r_cut runs the dense tier for every tier."""
    big = tp3m.ALLPAIRS_MAX_N + 1
    r_cut = 4.5 * 1.25 * 500.0 / 64
    assert tp3m.resolve_shortrange("auto", big, 500.0, r_cut, 64) == \
        "supercell"
    assert tp3m.resolve_shortrange("auto", big, 500.0, r_cut, 67) == \
        "columns"
    assert tp3m.resolve_shortrange("auto", big - 1, 500.0, r_cut, 64) == \
        "allpairs"
    assert tp3m.resolve_shortrange("cells", 64, 40.0, 15.0, 16) == "allpairs"
    assert tp3m.resolve_shortrange("auto", 10**6, 40.0, 15.0, 16) == \
        "allpairs"
    with pytest.raises(ValueError):
        tp3m.resolve_shortrange("tree", 64, 500.0, 40.0, 64)


def test_k1_wrapper_has_no_path_for_other_devices():
    """Only CPU tensors take the plain version; anything that is neither
    CPU nor CUDA raises instead of falling back."""
    pos = torch.zeros((8, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tp3m.p3m_short_acc(pos, torch.zeros(8, device="meta"), 10.0, 0.1,
                           1.0, 4.0)
