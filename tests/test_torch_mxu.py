"""The torch port's Gram-form all-pairs force (K8's plain version) against
the JAX package, on the CPU.

Same inputs (numpy, seeded) through both.  The JAX K8 runs as its own
tests run it here (Pallas interpret mode, ti=128, tj=256); the port's CPU
tensors take K8's plain PyTorch version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.forces import pallas_mxu as jmx
from nbody_torch.forces import allpairs as tap
from nbody_torch.forces import pallas_mxu as tmx

# float64 against float64 with the same algebra: only summation order
# differs (and the port's separations for pairs below lambda_i, which in
# float64 agree with the Gram r^2 to ~1e-13)
F64_RTOL = 1e-10
TILES = dict(ti=128, tj=256)
# the JAX package's float32 envelope for this kernel
# (tests/test_forces.py::test_mxu_matches_exact_kernel_f32): per-particle
# relative force error against float64
MEDIAN_TOL, MAX_TOL = 1e-4, 1e-2


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol=F64_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


def _box_system(n, seed, box, dtype=np.float64):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (n, 3)).astype(dtype)
    return pos, rng.uniform(0.5, 2.0, n).astype(dtype)


def _force_errors(acc, pos, mass, eps):
    """Per-particle relative error against the float64 dense oracle."""
    ref = tap.direct_acc(_t(pos).double(), _t(mass).double(), eps).numpy()
    err = np.linalg.norm(np.asarray(acc, np.float64) - ref, axis=1)
    return err / np.linalg.norm(ref, axis=1)


@pytest.mark.parametrize("n", [200, 700, 1500])
def test_mxu_matches_jax_and_the_oracle(n):
    """acc and E_pot against the JAX Gram kernel and the dense oracles
    (N = 1,500 is ragged against both tiles)."""
    pos, mass = _box_system(n, n, 300.0)
    eps, G = 0.2, 1.7
    jacc, jphi = jmx.allpairs_pallas_mxu(jnp.asarray(pos), jnp.asarray(mass),
                                         eps=eps, G=G, **TILES)
    acc, phi = tmx.allpairs_pallas_mxu(_t(pos), _t(mass), eps, G, **TILES)
    assert acc.dtype == torch.float64 and phi.shape == (n,)
    _close(acc, jacc)
    _close(acc, tap.direct_acc(_t(pos), _t(mass), eps, G))
    e_pot = 0.5 * float(torch.sum(_t(mass) * phi))
    assert e_pot == pytest.approx(0.5 * float(jnp.sum(mass * jphi)),
                                  rel=F64_RTOL)
    assert e_pot == pytest.approx(
        float(tap.direct_potential(_t(pos), _t(mass), eps, G)), rel=F64_RTOL)


def test_mxu_unsorted_matches_sorted():
    """sort=False takes the same algebra without the Morton permutation."""
    pos, mass = _box_system(384, 5, 50.0)
    a1, p1 = tmx.allpairs_pallas_mxu(_t(pos), _t(mass), 0.1, ti=128, tj=128)
    a2, p2 = tmx.allpairs_pallas_mxu(_t(pos), _t(mass), 0.1, ti=128, tj=128,
                                     sort=False)
    _close(a1, a2, 1e-9)
    _close(p1, p2, 1e-9)
    ja, _ = jmx.allpairs_pallas_mxu(jnp.asarray(pos), jnp.asarray(mass),
                                    eps=0.1, ti=128, tj=128, sort=False)
    _close(a2, ja)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bits", [4, 6, 10])
def test_morton_codes_match_jax(bits, dtype):
    """The codes integer for integer, and the same stable permutation
    where many codes tie."""
    rng = np.random.default_rng(bits)
    pos = rng.uniform(-3.0, 7.0, (3000, 3)).astype(dtype)
    # a coarse lattice with repeated points: many tied codes
    pos[:1500] = np.round(pos[:1500]).astype(dtype)
    want = np.asarray(jmx.morton_codes(jnp.asarray(pos), bits=bits))
    got = tmx.morton_codes(_t(pos), bits=bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) < len(want)
    np.testing.assert_array_equal(
        torch.argsort(got, stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(want))))


@pytest.mark.parametrize("eps", [0.0, -0.5])
def test_mxu_requires_softening(eps):
    pos, mass = _box_system(8, 0, 1.0)
    with pytest.raises(ValueError, match="eps > 0"):
        tmx.allpairs_pallas_mxu(_t(pos), _t(mass), eps)


def test_cpu_tensors_launch_nothing():
    pos, mass = _box_system(16, 1, 1.0)
    before = tmx.allpairs_pallas_mxu.launches
    tmx.allpairs_pallas_mxu(_t(pos), _t(mass), 0.1)
    assert tmx.allpairs_pallas_mxu.launches == before


@pytest.mark.parametrize("tiles", [TILES, dict(ti=256, tj=1024)])
def test_float32_plain_inside_the_envelope(tiles):
    """float32 through the plain version at the JAX package's envelope
    shape: N = 2,048 uniform in a 500 box, eps 0.5, unit masses."""
    pos, _ = _box_system(2048, 9, 500.0, np.float32)
    mass = np.ones(2048, np.float32)
    acc, _ = tmx.allpairs_pallas_mxu(_t(pos), _t(mass), 0.5, **tiles)
    assert acc.dtype == torch.float32
    err = _force_errors(acc, pos, mass, 0.5)
    assert np.median(err) < MEDIAN_TOL and err.max() < MAX_TOL, (
        np.median(err), err.max())


def _round_tf32(x):
    """Round float32 to TF32's 10-bit mantissa (nearest, ties away)."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def test_one_pass_tf32_gram_breaks_the_envelope(monkeypatch):
    """Planted: the same pipeline with its Gram operands rounded once to
    TF32 (what a one-pass TF32 product sees) reads a median error above
    the envelope's 1e-4, so the card's gate would catch such a kernel."""
    plain = tmx._gram_operands

    def one_pass(xic, xjc, eps2):
        a, b = plain(xic, xjc, eps2)
        return _round_tf32(a), _round_tf32(b)

    monkeypatch.setattr(tmx, "_gram_operands", one_pass)
    pos, _ = _box_system(2048, 9, 500.0, np.float32)
    mass = np.ones(2048, np.float32)
    acc, _ = tmx.allpairs_pallas_mxu(_t(pos), _t(mass), 0.5, **TILES)
    err = _force_errors(acc, pos, mass, 0.5)
    assert np.median(err) > MEDIAN_TOL, np.median(err)
