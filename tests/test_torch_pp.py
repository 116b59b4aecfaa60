"""The torch port's all-pairs force (K7's plain version) and the dense
oracles against the JAX package, on the CPU.

Same inputs (numpy, seeded) through both, float64.  The JAX K7 runs as
its own tests run it here (Pallas interpret mode, ti=128, tj=256); the
port's CPU tensors take K7's plain PyTorch version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody.forces import allpairs as jap
from nbody.forces import pallas_pp as jpp
from nbody_torch.forces import allpairs as tap
from nbody_torch.forces import pallas_pp as tpp

# float64 against float64 with the same algebra: only summation order
# differs (einsum vs the interpret-mode tile sums)
F64_RTOL = 1e-10
EPS, G = 0.05, 2.0
TILES = dict(ti=128, tj=256, interpret=True)


def _particles(n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, scale, (n, 3)), rng.uniform(0.5, 1.5, n)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _close(got, want, rtol=F64_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


@pytest.mark.parametrize("box", [0.0, 3.0])
@pytest.mark.parametrize("n", [5, 300, 1000])
def test_allpairs_matches_jax(n, box):
    """acc and phi (G applied, self-term removed), with and without the
    minimum image."""
    pos, mass = _particles(n)
    want = jpp.allpairs_pallas(jnp.asarray(pos), jnp.asarray(mass), eps=EPS,
                               G=G, box=box, **TILES)
    got = tpp.allpairs_pallas(_t(pos), _t(mass), EPS, G, box=box)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("n", [5, 300, 1000])
def test_block_acc_matches_jax(n):
    """Raw sums of n targets against a different set of sources."""
    pos_i, _ = _particles(n, seed=1)
    pos_j, mass_j = _particles(2 * n + 7, seed=2)
    want = jpp.block_acc_pallas(jnp.asarray(pos_i), jnp.asarray(pos_j),
                                jnp.asarray(mass_j), EPS, **TILES)
    got = tpp.block_acc_pallas(_t(pos_i), _t(pos_j), _t(mass_j), EPS)
    for g, w in zip(got, want):
        _close(g, w)


def test_block_acc_periodic_is_allpairs_raw():
    """block_acc with box > 0 on (pos, pos) is allpairs' sums before G
    and the self-term."""
    pos, mass = _particles(64, seed=3)
    acc, pot = tpp.block_acc_pallas(_t(pos), _t(pos), _t(mass), EPS, box=2.0)
    want = jpp.allpairs_pallas(jnp.asarray(pos), jnp.asarray(mass), eps=EPS,
                               G=1.0, box=2.0, **TILES)
    _close(acc, want[0])
    _close(-(pot.numpy() - mass / EPS), want[1])


@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_oracles_match_jax(eps):
    pos, mass = _particles(40, seed=4)
    jp, jm, tp, tm = jnp.asarray(pos), jnp.asarray(mass), _t(pos), _t(mass)
    _close(tap.direct_acc(tp, tm, eps, G), jap.direct_acc(jp, jm, eps, G))
    assert float(tap.direct_potential(tp, tm, eps, G)) == pytest.approx(
        float(jap.direct_potential(jp, jm, eps, G)), rel=F64_RTOL)
    _close(tap.direct_acc_periodic(tp, tm, 1.5, eps, G),
           jap.direct_acc_periodic(jp, jm, 1.5, eps, G))
    acc, epot = tap.direct_acc_chunked(tp, tm, eps, G, chunk=16)
    jacc, jepot = jap.direct_acc_chunked(jp, jm, eps, G, chunk=16)
    _close(acc, jacc)
    assert float(epot) == pytest.approx(float(jepot), rel=F64_RTOL)


def test_allpairs_agrees_with_the_oracles():
    """The port's K7 plain version against its own dense oracles: the
    chunked acceleration and energy, and the minimum-image oracle."""
    pos, mass = _particles(200, seed=5)
    tp, tm = _t(pos), _t(mass)
    acc, phi = tpp.allpairs_pallas(tp, tm, EPS, G)
    oacc, oepot = tap.direct_acc_chunked(tp, tm, EPS, G, chunk=64)
    _close(acc, oacc)
    assert float(0.5 * torch.sum(tm * phi)) == pytest.approx(float(oepot),
                                                              rel=F64_RTOL)
    pacc, _ = tpp.allpairs_pallas(tp, tm, EPS, G, box=2.5)
    _close(pacc, tap.direct_acc_periodic(tp, tm, 2.5, EPS, G))


@pytest.mark.parametrize("eps", [0.0, -0.1])
def test_allpairs_requires_softening(eps):
    pos, mass = _particles(4)
    with pytest.raises(ValueError, match="eps > 0"):
        tpp.allpairs_pallas(_t(pos), _t(mass), eps)


def test_cpu_tensors_launch_nothing():
    """A CPU tensor takes the plain version: the launch counts stay."""
    pos, mass = _particles(8)
    before = (tpp.allpairs_pallas.launches, tpp.block_acc_pallas.launches)
    tpp.allpairs_pallas(_t(pos), _t(mass), EPS)
    tpp.block_acc_pallas(_t(pos), _t(pos), _t(mass), EPS)
    assert (tpp.allpairs_pallas.launches,
            tpp.block_acc_pallas.launches) == before
    assert tpp.interactions_per_call(262144) == 262144**2


@pytest.mark.parametrize("targets_per_thread", [1, 4])
@pytest.mark.parametrize("blocks_per_sm", [8, 12])
@pytest.mark.parametrize("nj", [1, 100, 70001, 65536])
@pytest.mark.parametrize("ni", [0, 1, 129, 3001, 65536, 262144])
def test_launch_geometry(ni, nj, blocks_per_sm, targets_per_thread):
    """K7's launch shape on the H100's 132 SMs: every source in exactly one
    slice of whole tiles, as the kernel reads them (pp_allpairs.cu: jb,
    je), no more slices than tiles, one slice where the target blocks make
    WAVES waves of the card's slots, and otherwise at least half that many
    where the tiles allow it, so at least a wave (the 65,536^2 ring launch
    among them)."""
    geo = tpp.launch_geometry(ni, nj, 132, blocks_per_sm, targets_per_thread)
    block = geo.threads * geo.targets_per_thread
    assert (geo.target_blocks - 1) * block < ni <= geo.target_blocks * block
    tiles = -(-nj // geo.threads)
    assert 1 <= geo.slices <= tiles
    assert geo.slice_sources > 0 and geo.slice_sources % geo.threads == 0
    seen = np.zeros(nj, dtype=int)
    for s in range(geo.slices):
        jb = s * geo.slice_sources
        je = nj if nj - jb <= geo.slice_sources else jb + geo.slice_sources
        assert jb < je
        seen[jb:je] += 1
    assert (seen == 1).all()
    slots = 132 * blocks_per_sm
    waves = tpp.WAVES * slots
    if geo.target_blocks == 0 or geo.target_blocks >= waves:
        assert geo.slices == 1
    elif geo.target_blocks * tiles >= waves:
        assert 2 * geo.target_blocks * geo.slices >= waves
        assert geo.target_blocks * geo.slices >= slots
    else:
        assert geo.slices == tiles
    if ni == nj == 65536:
        assert geo.target_blocks * geo.slices >= slots
