"""The batched tier's plane tiers on the CPU: B members' plane builds
against the members' own builds stacked, the plain versions of K2, K3,
K4, K6 and the Ewald PP force over B members against B single calls,
K2's fixed-point exponent a member's own, the batch's overflow word (each
field the largest member's), and the pre-warm sized for the densest
member.  Small sizes: 512-1,000 particles a member, 3 members."""

import numpy as np
import pytest
import torch

from nbody_torch.driver import SimulationConfig
from nbody_torch.driver.simulate import prewarm_capacity
from nbody_torch.forces import p3m_columns as pc
from nbody_torch.forces import pm_supercell as ps
from nbody_torch.forces.ewald import ewald_pp_acc
from nbody_torch.forces.p3m import (
    build_padded_plane,
    p3m_acc,
    run_cell_plane,
)
from nbody_torch.mesh.cells import build_cell_list

BOX, NMESH, B = 200.0, 32, 3


def _members(n=512, seed=0, dtype=torch.float64, clump=True):
    """B members, masses about 1: uniform, the last (with ``clump``) with
    half its particles in a clump (other column and cell counts)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, BOX, (B, n, 3))
    if clump:
        pos[2, : n // 2] = (0.3 * BOX + 0.04 * BOX * rng.standard_normal(
            (n // 2, 3))) % BOX
    mass = rng.uniform(0.5, 1.5, (B, n))
    return torch.tensor(pos, dtype=dtype), torch.tensor(mass, dtype=dtype)


def _column_geometry(n, capacity=None):
    """The supercell geometry's plane knobs; at a given ``capacity`` the
    window spans the whole column (no window misses)."""
    r_s, r_cut, ncell, ck, w = ps.supercell_params(BOX, NMESH, n)
    if capacity:
        ck, w = capacity, 1 << 20
    CK, gz, stride, W, maxch, chunk = pc.plane_geometry(BOX, r_cut, ck, w)
    return dict(r_s=r_s, r_cut=r_cut, ncell=ncell, CK=CK, gz=gz,
                stride=stride, W=W, maxch=maxch, chunk=chunk)


def test_batched_column_plane_equals_member_builds():
    pos, mass = _members()
    g = _column_geometry(pos.shape[1], capacity=128)
    args = (BOX, g["r_cut"], g["ncell"], g["CK"], g["W"])
    got = pc.build_column_plane(pos, mass, *args, chunk=g["chunk"])
    assert got[0].shape == (B, 8, (g["ncell"] + 2) ** 2 * g["stride"])
    # the clumped member overflows its buckets, the others do not
    assert int(got[3][2]) > 0 and int(got[3][0]) == 0
    for b in range(B):
        one = pc.build_column_plane(pos[b], mass[b], *args, chunk=g["chunk"])
        for t_got, t_one in zip(got, one):
            assert torch.equal(t_got[b], t_one)


@pytest.mark.parametrize("valid", [False, True])
def test_batched_cell_plane_equals_member_builds(valid):
    pos, mass = _members()
    r_cut = BOX / 5.5
    act = (torch.rand(pos.shape[:2], generator=torch.Generator()
                      .manual_seed(1)) < 0.3) if valid else None
    cl = build_cell_list(pos, BOX, 5, 16, valid=act)
    got = build_padded_plane(pos, mass, BOX, r_cut, 5, 16, valid=act)
    assert int(got[1][2]) > 0 and int(got[1][0]) == 0
    for b in range(B):
        v = None if act is None else act[b]
        one_cl = build_cell_list(pos[b], BOX, 5, 16, valid=v)
        for t_got, t_one in zip(cl, one_cl):
            assert torch.equal(t_got[b], t_one)
        one = build_padded_plane(pos[b], mass[b], BOX, r_cut, 5, 16,
                                 valid=v)
        assert got[2] == one[2]
        for i in (0, 1, 3, 4):
            assert torch.equal(got[i][b], one[i])


def _close(a, b, tol=1e-12):
    return float((a - b).abs().max()) <= tol * max(float(b.abs().max()),
                                                   1e-300)


@pytest.mark.parametrize("site", ["K2", "K3", "K4", "K6", "ewald"])
def test_batched_plain_paths_equal_single_calls(site):
    """Each plain version over B members (what a CPU tensor takes in
    place of the kernel) against B single calls, float64, to 1e-12."""
    pos, mass = _members(clump=site in ("K6", "ewald"))
    if site == "ewald":
        got = ewald_pp_acc(pos, mass, BOX, eps=0.5)
        for b in range(B):
            assert _close(got[b], ewald_pp_acc(pos[b], mass[b], BOX,
                                               eps=0.5))
        return
    if site == "K6":
        r_cut = BOX / 5.5
        plane, ov, K, _, counts = build_padded_plane(pos, mass, BOX, r_cut,
                                                     5, 256)
        assert int(ov.max()) == 0
        kw = dict(nx=5, ncell=5, K=K, eps2=0.25, r_s=r_cut / 4.5,
                  r_cut=r_cut, split="spline", softening="spline")
        got = run_cell_plane(plane.double(), counts, **kw)
        for b in range(B):
            assert _close(got[b], run_cell_plane(plane[b].double(),
                                                 counts[b], **kw))
        return
    g = _column_geometry(pos.shape[1])
    built = pc.build_column_plane(pos, mass, BOX, g["r_cut"], g["ncell"],
                                  g["CK"], g["W"], chunk=g["chunk"])
    plane, ws, nch, counts = (built[i] for i in (0, 1, 2, 6))
    assert int(built[3].max()) == int(built[4].max()) == 0
    plane = plane.double()
    geo = dict(ncell=g["ncell"], stride=g["stride"], gz=g["gz"],
               chunk=g["chunk"])
    pair = dict(geo, W=g["W"], maxch=g["maxch"], eps=0.5, r_s=g["r_s"],
                r_cut=g["r_cut"], split="spline", softening="spline")
    if site == "K2":
        got = ps.supercell_deposit_from_plane(plane, counts, box=BOX,
                                              nmesh=NMESH, **geo)
        ones = [ps.supercell_deposit_from_plane(plane[b], counts[b], box=BOX,
                                                nmesh=NMESH, **geo)
                for b in range(B)]
    elif site == "K3":
        grids = torch.randn((B, 3) + (NMESH,) * 3, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(2))
        kw = dict(pair, S=NMESH // g["ncell"], scale=NMESH / BOX)
        got = ps.run_fused_column_plane(plane, ws, nch, grids, **kw)
        ones = [ps.run_fused_column_plane(plane[b], ws[b], nch[b], grids[b],
                                          **kw) for b in range(B)]
    else:
        got = pc.run_column_plane(plane, ws, nch, box=BOX, **pair)
        ones = [pc.run_column_plane(plane[b], ws[b], nch[b], box=BOX, **pair)
                for b in range(B)]
    assert got.shape[0] == B
    for b in range(B):
        assert float(ones[b].abs().max()) > 0
        assert _close(got[b], ones[b])


def test_k2_exponent_is_each_members_own():
    """K2's fixed point (the kernel's rounding, modelled by
    ``deposit_atomics``) for members whose masses differ by 10^6 on one
    lattice: each member's exponent follows its own largest mass, and a
    batch-wide exponent (the heaviest member's) would round the light
    member's corner masses otherwise."""
    q = (np.indices((8,) * 3).reshape(3, -1).T + 0.5) * (BOX / 8)
    q = q + np.random.default_rng(4).normal(0.0, 1e-3 * BOX / NMESH, q.shape)
    pos = torch.tensor(q, dtype=torch.float32)
    g = _column_geometry(pos.shape[0])
    exps, sums = [], []
    for scale in (1e3, 1e-3):
        built = pc.build_column_plane(pos, torch.full((512,), scale), BOX,
                                      g["r_cut"], g["ncell"], g["CK"],
                                      g["W"], chunk=g["chunk"])
        node, w, e = ps.deposit_atomics(
            built[0], built[6], ncell=g["ncell"], S=NMESH // g["ncell"],
            nmesh=NMESH, stride=g["stride"], gz=g["gz"], scale=NMESH / BOX)
        assert e == ps.deposit_fixed_exponent(scale, 512)
        exps.append(e)
        sums.append((node, w))
    # 1e3 < 2^10, 1e-3 < 2^-9
    assert exps[1] - exps[0] == 19
    node, w = sums[1]
    own = ps.deposit_fixed(NMESH**3, node, w, exps[1])[1]
    wide = ps.deposit_fixed(NMESH**3, node, w, exps[0])[1]
    assert not torch.equal(own, wide)


def test_batch_overflow_word_is_the_max_over_members():
    """The overflow word of a batch: each field the largest member's
    (never the sum), so the heal grows what the neediest member needs."""
    ov_b = torch.tensor([0, 7, 3])
    ov_w = torch.tensor([5, 0, 2])
    word = int(pc.encode_overflow(ov_b, ov_w))
    assert word == 7 * 65536 + 5
    assert word >> 16 == max(int(pc.encode_overflow(b, w)) >> 16
                             for b, w in zip(ov_b, ov_w))
    # one field only: the largest member's word
    words = [int(pc.encode_overflow(torch.tensor(b), torch.tensor(0)))
             for b in (0, 7, 3)]
    assert int(pc.encode_overflow(ov_b, torch.zeros(3, dtype=torch.long))) \
        == max(words)
    # through p3m_acc (the supercell's whole force): a uniform member and
    # a clumped one that overflows a small capacity
    pos, mass = (t[1:] for t in _members())
    for tier, cap, part in (("columns", 128, "short"),
                            ("supercell", 128, "both"),
                            ("cells", 16, "short")):
        _, ov = p3m_acc(pos, mass, BOX, NMESH, shortrange=tier, capacity=cap,
                        with_overflow=True, part=part)
        ones = [int(p3m_acc(pos[b], mass[b], BOX, NMESH, shortrange=tier,
                            capacity=cap, with_overflow=True,
                            part=part)[1]) for b in range(2)]
        assert ones[1] > 0 and ones[0] == 0
        assert int(ov) == max(ones)


def test_prewarm_sizes_for_the_densest_member():
    pos, _ = _members(n=4096)
    for tier in ("columns", "supercell", "cells"):
        cfg = SimulationConfig(n_side=16, box=BOX, pm_grid=NMESH,
                               shortrange=tier)
        got, lines = prewarm_capacity(cfg, cfg, pos)
        assert lines
        ones = [prewarm_capacity(cfg, cfg, pos[b])[0] for b in range(B)]
        for field in ("column_capacity", "column_window", "cell_capacity"):
            assert getattr(got, field) == max(getattr(o, field)
                                              for o in ones)
