"""Whether a force evaluation's bits depend on the capacities it runs at,
on the GPU.

    python scripts/torch_capacity_bits.py [--root DIR] [--out PATH]
                                          [--cpu]

At cfg64's ICs (64^3 particles, box 500 Mpc, mesh 128, spline softening:
``scripts/parity_study.py:63-81``), each site runs at the capacity and
window that the driver's pre-warm gives (``prewarm_capacity``,
``column_knobs``) and again at twice that capacity with its own auto
window:

* K2, the supercell tier's deposit: the mass grid of the column plane;
* K3, its fused pair sum: the per-particle output on each plane, read
  from the same force grids;
* the supercell force through ``p3m_acc`` (K2, the FFTs and K3);
* K4, the columns tier's short force through ``p3m_acc``;
* K5, the rung tier's interior tick on a plan frozen at the ICs
  (``p3m_short_columns_frozen_masked``, a seeded eighth of the particles
  active; their rows compared);
* K6, the cells tier's short force through ``p3m_acc``, at the
  pre-warmed cell capacity and twice it.

Prints, a line a site, whether the two results are equal bit for bit and
their largest difference over the largest value, and writes the lines as
JSON to ``--out`` (default ``output/capacity_bits.json``).  ``--root DIR``
runs the package checked out in DIR (a parent commit unpacked there), so
that a parent and a change are compared in one call.  ``--cpu`` runs the
plain versions at 16^3 on the CPU (a check of the script alone).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def capacity_checks(cfg, pos, mass, card: str, k5=None) -> list:
    """The sites' results at the two capacities on the state ``pos``,
    ``mass`` of config ``cfg`` (its 'auto' tier the supercell); ``k5``:
    (pos, mass, active mask, healed config) of a rung run's state for K5,
    else a seeded eighth of the particles active at ``pos`` on the rung
    geometry of ``cfg`` with rungs=3.  Returns the report lines (dicts:
    site, equal, max_rel, knobs), each also printed."""
    import torch

    from nbody_torch.core import units
    from nbody_torch.driver.simulate import (
        _frozen_geometry,
        column_knobs,
        prewarm_capacity,
    )
    from nbody_torch.forces.p3m import p3m_acc, p3m_short_params
    from nbody_torch.forces.p3m_columns import (
        build_column_plane,
        column_window,
        freeze_column_plan,
        p3m_short_columns_frozen_masked,
        plane_geometry,
        read_back,
    )
    from nbody_torch.forces.pm import pm_module
    from nbody_torch.forces.pm_supercell import (
        run_fused_column_plane,
        supercell_deposit_from_plane,
        supercell_geometry,
    )

    box, nmesh, G = cfg.box, cfg.mesh_size, units.COSMO.G
    r_s, r_cut, _, _ = p3m_short_params(box, nmesh, cfg.n_particles)
    kw = dict(G=G, eps=cfg.eps, split=cfg.force_split,
              softening=cfg.softening_kernel, with_overflow=True)
    lines = []

    def report(site: str, a, b, knobs) -> None:
        a, b = a.float(), b.float()
        diff = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
        line = dict(site=site, equal=bool(torch.equal(a, b)),
                    max_rel=diff, knobs=knobs, card=card)
        lines.append(line)
        print(json.dumps(line), flush=True)

    def knobs_of(tier_cfg):
        grown, _ = prewarm_capacity(tier_cfg, tier_cfg, pos)
        _, ck, w = column_knobs(tier_cfg, grown)
        return [(ck, w), (2 * ck, column_window(box, float(r_cut), 2 * ck))]

    # K2 and K3 on the supercell tier's planes
    sc = knobs_of(cfg)
    ncell = column_knobs(cfg, cfg)[0]
    S, _ = supercell_geometry(nmesh, ncell)
    planes, rhos = [], []
    for ck, w in sc:
        CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut, ck, w)
        built = build_column_plane(pos, mass, box, float(r_cut), ncell, CK,
                                   W, chunk=chunk)
        if int(built[3]) or int(built[4]):
            raise SystemExit(f"the plane at CK {CK} overflows")
        planes.append((built, dict(ncell=ncell, stride=stride, W=W,
                                   maxch=maxch, gz=gz, chunk=chunk)))
        rhos.append(supercell_deposit_from_plane(
            built[0], built[6], box=box, nmesh=nmesh, ncell=ncell,
            stride=stride, gz=gz, chunk=chunk))
    report("K2", rhos[0], rhos[1], sc)
    mass_sum = torch.sum(mass).to(torch.float32)
    # K3 reads the same (not interlaced) force grids on both planes
    pm = pm_module(float(box), int(nmesh), int(cfg.deconvolve_p), False,
                   0.0, float(r_cut), cfg.pm_gradient, 0.0, pos.device,
                   torch.float32)
    grids = pm.force_grids_from_rho(rhos[0], 4.0 * 3.141592653589793
                                    * mass_sum / box**3,
                                    mass_sum).contiguous()
    k3 = []
    for built, geo in planes:
        plane_out = run_fused_column_plane(
            built[0], built[1], built[2], grids, eps=float(cfg.eps),
            r_s=float(r_s), r_cut=float(r_cut), split=cfg.force_split,
            softening=cfg.softening_kernel, S=S, scale=float(nmesh / box),
            **geo)
        k3.append(read_back(plane_out, built[5], 3))
    report("K3", k3[0], k3[1], sc)
    whole = [p3m_acc(pos, mass, box, nmesh, shortrange="supercell",
                     capacity=ck, window=w, **kw)[0] for ck, w in sc]
    report("supercell force", whole[0], whole[1], sc)
    # K4 on the columns tier
    col = cfg.replace(shortrange="columns")
    cc = knobs_of(col)
    k4 = [p3m_acc(pos, mass, box, nmesh, shortrange="columns", capacity=ck,
                  window=w, part="short", **kw)[0] for ck, w in cc]
    report("K4", k4[0], k4[1], cc)
    # K5 on a plan frozen at a rung state, at the rung tier's geometry
    if k5 is None:
        rung = cfg.replace(rungs=3)
        grown, _ = prewarm_capacity(rung, rung, pos)
        g = torch.Generator().manual_seed(5)
        act = (torch.rand(pos.shape[0], generator=g) < 0.125).to(pos.device)
        k5 = (pos, mass, act, grown)
    p5, m5, act, grown = k5
    got, k5_knobs = [], []
    base_ck = column_knobs(grown, grown)[1]
    for mult in (1, 2):
        _, r_s5, r_cut5, ncell5, ck5, w5, skin = _frozen_geometry(
            grown.replace(column_capacity=mult * base_ck,
                          column_window=0 if mult > 1
                          else grown.column_window))
        plan = freeze_column_plan(p5, m5, box, r_cut5, ncell5, ck5, w5,
                                  skin=skin)
        acc, _ = p3m_short_columns_frozen_masked(
            p5, m5, act, plan, box, float(cfg.eps), r_s5, r_cut5, G,
            ncell=ncell5, col_capacity=ck5, window=w5,
            split=cfg.force_split, softening=cfg.softening_kernel)
        got.append(acc[act])
        k5_knobs.append((ck5, w5))
    report("K5", got[0], got[1], k5_knobs)
    # K6 on the cells tier
    cells = cfg.replace(shortrange="cells")
    cap = prewarm_capacity(cells, cells, pos)[0].cell_capacity
    k6 = [p3m_acc(pos, mass, box, nmesh, shortrange="cells", capacity=k,
                  part="short", **kw)[0] for k in (cap, 2 * cap)]
    report("K6", k6[0], k6[1], [cap, 2 * cap])
    return lines


def main(root: str, out: str, cpu: bool = False) -> list:
    sys.path.insert(0, root)
    import torch

    if not (cpu or torch.cuda.is_available()):
        raise SystemExit("torch_capacity_bits: no CUDA GPU")
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import realize_ics

    card = "cpu" if cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; package {root}", flush=True)
    cfg = SimulationConfig(n_side=16 if cpu else 64, box=500.0,
                           pm_grid=32 if cpu else 128, n_steps=142,
                           softening_kernel="spline", shortrange="supercell",
                           output=OutputConfig(snapshot=False))
    ics = realize_ics(cfg, 0, device="cpu" if cpu else "cuda")
    lines = [dict(line, root=root)
             for line in capacity_checks(cfg, ics.pos, ics.mass, card)]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(lines, f, indent=1)
    return lines


if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--out", default=os.path.join(here, "output",
                                                  "capacity_bits.json"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    main(os.path.abspath(args.root), args.out, args.cpu)
