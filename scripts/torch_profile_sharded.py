"""Where the time of the torch port's block-sharded forces goes, and how far
the replicated-grid P3M run's P(k) spreads: four shards on one GPU.

    python scripts/torch_profile_sharded.py

Prints:

* the card's name and power limit (nvidia-smi);
* cfg64 (64^3 particles, box 500 Mpc, mesh 128, 142 steps, spline
  softening) on one device's cells tier twice and through the checked
  replicated-grid P3M (``chip_smoke.py`` [21](b), capacity healed by
  doubling) twice, and every pair of the four P(k) at a = 1 in the bands
  of ``chip_smoke.py``'s DOMAIN_PK_BANDS (k up to k_Nyq/8, /4, /2);
* the replicated-grid force against one device's cells tier at the cells
  run's final state (a = 1), per particle;
* one replicated-grid evaluation at that state cut into stages timed
  with CUDA events (median of 10): the far field (the shards' deposits,
  their psum, four replicated solves and gathers), the all_gather, the
  four whole-plane builds, the four slab slices, the four K6 launches,
  and the whole evaluation;
* the ring Ewald force at the default 32^3 ICs: its real-space ring (16
  blocks of 8,192 x 8,192 pairs in torch ops), the whole evaluation, and
  one device's Ewald force (K1 + the k-space sum).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from nbody_torch.core import units  # noqa: E402
from nbody_torch.distributed import sharding as ts  # noqa: E402
from nbody_torch.driver import OutputConfig, SimulationConfig  # noqa: E402
from nbody_torch.driver.simulate import realize_ics, run_simulation  # noqa: E402
from nbody_torch.forces.ewald import ewald_pp_acc  # noqa: E402
from nbody_torch.forces.p3m import (  # noqa: E402
    build_padded_plane,
    p3m_acc,
    run_cell_plane,
)

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "output", "profile_sharded")
D = 4


def stage_ms(fn, reps: int = 10) -> float:
    """Median device time of ``fn()`` over ``reps`` calls after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def spread(cfg64, ics64):
    """The four runs' P(k) against each other; returns the last cells
    run's final state."""
    cells64 = cfg64.replace(shortrange="cells")
    pk, res = {}, None
    for i in range(2):
        res = run_simulation(cells64, 0, os.path.join(OUT, f"cells{i}"))
        pk[f"cells{i}"] = res.powerspecs[0]
        print(f"cells run {i}: {res.wall_s:.3f} s", flush=True)
    for i in range(2):
        cs.OUT = os.path.join(OUT, f"sharded{i}")
        cs.sharded_p3m_run(cfg64, ics64, pk["cells0"])
        pk[f"sharded{i}"] = os.path.join(cs.OUT, "cfg64_sharded_p3m",
                                         "powerspec_a=1.00")
    for a, b in (("cells1", "cells0"), ("sharded1", "sharded0"),
                 ("sharded0", "cells0"), ("sharded1", "cells1"),
                 ("sharded0", "cells1"), ("sharded1", "cells0")):
        bands = cs.pk_bands(pk[a], pk[b], cfg64, a)
        print(f"P(k) {a} vs {b}: max rel {cs.bands_text(bands)}", flush=True)
    return res.state, res.config_run.cell_capacity


def sharded_stages(cfg64, st, cap) -> None:
    """One replicated-grid evaluation at ``st`` by stage, at the first
    capacity doubled from ``cap`` at which its plane drops nothing."""
    group = ts.device_mesh(D)
    box, nmesh = cfg64.box, cfg64.mesh_size
    r_s, r_cut, ncell, nxl = ts.sharded_p3m_geometry(box, nmesh, D)
    while int(build_padded_plane(st.pos, st.mass, box, r_cut, ncell,
                                 cap)[1]):
        cap *= 2
    fn = cs.sharded_p3m_fn(cfg64, group, capacity=cap, checked=True)
    g, ov = fn(st.pos, st.mass, 1.0)
    ref, ov1 = p3m_acc(st.pos, st.mass, box, nmesh, G=units.COSMO.G,
                       eps=cfg64.eps, shortrange="cells",
                       split=cfg64.force_split,
                       softening=cfg64.softening_kernel, capacity=cap,
                       with_overflow=True)
    rel = (g.double() - ref.double()).norm(dim=1) / ref.double().norm(dim=1)
    print(f"replicated-grid force vs one device's cells tier at a = 1 "
          f"(capacity {cap}, overflow {int(ov)} / {int(ov1)}): per particle "
          f"median {float(rel.median()):.3e}, max {float(rel.max()):.3e}",
          flush=True)

    pos_l = ts._blocks(st.pos, group)
    mass_l = ts._blocks(st.mass, group)
    pm_of = ts._pm_modules(group, box, nmesh, cfg64.deconvolve_p,
                           cfg64.pm_gradient, st.pos.dtype,
                           spline_split=r_cut)
    amp = 1.5 * cfg64.cosmology().Omega_m * cfg64.cosmology().H0**2
    planes = [build_padded_plane(st.pos, st.mass, box, r_cut, ncell, cap)
              for _ in range(D)]
    K = planes[0][2]
    local = [ts.slice_plane(p[0], p[4], d=d, nxl=nxl, ncell=ncell, K=K)
             for d, p in enumerate(planes)]
    kw = dict(nx=nxl, ncell=ncell, K=K, eps2=cfg64.eps**2, r_s=r_s,
              r_cut=r_cut, split=cfg64.force_split,
              softening=cfg64.softening_kernel)
    stages = {
        "far field (4 deposits, psum, 4 solves and gathers)":
            lambda: ts._far_field(pos_l, mass_l, group, pm_of, amp),
        "all_gather": lambda: (group.all_gather(pos_l),
                               group.all_gather(mass_l)),
        "4 whole-plane builds": lambda: [
            build_padded_plane(st.pos, st.mass, box, r_cut, ncell, cap)
            for _ in range(D)],
        "4 slab slices": lambda: [
            ts.slice_plane(p[0], p[4], d=d, nxl=nxl, ncell=ncell, K=K)
            for d, p in enumerate(planes)],
        "4 K6 launches": lambda: [run_cell_plane(lp, lc, **kw)
                                  for lp, lc in local],
        "the whole evaluation": lambda: fn(st.pos, st.mass, 1.0),
    }
    for name, f in stages.items():
        print(f"  {name}: {stage_ms(f):.3f} ms", flush=True)


def ring_ewald_stages() -> None:
    """The ring Ewald force at the default 32^3 ICs by stage."""
    cfg = SimulationConfig(solver="pp", output=OutputConfig(snapshot=False))
    st = realize_ics(cfg, 0)
    box, G = cfg.box, units.COSMO.G
    group = ts.device_mesh(D)
    ring = ts.make_ring_ewald_acc_fn(group, box, cfg.eps, G=G,
                                     softening=cfg.softening_kernel)
    posw = [torch.remainder(p, box) for p in ts._blocks(st.pos, group)]
    mass_l = ts._blocks(st.mass, group)
    wfn = ts._weight_fn("gaussian", cfg.softening_kernel)
    r_s = box / 16.0

    def real_space():
        for d in range(D):
            for h in range(D):
                ts._real_space_block(posw[d], posw[(d - h) % D],
                                     mass_l[(d - h) % D], box, cfg.eps**2,
                                     r_s, 0.4999 * box, wfn)

    print("ring Ewald at the 32^3 ICs:", flush=True)
    for name, f in (
            ("real-space ring (16 blocks)", real_space),
            ("the whole evaluation", lambda: ring(st.pos, st.mass)),
            ("one device's ewald_pp_acc", lambda: ewald_pp_acc(
                st.pos, st.mass, box, eps=cfg.eps, G=G,
                softening=cfg.softening_kernel))):
        print(f"  {name}: {stage_ms(f, 5):.3f} ms", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_sharded: needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    cfg64 = SimulationConfig(n_side=64, box=500.0, pm_grid=128, n_steps=142,
                             softening_kernel="spline",
                             output=OutputConfig(snapshot=False))
    ics64 = realize_ics(cfg64, 0)
    st, cap = spread(cfg64, ics64)
    sharded_stages(cfg64, st, cap)
    ring_ewald_stages()


if __name__ == "__main__":
    main()
