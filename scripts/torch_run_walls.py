"""Wall time of the runs that K1, the column kernels and K6 carry, for one
checkout of the port: two checkouts timed in one call can be set side by
side.

    python scripts/torch_run_walls.py [--root DIR] [--tag NAME]
        [--repeat 2] [--runs a,b] [--out PATH]

Imports ``nbody_torch`` from ``--root`` (default: this checkout), which
builds its kernels there, and runs through ``run_simulation`` with no
device argument and no snapshot: the default ``SimulationConfig()``
(``default``: 32^3, the dense tier, K1 at the P3M site, ``chip_smoke.py``
[5]) and its ``solver='pp'`` run (``default-pp``: K1 at the Ewald site,
[16]); and the runs of [9], [13], [19](c) and [20](d) that launch K3 and
K5: cfg64 (64^3 particles, box 500 Mpc, mesh 128, 142 steps, spline
softening; the supercell tier), cfg64 with ``rungs=3``, and both with
``devices=4`` (four slab shards on the card); and the runs that launch K6:
the default config with ``rungs=3`` ([12], the two-plane form), with
``devices=4`` ([19](c), the slab site), with ``devices=4, rungs=3,
column_skin=0`` ([20](d), the masked slab site) and cfg64 through the
replicated-grid P3M on four shards ([21](b): ``run_cosmological_checked``
in the driver's stretches, the capacity doubled on overflow; its ICs made
before the wall).  ``--runs`` picks some of them (default: all), each run
``--repeat`` times in turn (the first round also pays the process's
warm-up: cuFFT plans, the allocator).  Prints each run's wall (the
result's ``wall_s``), steps/s and the K1, K3, K5 and K6 launches, and
appends one JSON line to ``--out`` (default ``output/run_walls.jsonl``).

``--profile`` then runs each named run once more under ``torch.profiler``
(CPU and CUDA activity; the profiler slows the host, so that run's wall
is not one of the walls) and prints its device time and kernel count by
family: K1 (``k1_*``), K2 (``deposit_*`` and the memsets), K3
(``fused_kernel``), the FFTs (cuFFT's kernels), ``index_add_`` (the
deposits' integer sums, ``scatter_sum``) and the rest, with the device's
busy time; two checkouts profiled in one call attribute a change of wall
to the families whose time or launches moved.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sharded_p3m_run(cfg, state):
    """``cfg``'s steps from ``state`` through the replicated-grid P3M on
    four shards of the card, in the driver's stretches, a stretch that
    drops force re-run at twice the capacity.  Returns (the final state,
    its wall in seconds)."""
    import time

    import torch
    from nbody_torch.distributed.sharding import (
        device_mesh,
        make_sharded_p3m_cosmo_force,
        sharded_p3m_geometry,
    )
    from nbody_torch.driver.simulate import HEAL_ATTEMPTS, SAMPLE_EVERY_STEPS
    from nbody_torch.integrate.cosmo_stepping import (
        log_a_steps,
        run_cosmological_checked,
    )
    from nbody_torch.mesh.cells import cell_capacity

    group = device_mesh(4)
    cosmo = cfg.cosmology()
    cap = cell_capacity(cfg.n_particles,
                        sharded_p3m_geometry(cfg.box, cfg.mesh_size, 4)[2])
    a_grid = log_a_steps(cfg.a_begin, cfg.a_end, cfg.n_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i0 in range(0, cfg.n_steps, SAMPLE_EVERY_STEPS):
        a_seg = a_grid[i0:i0 + SAMPLE_EVERY_STEPS + 1]
        for _ in range(HEAL_ATTEMPTS):
            fn = make_sharded_p3m_cosmo_force(
                cosmo, cfg.box, cfg.mesh_size, group, eps=cfg.eps,
                split=cfg.force_split, softening=cfg.softening_kernel,
                capacity=cap, checked=True)
            new, ov = run_cosmological_checked(state, cosmo, a_seg, fn,
                                               cfg.box)
            if ov == 0:
                break
            cap *= 2
        state = new
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


#: kernel families of --profile: (name, substrings of the kernel's name)
FAMILIES = (("K1", ("k1_",)), ("K2", ("deposit_", "memset")),
            ("K3", ("fused_kernel",)), ("FFT", ("fft",)),
            ("index_add_", ("index",)))


def profile_run(cfg, work: str) -> dict:
    """One ``run_simulation`` of ``cfg`` under ``torch.profiler``: its
    wall, the device's busy time and {family: [ms, kernels]}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nbody_torch.driver.simulate import run_simulation

    shutil.rmtree(work, ignore_errors=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run_simulation(cfg, 0, work).wall_s
        torch.cuda.synchronize()
    fam = {name: [0.0, 0] for name, _ in FAMILIES + (("other", ()),)}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        key = ev.key.lower()
        name = next((n for n, subs in FAMILIES
                     if any(sub in key for sub in subs)), "other")
        fam[name][0] += us / 1e3
        fam[name][1] += ev.count
    return dict(wall_s=wall, busy_ms=sum(v[0] for v in fam.values()),
                kernels=sum(v[1] for v in fam.values()), families=fam)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--runs", default=None,
                    help="comma-separated run names (default: all)")
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "run_walls.jsonl"))
    ap.add_argument("--profile", action="store_true",
                    help="then one profiled run each: device time by "
                         "kernel family")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_run_walls: needs a CUDA card")
    import nbody_torch
    from nbody_torch._kernels import load_library
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import realize_ics, run_simulation
    from nbody_torch.forces.p3m import p3m_short_acc, run_cell_plane
    from nbody_torch.forces.p3m_columns import run_column_plane_masked
    from nbody_torch.forces.pm_supercell import run_fused_column_plane

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    load_library()  # the build is set-up, outside every wall
    print(f"{args.tag}: nbody_torch from {os.path.dirname(nbody_torch.__file__)}"
          f"; card {card}", flush=True)
    cfg64 = SimulationConfig(n_side=64, box=500.0, pm_grid=128, n_steps=142,
                             softening_kernel="spline",
                             output=OutputConfig(snapshot=False))
    default = SimulationConfig(output=OutputConfig(snapshot=False))
    runs = {"default": default, "default-pp": default.replace(solver="pp"),
            "cfg64": cfg64, "cfg64-rungs3": cfg64.replace(rungs=3),
            "cfg64-d4": cfg64.replace(devices=4),
            "cfg64-d4-rungs3": cfg64.replace(devices=4, rungs=3),
            "default-rungs3": default.replace(rungs=3),
            "default-d4": default.replace(devices=4),
            "default-d4-rungs3-cells": default.replace(devices=4, rungs=3,
                                                       column_skin=0.0),
            "cfg64-sharded-p3m4": cfg64}
    if args.runs:
        runs = {name: runs[name] for name in args.runs.split(",")}
    work = os.path.join(ROOT, "output", "run_walls")
    walls = {name: [] for name in runs}
    for rep in range(args.repeat):
        for name, cfg in runs.items():
            shutil.rmtree(work, ignore_errors=True)
            p3m_short_acc.launches = 0
            run_fused_column_plane.launches = 0
            run_column_plane_masked.launches = 0
            run_cell_plane.launches = 0
            if name == "cfg64-sharded-p3m4":
                wall = sharded_p3m_run(cfg, realize_ics(cfg, 0))[1]
            else:
                wall = run_simulation(cfg, 0, work).wall_s
            walls[name].append(wall)
            print(f"{args.tag} {name} (round {rep + 1}): {cfg.n_steps} steps "
                  f"in {wall:.3f} s ({cfg.n_steps / wall:.2f} steps/s); K1 "
                  f"launches {p3m_short_acc.launches}, K3 launches "
                  f"{run_fused_column_plane.launches}, K5 launches "
                  f"{run_column_plane_masked.launches}, K6 launches "
                  f"{run_cell_plane.launches}", flush=True)
    profiles = {}
    for name, cfg in runs.items() if args.profile else ():
        if name == "cfg64-sharded-p3m4":
            continue
        prof = profiles[name] = profile_run(cfg, work)
        fams = "; ".join(f"{f} {ms:.3f} ms ({k})" for f, (ms, k)
                         in prof["families"].items())
        print(f"{args.tag} {name} profiled: wall {prof['wall_s']:.3f} s, "
              f"device busy {prof['busy_ms']:.3f} ms in {prof['kernels']} "
              f"kernels: {fams}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                            "walls_s": walls, "profiles": profiles}) + "\n")


if __name__ == "__main__":
    main()
