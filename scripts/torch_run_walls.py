"""Wall time of the runs that K1 and the column kernels carry, for one
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
``devices=4`` (four slab shards on the card).  ``--runs`` picks some of
them (default: all), each run ``--repeat`` times in turn (the first round
also pays the process's warm-up: cuFFT plans, the allocator).  Prints each
run's wall (the result's ``wall_s``), steps/s and the K1, K3 and K5
launches, and appends one JSON line to ``--out`` (default
``output/run_walls.jsonl``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--runs", default=None,
                    help="comma-separated run names (default: all)")
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "run_walls.jsonl"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_run_walls: needs a CUDA card")
    import nbody_torch
    from nbody_torch._kernels import load_library
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import run_simulation
    from nbody_torch.forces.p3m import p3m_short_acc
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
            "cfg64-d4-rungs3": cfg64.replace(devices=4, rungs=3)}
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
            res = run_simulation(cfg, 0, work)
            walls[name].append(res.wall_s)
            print(f"{args.tag} {name} (round {rep + 1}): {cfg.n_steps} steps "
                  f"in {res.wall_s:.3f} s ({cfg.n_steps / res.wall_s:.2f} "
                  f"steps/s); K1 launches {p3m_short_acc.launches}, K3 "
                  f"launches {run_fused_column_plane.launches},"
                  f" K5 launches {run_column_plane_masked.launches}",
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                            "walls_s": walls}) + "\n")


if __name__ == "__main__":
    main()
