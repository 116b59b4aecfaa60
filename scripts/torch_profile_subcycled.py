"""Wall and device busy share of the subcycled runs on the card.

    python scripts/torch_profile_subcycled.py [--runs a,b] [--repeat 3]
                                              [--out PATH]

Runs through ``run_simulation`` with no device argument and no snapshot:
``cfg64-sub4`` (``scripts/parity_study.py``'s configuration: 64^3
particles, box 500 Mpc, mesh 128, 142 steps, spline softening,
``subcycles=4``, its P(k) options, the default transfer function; the
supercell tier, its interior subcycles on frozen column plans) and
``cfg64`` (the same without subcycles), ``default-sub4``
(``SimulationConfig()`` with ``subcycles=4``: the dense tier) and
``default``, and ``cfg64-d4-sub4-icdomain`` (cfg64-sub4 on four slab
shards of the card from the slab-resident ICs).  Each run goes once to
warm the process (cuFFT plans, the allocator, the kernel library, the
driver's healed capacities), ``--repeat`` times for the walls (each
printed, with their median and spread), then once more under
``torch.profiler`` with only the device's activity recorded: the
device's busy time (the device time of every kernel, memset and copy)
over that same run's own window gives the busy share, and the window
beside the median wall gives the profiler's cost.  Prints a line a run,
the kernels that take the most of the device, and appends one JSON
line to ``--out`` (default ``output/profile_subcycled.jsonl``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def configs() -> dict:
    from nbody_torch.driver import OutputConfig, SimulationConfig

    sub64 = SimulationConfig(
        n_side=64, box=500.0, solver="p3m", pm_grid=128, n_steps=142,
        softening_kernel="spline", subcycles=4,
        output=OutputConfig(snapshot=False, powerspec_bins=48,
                            powerspec_binning="concept",
                            realization_correction=True))
    default = SimulationConfig(output=OutputConfig(snapshot=False))
    return {
        "cfg64-sub4": sub64,
        "cfg64": sub64.replace(subcycles=1),
        "default-sub4": default.replace(subcycles=4),
        "default": default,
        "cfg64-d4-sub4-icdomain": sub64.replace(devices=4,
                                                ic_realization="domain"),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "output", "profile_subcycled.jsonl"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nbody_torch.driver.simulate import run_simulation

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    runs = configs()
    names = [x for x in args.runs.split(",") if x] or list(runs)
    report = {"card": card, "runs": {}}
    for name in names:
        cfg = runs[name]
        work = os.path.join(ROOT, "output", f"profile_subcycled_{name}")
        walls = []
        for _ in range(1 + args.repeat):
            shutil.rmtree(work, ignore_errors=True)
            walls.append(run_simulation(cfg, 0, work).wall_s)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prof_wall = run_simulation(cfg, 0, work).wall_s
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        rows = []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                rows.append((ev.key, dev_us / 1e3, ev.count))
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        with open(os.path.join(work, "run.log")) as f:
            summary = [x.rstrip() for x in f
                       if "stepping" in x or "re-running" in x]
        warm = walls[1:]
        med = float(np.median(warm))
        rec = {
            "first_wall_s": walls[0], "walls_s": warm, "median_wall_s": med,
            "steps_per_s": cfg.n_steps / med,
            "profiled_wall_s": prof_wall, "profiled_window_s": window_s,
            "device_busy_ms": busy_ms,
            "busy_share": busy_ms / (window_s * 1e3),
            "run_log": summary,
            "top_kernels": [{"name": k[:90], "ms": ms, "calls": c}
                            for k, ms, c in rows[:12]],
        }
        report["runs"][name] = rec
        print(f"{name}: first wall {walls[0]:.3f} s, walls "
              + " / ".join(f"{w:.3f}" for w in warm)
              + f" s (median {med:.3f}, spread {min(warm):.3f}-"
              f"{max(warm):.3f}; {rec['steps_per_s']:.2f} steps/s); "
              f"profiled run {window_s:.3f} s ({window_s / med:.2f}x the "
              f"median), device busy {busy_ms:.1f} ms = "
              f"{100 * rec['busy_share']:.1f}% of that run", flush=True)
        for line in summary:
            print(f"  run.log: {line}", flush=True)
        for r in rec["top_kernels"][:8]:
            print(f"  {r['ms']:9.2f} ms {r['calls']:6d} calls  {r['name']}",
                  flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(report) + "\n")


if __name__ == "__main__":
    main()
