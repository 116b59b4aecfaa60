"""Where the time of the torch port's 64^3 production run goes, on one GPU.

    python scripts/torch_profile_cfg64.py [--steps 16] [--out DIR]

The configuration is the parity study's at one subcycle (64^3 particles,
box 500 Mpc, mesh 128, 142 steps, spline softening; the supercell tier).
Prints, and writes as JSON to ``--out`` (default ``output/``, git-ignored):

* the card's name and power limit (nvidia-smi);
* the whole run through ``run_simulation`` in this process, its wall time
  split into set-up (kernel build, ICs, the first force) and steps;
* one force evaluation cut into its stages, each timed with CUDA events
  (median of 20): plane build, K2 deposit, the FFT Poisson solve, K3, the
  per-particle read-back;
* a ``torch.profiler`` window over ``--steps`` KDK steps at the final
  state: device time by kernel name and the device's busy share of the
  window's wall time.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def stage_times(state, cfg) -> dict:
    """Median CUDA-event ms of each stage of one supercell force eval."""
    from nbody_torch.forces.p3m import (
        auto_column_capacity,
        p3m_short_params,
        supercell_ncell,
    )
    from nbody_torch.forces.p3m_columns import (
        build_column_plane,
        column_window,
        plane_geometry,
        read_back,
    )
    from nbody_torch.forces.pm import pm_module
    from nbody_torch.forces.pm_supercell import (
        run_fused_column_plane,
        supercell_deposit_from_plane,
        supercell_geometry,
    )

    box, nmesh, n = cfg.box, cfg.mesh_size, cfg.n_particles
    r_s, r_cut, _, _ = p3m_short_params(box, nmesh, n)
    ncell = supercell_ncell(box, nmesh, r_cut)
    S, _ = supercell_geometry(nmesh, ncell)
    ck = cfg.column_capacity or auto_column_capacity(n, ncell)
    w = cfg.column_window or column_window(box, r_cut, ck)
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut, ck, w)
    pos, mass = state.pos, state.mass
    gaussian = cfg.force_split == "gaussian"
    pm = pm_module(box, nmesh, cfg.deconvolve_p, False,
                   r_s if gaussian else 0.0, 0.0 if gaussian else r_cut,
                   cfg.pm_gradient, 0.0, pos.device, torch.float32)
    mass_sum = torch.sum(mass)
    amp = 4.0 * math.pi * mass_sum / box**3
    kw = dict(ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
              chunk=chunk, eps=cfg.eps, r_s=r_s, r_cut=r_cut,
              split=cfg.force_split, softening=cfg.softening_kernel, S=S,
              scale=nmesh / box)
    got = {}

    def plane():
        got["p"] = build_column_plane(pos, mass, box, r_cut, ncell, CK, W,
                                       chunk=chunk)

    def deposit():
        p = got["p"]
        got["rho"] = supercell_deposit_from_plane(
            p[0], p[6], box=box, nmesh=nmesh, ncell=ncell, stride=stride,
            gz=gz)

    def solve():
        got["g"] = pm.force_grids_from_rho(got["rho"], amp, mass_sum)

    def fused():
        p = got["p"]
        got["out"] = run_fused_column_plane(p[0], p[1], p[2], got["g"],
                                             **kw)

    def readback():
        got["acc"] = read_back(got["out"], got["p"][5], 3)

    stages = {"plane build": plane, "K2 deposit": deposit,
              "FFT Poisson solve": solve, "K3 fused": fused,
              "read-back": readback}
    times = {k: [] for k in stages}
    for rep in range(21):
        for name, fn in stages.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            if rep:
                times[name].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in times.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default="output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_cfg64: no CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nbody_torch import _kernels
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import build_cosmo_force, run_simulation
    from nbody_torch.integrate.cosmo_stepping import kdk_steps, log_a_steps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = SimulationConfig(n_side=64, box=500.0, pm_grid=128, n_steps=142,
                           softening_kernel="spline",
                           output=OutputConfig(snapshot=False))
    report = {"card": card, "config": "cfg64 (64^3, box 500, mesh 128, "
              "142 steps, spline softening)"}

    t0 = time.perf_counter()
    _kernels.load_library()
    report["build_s"] = time.perf_counter() - t0
    work = os.path.join("output", "profile_cfg64")
    shutil.rmtree(work, ignore_errors=True)
    res = run_simulation(cfg, 0, work)
    with open(os.path.join(work, "run.log")) as f:
        log = [line.rstrip() for line in f]
    seg_s = sum(float(line.split(" in ")[1].split(" s)")[0])
                for line in log if line.startswith("Time step"))
    ic_s = next((float(line.split("(")[1].split(" s")[0]) for line in log
                 if line.startswith("Initial conditions")), 0.0)
    report["run"] = {"wall_s": res.wall_s, "ic_s": ic_s,
                     "segments_s": seg_s,
                     "steps_per_s_segments": cfg.n_steps / seg_s,
                     "config_run": {
                         "column_capacity": res.config_run.column_capacity,
                         "column_window": res.config_run.column_window},
                     "log": log}

    state = res.state
    cfg_run = res.config_run
    report["stages_ms_final_state"] = stage_times(state, cfg_run)

    acc_fn = build_cosmo_force(cfg_run, checked=True)
    a_grid = log_a_steps(0.5, 1.0, args.steps)
    st = state.replace(time=torch.as_tensor(0.5, device=state.pos.device))
    kdk_steps(st, cfg.cosmology(), a_grid[:3], acc_fn, cfg.box)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kdk_steps(st, cfg.cosmology(), a_grid, acc_fn, cfg.box)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    # device-side events only: an aten operator's row repeats the time
    # of the kernels it launched
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
    report["profile"] = {
        "steps": args.steps, "window_s": window_s,
        "device_busy_ms": busy_ms,
        "busy_share": busy_ms / (window_s * 1e3),
        "by_kernel_ms": [{"name": k[:90], "ms": ms, "calls": c}
                         for k, ms, c in rows[:25]],
    }

    print(f"card: {card}")
    r = report["run"]
    print(f"run: wall {r['wall_s']:.3f} s = build/ICs/first force + "
          f"segments {r['segments_s']:.3f} s (ICs {r['ic_s']:.2f} s); "
          f"{r['steps_per_s_segments']:.2f} steps/s over the segments; "
          f"healed {r['config_run']}")
    print("one force evaluation at the final state (median ms): "
          + ", ".join(f"{k} {v:.4f}"
                      for k, v in report["stages_ms_final_state"].items()))
    p = report["profile"]
    print(f"profile over {p['steps']} steps: window {p['window_s']:.3f} s, "
          f"device busy {p['device_busy_ms']:.2f} ms "
          f"({100 * p['busy_share']:.1f}%)")
    for row in p["by_kernel_ms"][:15]:
        print(f"  {row['ms']:9.3f} ms  {row['calls']:5d}  {row['name']}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_cfg64.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
