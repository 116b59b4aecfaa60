"""Where the time of the torch port's rung runs goes, on one GPU.

    python scripts/torch_profile_rungs.py [--config cfg64|default] [--out DIR]

Runs ``run_simulation`` with ``rungs=3`` twice in one process (the first
run builds the kernels and learns the capacities, the second is timed):
``cfg64`` (64^3 particles, box 500 Mpc, mesh 128, 142 steps, spline
softening: the supercell tier on frozen column plans, K2 + K3 at the
boundary ticks and K5 at the interior ticks) or the default 32^3 config
(K1 at the boundary ticks, K6 at the interior ticks).  The force closures
of the timed run are wrapped: CUDA events around each call, read after
the run, give the stream time of the boundary evaluations (fresh with a
new plan, frozen, or dense), of the interior masked evaluations and of
the plan refreezes; the rest of the wall time is the kicks, drifts, rung
assignment, plane gathers and the host.  Prints, and writes as JSON to
``--out`` (default ``output/``, git-ignored), with the card's name and
power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


class Timed:
    """Wraps a callable: a pair of CUDA events around each call."""

    def __init__(self, fn, events: list):
        self.fn, self.events = fn, events

    def __call__(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("cfg64", "default"), default="cfg64")
    ap.add_argument("--out", default="output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_rungs: no CUDA card")
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver import simulate as sim

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out_cfg = OutputConfig(snapshot=False)
    if args.config == "cfg64":
        cfg = SimulationConfig(n_side=64, box=500.0, pm_grid=128, n_steps=142,
                               softening_kernel="spline", rungs=3,
                               output=out_cfg)
    else:
        cfg = SimulationConfig(rungs=3, output=out_cfg)
    work = os.path.join(args.out, f"profile_rungs_{args.config}")
    shutil.rmtree(work, ignore_errors=True)
    sim.run_simulation(cfg, 0, work + "_warm")

    ev = {k: [] for k in ("boundary", "fresh_plan", "interior", "refreeze")}
    build_both, build_rungs = sim.build_cosmo_force_both, \
        sim.build_cosmo_force_rungs
    build_frozen = sim.build_cosmo_force_frozen_both

    def frozen_fns(c):
        fns = build_frozen(c)
        if fns is None:
            return None
        keys = ["refreeze", "boundary", None, "interior", None, "fresh_plan"]
        return tuple(f if k is None else Timed(f, ev[k])
                     for f, k in zip(fns, keys))

    sim.build_cosmo_force_rungs = lambda c: Timed(build_rungs(c),
                                                  ev["interior"])
    sim.build_cosmo_force_both = lambda c: Timed(build_both(c),
                                                 ev["boundary"])
    sim.build_cosmo_force_frozen_both = frozen_fns
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run_simulation(cfg, 0, work)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report = {"card": card, "config": args.config, "wall_s": wall,
              "run_wall_s": res.wall_s, "steps": cfg.n_steps}
    for key, pairs in ev.items():
        ms = [s.elapsed_time(e) for s, e in pairs]
        report[key] = {"calls": len(ms), "ms_total": sum(ms),
                       "ms_mean": sum(ms) / len(ms) if ms else None}
    with open(os.path.join(work, "run.log")) as f:
        report["run_log"] = [line.rstrip() for line in f
                             if "Rung stepping" in line
                             or "Time step  142" in line
                             or "re-running" in line]
    timed = sum(report[k]["ms_total"] for k in ev)
    report["other_ms"] = wall * 1e3 - timed
    print(card)
    print(json.dumps(report, indent=1))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_rungs_{args.config}.json"),
              "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
