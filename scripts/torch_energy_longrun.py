"""Long-horizon Layzer-Irvine conservation on the production P3M rung tier,
through the torch port's driver on the GPU.

The protocol of ``scripts/energy_longrun.py`` (which never finished on the
TPU): N = 102^3 particles in a 500 Mpc box, mesh 128, P3M with the spline
split and spline softening, ``rungs=3``, 2,000 fixed global steps from
a = 0.02 to 1, column capacity 7,424 and window 4,096 (the JAX run's
pre-warm), ``energy_log`` on, through ``run_simulation``: frozen column
plans, the fused boundary ticks, the capacity pre-warms and heals.  The
driver samples the peculiar energies (T, W) at every segment
(``nbody_torch/diagnostics/layzer_irvine.py``); the script bounds
max |C(a) - C(a0)| / max |W| of the conserved functional
C = T + W + int (2T + W) dln a over those samples, and the same over each
prefix of them.

Each sample is also written to ``<workdir>/samples.txt`` as it is taken,
so that a run cut by ``--budget-s`` (or by a time limit) still reports
where it got: the JSON then says ``"finished": false`` and gives the
steps reached.  Writes ``tests/data/torch_port/energy_longrun_h100.json``
(``--out``) with the residual, the samples, steps reached, wall, heals
(run.log lines that re-ran a segment), and the card's name and power
limit (``nvidia-smi``).

Usage (on a machine with a CUDA GPU):

    python scripts/torch_energy_longrun.py [--n-side 102] [--steps 2000]
        [--budget-s 2400] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


class OutOfBudget(Exception):
    pass


def main(n_side: int, n_steps: int, budget_s: float, out: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("torch_energy_longrun: no CUDA GPU")
    from nbody_torch.diagnostics.layzer_irvine import layzer_irvine_residual
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver import simulate
    from nbody_torch.integrate.cosmo_stepping import log_a_steps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    cfg = SimulationConfig(
        n_side=n_side, box=500.0,
        pm_grid=128 if n_side >= 64 else 2 * n_side, solver="p3m",
        softening_kernel="spline", rungs=3, a_begin=0.02, a_end=1.0,
        n_steps=n_steps,
        column_capacity=7424 if n_side >= 64 else 0,
        column_window=4096 if n_side >= 64 else 0,
        output=OutputConfig(snapshot=False, powerspec=False,
                            snapshot_times=(), energy_log=True))
    work = os.path.join(ROOT, "output", "energy_longrun")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    samples_path = os.path.join(work, "samples.txt")
    samples = []
    sample_energies = simulate.peculiar_energies

    def recorded(state, cosmo, box, nmesh):
        T, W = sample_energies(state, cosmo, box, nmesh)
        samples.append((float(state.time), float(T), float(W),
                        time.perf_counter() - t0))
        with open(samples_path, "a") as f:
            f.write("%.9g %.9g %.9g %.3f\n" % samples[-1])
        return T, W

    def stop(signum, frame):
        raise OutOfBudget()

    simulate.peculiar_energies = recorded
    signal.signal(signal.SIGALRM, stop)
    signal.signal(signal.SIGTERM, stop)
    signal.setitimer(signal.ITIMER_REAL, budget_s)
    t0 = time.perf_counter()
    finished, result = True, None
    try:
        result = simulate.run_simulation(cfg, seed=0, workdir=work)
        torch.cuda.synchronize()
    except OutOfBudget:
        finished = False
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        simulate.peculiar_energies = sample_energies
    wall = time.perf_counter() - t0
    with open(os.path.join(work, "run.log")) as f:
        lines = [line.rstrip() for line in f]
    heals = [line for line in lines if "re-running" in line]
    a_grid = log_a_steps(cfg.a_begin, cfg.a_end, cfg.n_steps)
    a_s, T_s, W_s = (np.asarray([s[i] for s in samples], np.float64)
                     for i in range(3))
    reached = int(np.argmin(np.abs(a_grid - a_s[-1]))) if samples else 0
    res = (layzer_irvine_residual(a_s, T_s, W_s) if len(samples) > 1
           else float("nan"))
    prefix = [layzer_irvine_residual(a_s[:k + 1], T_s[:k + 1], W_s[:k + 1])
              for k in range(1, len(samples))]
    out_json = {
        "config": (f"P3M rung tier: N={n_side}^3={n_side**3}, box=500, "
                   f"mesh={cfg.mesh_size}, rungs=3, spline split and "
                   f"softening, column capacity {cfg.column_capacity}, "
                   f"window {cfg.column_window}, a=0.02->1.0 in "
                   f"{n_steps} global steps, float32, "
                   f"nbody_torch run_simulation on the card"),
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "n": n_side**3,
        "n_steps": n_steps,
        "rungs": 3,
        "finished": finished,
        "steps_reached": n_steps if finished else reached,
        "a_reached": float(a_s[-1]) if samples else cfg.a_begin,
        "budget_s": budget_s,
        "n_samples": len(samples),
        "li_residual_max": res,
        "li_residual_prefix_max": prefix,
        "a_samples": [float(x) for x in a_s],
        "T_samples": [float(x) for x in T_s],
        "W_samples": [float(x) for x in W_s],
        "sample_wall_s": [round(s[3], 3) for s in samples],
        "heals": heals,
        "config_run_capacity": (
            None if result is None else
            {"column_capacity": result.config_run.column_capacity,
             "column_window": result.config_run.column_window,
             "rung_capacity": result.config_run.rung_capacity}),
        "stale_max": None if result is None else result.stale_max,
        "run_log_tail": lines[-12:],
        "wall_s": wall,
        "script": "scripts/torch_energy_longrun.py",
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(out_json, f, indent=1)
    print(json.dumps({k: out_json[k] for k in (
        "n", "finished", "steps_reached", "a_reached", "n_samples",
        "li_residual_max", "wall_s")}), flush=True)
    print(f"{len(heals)} segment re-runs; wrote {out}", flush=True)
    return out_json


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-side", type=int, default=102)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--budget-s", type=float, default=2400.0)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_port", "energy_longrun_h100.json"))
    a = ap.parse_args()
    main(a.n_side, a.steps, a.budget_s, a.out)
