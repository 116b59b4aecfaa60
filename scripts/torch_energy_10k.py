"""|dE/E| over 10,000 KDK steps of a Plummer sphere on the GPU, through the
torch port's all-pairs kernel (K7).

The energy protocol of ``scripts/energy_10k.py``: ``systems.plummer(N,
seed=0)`` (float32, N = 262,144 by default) integrated with
``run_with_diagnostics(state, dt=1e-3, 10,000 steps, allpairs_pallas(eps=
0.05), diag_every=25)`` in one loop: one force evaluation per step plus
one at the start, the softened-consistent energy sampled every 25 steps.
Writes the measured drift, the wall time, ms per step, K7's launches and
the card's name and power limit (``nvidia-smi``) to a JSON file with the
keys of ``tests/data/energy_10k.json`` and those.

Usage (on a machine with a CUDA GPU):

    python scripts/torch_energy_10k.py [--n 262144] [--steps 10000]
        [--out tests/data/torch_port/energy_10k_h100.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE_EVERY = 25


def main(n: int, n_steps: int, out: str, dt: float = 1e-3,
         eps: float = 0.05) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("torch_energy_10k: no CUDA GPU")
    from nbody_torch._kernels import load_library
    from nbody_torch.forces.pallas_pp import allpairs_pallas, block_acc_pallas
    from nbody_torch.ic import systems
    from nbody_torch.integrate.leapfrog import run_with_diagnostics

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)
    load_library()
    state = systems.plummer(n, seed=0)
    torch.cuda.synchronize()

    def acc_fn(p, m):
        return allpairs_pallas(p, m, eps=eps)

    allpairs_pallas.launches = block_acc_pallas.launches = 0
    t0 = time.perf_counter()
    final, d0, diags = run_with_diagnostics(state, dt, n_steps, acc_fn,
                                            diag_every=SAMPLE_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = allpairs_pallas.launches
    e = np.concatenate([[float(d0.e_kin + d0.e_pot)],
                        (diags.e_kin + diags.e_pot).double().cpu().numpy()])
    mom = diags.momentum.double().cpu().numpy()
    drift = np.abs(e - e[0]) / abs(e[0])
    for k in range(0, len(drift), max(1, len(drift) // 10)):
        print(f"step {k * SAMPLE_EVERY:6d}  E = {e[k]:.8f}  |dE/E| = "
              f"{drift[k]:.3e}", flush=True)
    result = {
        "config": f"Plummer N={n}, dt={dt}, eps={eps}, f32, all-pairs CUDA "
                  f"kernel (K7, nbody_torch/forces/csrc/pp_allpairs.cu), "
                  f"{n_steps} KDK steps",
        "n": n,
        "n_steps": n_steps,
        "dt": dt,
        "eps": eps,
        "E0": float(e[0]),
        "E_final": float(e[-1]),
        "abs_dE_over_E_max": float(drift.max()),
        "target": 1e-4,
        "met": bool(drift.max() < 1e-4),
        "wall_s": wall,
        "energies_every_steps": SAMPLE_EVERY,
        "sample_stride_steps": SAMPLE_EVERY,
        "momentum_final": [float(x) for x in mom[-1]],
        "momentum_max_abs": float(np.abs(mom).max()),
        "ms_per_step": 1e3 * wall / n_steps,
        "k7_launches": launches,
        "interactions_per_s": float(n) * n * launches / wall,
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "energies": [float(x) for x in e],
    }
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in (
        "n", "n_steps", "abs_dE_over_E_max", "met", "wall_s", "ms_per_step",
        "k7_launches", "card")}), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_port", "energy_10k_h100.json"))
    args = ap.parse_args()
    main(args.n, args.steps, args.out)
