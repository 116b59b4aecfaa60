"""Quickest proof that the torch port runs its main path on one GPU.

    python3 chip_smoke.py

Phases, each on a line of its own; the first that fails raises and the
script exits non-zero:

1. a CUDA card is present; print its name and power limit;
2. build the CUDA kernel library from the sources in this checkout;
3. K1 (the dense short-range P3M kernel) against its plain PyTorch
   version in float64, on the card, at the default run's shape
   (N = 32,768, box 500 Mpc, mesh 64), for all four split x softening
   variants, with both times;
4. the wrapper's argument checks raise on the card;
5. the default ``SimulationConfig()`` run (32^3 particles, P3M, 142 steps)
   through ``nbody_torch.driver.simulate.run_simulation`` on "cuda", with
   K1's launch count, wall time and steps/s (no snapshot: it needs h5py);
6. the 16^3 run from the JAX package's committed white noise, whose P(k)
   at a = 1 must match the JAX package's committed P(k).

The line before the last is a JSON object of the kernels on the path;
the last line is ``{"ok": true, "device": {...}}``.  Run outputs go to
``output/chip_smoke/`` (git-ignored).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "output", "chip_smoke")
PORT_DATA = os.path.join(ROOT, "tests", "data", "torch_port")

# K1 against its float64 plain version: relative L2 error over all
# targets.  float32 positions, r^2 and rsqrtf (2 ulp) with ~100 pairs
# inside r_cut per target give a few 1e-7..1e-6; 1e-4 leaves room for
# the pairs' partial cancellation while catching a wrong pair set or
# weight (a single missing neighbour is an O(1e-2) error).
K1_REL_L2_TOL = 1e-4
# 16^3 run from the JAX noise: float32 on the card against the JAX
# package's float32 CPU run over 142 steps, bin by bin for
# k <= k_Nyquist/2 of the PM mesh.  The two agree to a few 1e-6 (on a
# CPU and on the card); 1e-3 leaves that two orders of magnitude for
# summation order (atomic CIC deposits, cuFFT) while a wrong force,
# step or measurement moves P(k) by far more.
PK_REL_TOL = 1e-3


def phase(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from nbody_torch import _kernels
    from nbody_torch.core import units
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import realize_ics, run_simulation
    from nbody_torch.forces.p3m import (
        p3m_short_acc,
        p3m_short_params,
        p3m_short_plain,
    )

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    phase(f"[1] card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    _kernels.load_library()
    phase(f"[2] kernel library {os.path.basename(_kernels.build_info['path'])}"
          f" {'built' if _kernels.build_info['built'] else 'loaded'} in "
          f"{time.perf_counter() - t0:.2f} s")

    # -- 3. K1 against its plain version at the main path's shape ---------
    cfg = SimulationConfig()
    n, box = cfg.n_particles, cfg.box
    r_s, r_cut, _, _ = p3m_short_params(box, cfg.mesh_size, n)
    G = units.COSMO.G
    # uniform random positions (no lattice cancellation to hide behind)
    # with the default run's particle masses
    gen = torch.Generator().manual_seed(1)
    pos = (torch.rand((n, 3), generator=gen, dtype=torch.float64)
           * box).to(dev, torch.float32)
    mass = realize_ics(cfg, 0, device=dev).mass
    main_variant = (cfg.force_split, cfg.softening_kernel)
    k1 = {}
    for split in ("gaussian", "spline"):
        for soft in ("plummer", "spline"):
            args = (box, cfg.eps, r_s, r_cut, G, split, soft)
            got = p3m_short_acc(pos, mass, *args)
            torch.cuda.synchronize()
            ref = p3m_short_plain(pos.double(), mass.double(), *args)
            rel = float((got.double() - ref).norm() / ref.norm())
            max_abs = float((got.double() - ref).abs().max())
            ms = cuda_time_ms(lambda: p3m_short_acc(pos, mass, *args), 50)
            plain_ms = cuda_time_ms(
                lambda: p3m_short_plain(pos, mass, *args), 3)
            phase(f"[3] K1 {split}/{soft}: rel L2 {rel:.3e} (tol "
                  f"{K1_REL_L2_TOL:g}), max abs {max_abs:.3e}; kernel "
                  f"{ms:.4f} ms, plain float32 {plain_ms:.3f} ms")
            if not rel <= K1_REL_L2_TOL:
                raise AssertionError(f"K1 {split}/{soft} disagrees: {rel}")
            k1[(split, soft)] = (max_abs, ms, plain_ms)

    # -- 4. the wrapper refuses what the kernel does not take -------------
    bad = {
        "float64": (pos.double(), mass.double()),
        "non-contiguous": (pos.T.contiguous().T, mass),
        "shape": (pos[:, :2].contiguous(), mass),
    }
    for what, (p_bad, m_bad) in bad.items():
        try:
            p3m_short_acc(p_bad, m_bad, box, cfg.eps, r_s, r_cut, G)
        except (TypeError, ValueError):
            continue
        raise AssertionError(f"p3m_short_acc accepted a {what} input")
    phase(f"[4] wrapper checks raise for: {', '.join(bad)}")

    # -- 5. the default run through the entry point -----------------------
    run_cfg = cfg.replace(output=OutputConfig(snapshot=False))
    work = os.path.join(OUT, "default")
    shutil.rmtree(work, ignore_errors=True)
    p3m_short_acc.launches = 0
    res = run_simulation(run_cfg, 0, work, device="cuda")
    launches = p3m_short_acc.launches
    st = res.state
    finite = all(bool(torch.isfinite(t).all())
                 for t in (st.pos, st.vel, st.mass))
    phase(f"[5] default run: N={run_cfg.n_particles} mesh "
          f"{run_cfg.mesh_size} {run_cfg.n_steps} steps in {res.wall_s:.3f} s"
          f" ({run_cfg.n_steps / res.wall_s:.2f} steps/s); K1 launches "
          f"{launches}; a = {float(st.time):.4f}")
    with open(os.path.join(work, "run.log")) as f:
        for line in f:
            phase("    run.log: " + line.rstrip())
    if not finite or st.pos.shape != (run_cfg.n_particles, 3):
        raise AssertionError("final state is not finite (N, 3)")
    if abs(float(st.time) - run_cfg.a_end) > 1e-6:
        raise AssertionError(f"run ended at a = {float(st.time)}")
    if launches != run_cfg.n_steps + 1:
        raise AssertionError(
            f"K1 launched {launches} times, expected {run_cfg.n_steps + 1}")
    if len(res.powerspecs) != 1 or not os.path.exists(res.powerspecs[0]):
        raise AssertionError("no powerspec file written")
    pk = np.loadtxt(res.powerspecs[0])
    if pk.ndim != 2 or pk.shape[1] != 5 or not np.all(np.isfinite(pk)) \
            or not np.all(pk[:, 2] > 0):
        raise AssertionError("powerspec file is not finite positive P(k)")

    # -- 6. parity with the JAX package through committed data ------------
    par_cfg = SimulationConfig(n_side=16, output=OutputConfig(snapshot=False))
    noise = np.load(os.path.join(PORT_DATA, "white_noise_n16_seed0.npy"))
    ref_pk = np.loadtxt(os.path.join(PORT_DATA,
                                     "powerspec_a=1.00_n16_seed0"))
    work16 = os.path.join(OUT, "n16")
    shutil.rmtree(work16, ignore_errors=True)
    state16 = realize_ics(par_cfg, 0, device="cuda", noise=noise)
    res16 = run_simulation(par_cfg, 0, work16, device="cuda",
                           initial_state=state16)
    got_pk = np.loadtxt(res16.powerspecs[0])
    k_half = 0.5 * np.pi * par_cfg.mesh_size / par_cfg.box
    m = ref_pk[:, 0] <= k_half
    # same bins: equal mode counts, and bin-mean k equal to float32
    # summation order
    if got_pk.shape != ref_pk.shape or not np.array_equal(
            got_pk[:, 1], ref_pk[:, 1]) or not np.allclose(
            got_pk[:, 0], ref_pk[:, 0], rtol=1e-5):
        raise AssertionError("16^3 P(k) bins differ from the JAX run's")
    rel_pk = np.abs(got_pk[m, 2] / ref_pk[m, 2] - 1.0)
    phase(f"[6] 16^3 from the JAX noise: P(k) vs JAX at {int(m.sum())} bins "
          f"k <= {k_half:.4f}/Mpc: max rel {rel_pk.max():.3e} (tol "
          f"{PK_REL_TOL:g}); run {res16.wall_s:.3f} s")
    if not rel_pk.max() <= PK_REL_TOL:
        raise AssertionError(f"16^3 P(k) differs from JAX: {rel_pk.max()}")

    max_abs, ms, plain_ms = k1[main_variant]
    print(json.dumps({"kernels": [{
        "name": "p3m_short_acc",
        "route": "cuda",
        "source": "nbody_torch/forces/csrc/p3m_short.cu",
        "replaces": "nbody/forces/p3m.py:194",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
