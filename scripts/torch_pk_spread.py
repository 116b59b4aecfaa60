"""The float32 spread of the 64^3 run's P(k) at a = 1 on the GPU: how far
runs of the same ICs that differ only in rounding read from each other in
``chip_smoke.py``'s three bands of k (``DOMAIN_PK_BANDS``), beside the
slab domain run that [19] holds to those bands.

    python scripts/torch_pk_spread.py [--perturbed 3] [--out PATH]

cfg64 (64^3 particles, box 500 Mpc, mesh 128, 142 steps, spline
softening; the supercell tier) through ``run_simulation`` from its ICs:
the run, the run again (the second starts from the capacities the first
healed to; K2's fixed point no longer depends on them, so the two end in
the same bits, ``chip_smoke.py`` [25]), ``--perturbed`` runs whose ICs move 1% of the
coordinates by one float32 ulp (a different draw each), and the run on
four slab shards of the card (``devices=4``).  Since the deposits and K2
sum exactly, two runs from the same ICs end in the same bits; every
difference below is float32 rounding grown by the dynamics.
Prints each pair's largest relative P(k) difference in each band and
writes them as JSON to ``--out`` (default ``output/pk_spread.json``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def main(perturbed: int, out: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("torch_pk_spread: no CUDA GPU")
    import chip_smoke as cs
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import realize_ics, run_simulation

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    cfg = SimulationConfig(n_side=64, box=500.0, pm_grid=128, n_steps=142,
                           softening_kernel="spline",
                           output=OutputConfig(snapshot=False))
    ics = realize_ics(cfg, 0)
    gen = torch.Generator().manual_seed(3)
    runs = {}
    tags = (["run", "again"] + [f"ulp{i}" for i in range(perturbed)]
            + ["domain4"])
    for tag in tags:
        st = ics
        if tag.startswith("ulp"):
            pos = ics.pos.cpu()
            pick = torch.rand(pos.shape, generator=gen) < 0.01
            up = torch.nextafter(pos, torch.full_like(pos, 2 * cfg.box))
            st = ics.replace(pos=torch.where(pick, up, pos).to(ics.pos.device))
        run_cfg = cfg.replace(devices=4) if tag == "domain4" else cfg
        work = os.path.join(ROOT, "output", "pk_spread", tag)
        t0 = time.perf_counter()
        res = run_simulation(run_cfg, 0, work, initial_state=st)
        runs[tag] = res.powerspecs[0]
        print(f"{tag}: {time.perf_counter() - t0:.3f} s", flush=True)
    pairs = {}
    for a, b in itertools.combinations(tags, 2):
        bands = cs.pk_bands(runs[a], runs[b], cfg, f"{a} vs {b}")
        pairs[f"{a} vs {b}"] = [m for _, _, _, m in bands]
        print(f"{a} vs {b}: {cs.bands_text(bands)}", flush=True)
    result = dict(card=card, bands=[f for f, _ in cs.DOMAIN_PK_BANDS],
                  tols=[t for _, t in cs.DOMAIN_PK_BANDS], pairs=pairs,
                  script="scripts/torch_pk_spread.py")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--perturbed", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "pk_spread.json"))
    a = ap.parse_args()
    main(a.perturbed, a.out)
