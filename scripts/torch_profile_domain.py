"""Where the time of the torch port's domain-decomposed 64^3 run goes: four
slab shards on one GPU.

    python scripts/torch_profile_domain.py [--shards 4] [--tier supercell]
                                           [--rungs 0] [--skin -1]
                                           [--steps 16] [--out DIR]

The configuration is cfg64 (64^3 particles, box 500 Mpc, mesh 128, 142
steps, spline softening) with ``devices = --shards``, on the supercell or
the columns tier (``--tier``), or with ``--rungs R`` (>= 2) the domain rung
tier (the cells tier at the boundary ticks; the interior ticks on frozen
local plans at the driver's auto skin, or with ``--skin 0`` on the masked
cell planes).  Prints, and writes as JSON to ``--out`` (default
``output/``, git-ignored):

* the card's name and power limit (nvidia-smi);
* the whole run through ``run_simulation``: wall time, the time of its
  segments, heals, peak device memory;
* one force evaluation at the run's final state with its healed knobs,
  cut into stages timed with CUDA events (median of 20): the particle
  exchange, the shards' column planes, K2 + the halo fold (supercell),
  the slab FFTs (one forward, three inverse), K3 or K4 over the shards,
  and the whole evaluation;
* a ``torch.profiler`` window over ``--steps`` domain steps from the
  final state (a = 0.9 to 1, so that the healed knobs, the cell planes'
  bucket from run.log's heal lines among them, still hold):
  device time by kernel name and the device's busy share of the window's
  wall time;
* the float32 spread of P(k) at a = 1: the same config on one device run
  twice, and the domain run against the first, bin by bin in the bands
  of ``chip_smoke.py``'s DOMAIN_PK_BANDS (k up to k_Nyq/8, /4, /2).

With rungs the stages are those of a rung step (the rung assignment and
its histogram read, the exchange, the boundary tick's short force, the
long force, a plan freeze, an interior tick on each route with the active
set of the deepest rung and of rungs >= 1), and the run's time is split
by multiplying each stage by its count from run.log (boundary and
interior evaluations, freezes, steps); the rest of the segments' wall
time is the host's Python between the stages.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def median_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def stage_times(shards, group, geom, cfg, tier: str) -> dict:
    """Median ms of the stages of one domain force evaluation."""
    from nbody_torch.distributed import domain as td
    from nbody_torch.distributed.fft import slab_irfftn, slab_rfftn
    from nbody_torch.forces.p3m import supercell_ncell
    from nbody_torch.forces.p3m_columns import (
        column_window,
        plane_geometry,
        run_column_plane,
    )
    from nbody_torch.forces.pm_supercell import (
        extract_local_subgrids,
        run_fused_column_plane,
        supercell_deposit_local,
    )

    box, nmesh, D = cfg.box, cfg.mesh_size, group.size
    ck = cfg.column_capacity
    ncell = (supercell_ncell(box, nmesh, geom.r_cut) if tier == "supercell"
             else geom.ncell)
    nx = ncell // D
    CK, gz, stride, W, maxch, chunk = plane_geometry(
        box, geom.r_cut, ck, cfg.column_window
        or column_window(box, geom.r_cut, ck))
    pos, vel, mass = ([getattr(s, f) for s in shards]
                      for f in ("pos", "vel", "mass"))
    acc_fn, _ = td.make_domain_p3m_force(
        cfg.cosmology(), box, nmesh, group, cfg.eps, cfg.n_particles,
        shortrange=tier, col_capacity=CK, col_window=W,
        split=cfg.force_split, softening=cfg.softening_kernel)
    built = td.build_local_column_plane(pos, mass, box=box, r_cut=geom.r_cut,
                                        ncell=ncell, group=group,
                                        col_capacity=CK, window=W,
                                        chunk=chunk)
    kw = dict(ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
              chunk=chunk, eps=cfg.eps, r_s=geom.r_s, r_cut=geom.r_cut,
              split=cfg.force_split, softening=cfg.softening_kernel, nx=nx)
    slabs = [torch.rand((nmesh // D, nmesh, nmesh), device=p.device)
             for p in pos]
    hk = slab_rfftn(slabs, group)
    stages = {
        "exchange": lambda: td.slab_exchange(
            pos, vel, mass, box=box, ncell=td.slab_grid(geom, tier),
            group=group, exchange_capacity=max(64, pos[0].shape[0] // 8)),
        "column planes": lambda: td.build_local_column_plane(
            pos, mass, box=box, r_cut=geom.r_cut, ncell=ncell, group=group,
            col_capacity=CK, window=W, chunk=chunk),
        "slab FFTs (1 forward, 3 inverse)": lambda: (
            slab_rfftn(slabs, group),
            [slab_irfftn(hk, nmesh, group) for _ in range(3)]),
    }
    if tier == "supercell":
        grids = [torch.rand((3, nmesh // D, nmesh, nmesh), device=p.device)
                 for p in pos]
        halo = extract_local_subgrids(grids, group)
        stages["K2 + halo fold"] = lambda: supercell_deposit_local(
            [b[0] for b in built], [b[6] for b in built], box=box,
            nmesh=nmesh, ncell=ncell, group=group, stride=stride, gz=gz,
            chunk=chunk)
        stages["K3 (all shards)"] = lambda: [run_fused_column_plane(
            b[0], b[1], b[2], h, S=nmesh // ncell, scale=nmesh / box,
            split_out=True, row0=d * nx, **kw)
            for d, (b, h) in enumerate(zip(built, halo))]
    else:
        stages["K4 (all shards)"] = lambda: [run_column_plane(
            b[0], b[1], b[2], box=box, **kw) for b in built]
    stages["whole evaluation"] = lambda: acc_fn(pos, mass, 1.0)
    return {name: median_ms(fn) for name, fn in stages.items()}


def rung_split(log: list, report: dict) -> dict:
    """The rung run's segment time cut by stage: each stage's median time
    times its count in the run (run.log's "Domain rung stepping" counts;
    a step has one rung assignment and one long force, an exchange per
    step on the frozen route and per sub-tick on the masked one; the
    interior ticks at the mean of the two active sets' times),
    and the rest of the segments' wall time (the host between stages)."""
    st = report["stages_ms_final_state"]
    m = next(re.match(r"Domain rung stepping: (\d+) boundary, (\d+) "
                      r"frozen-plan interior and (\d+) masked interior force "
                      r"evaluations, (\d+) plan freezes", x) for x in log
             if x.startswith("Domain rung stepping"))
    B, F, M, Z = (int(x) for x in m.groups())
    n_sub = 2 ** (int(report["config"].split("rungs=")[1].split(",")[0]) - 1)
    # the steps of each route: frozen plans until a heal moves the skin
    # to 0, the masked cell planes after it
    route = "frozen" if any("frozen rung plans" in x for x in log) \
        else "masked"
    steps = {"frozen": 0, "masked": 0}
    for x in log:
        if "healing column_skin to 0" in x:
            route = "masked"
        steps[route] += "Rung population" in x

    def mean(prefix):
        v = [x for k, x in st.items() if k.startswith(prefix)]
        return sum(v) / len(v) if v else 0.0

    # one exchange a step on frozen plans, one a sub-tick on the masked
    # route
    exchanges = steps["frozen"] + n_sub * steps["masked"]
    split = {
        "boundary short force": B * st["boundary short force (cell planes "
                                       "+ K6)"] / 1e3,
        "long force": B * st["long force (slab PM)"] / 1e3,
        "exchanges": exchanges * st["exchange (with gl, gs, rung)"] / 1e3,
        "rung assignment": sum(steps.values())
        * st["rung assignment + histogram read"] / 1e3,
        "frozen interior ticks": F * mean("frozen interior") / 1e3,
        "masked interior ticks": M * mean("masked interior") / 1e3,
        "plan freezes": Z * st.get("plan freeze", 0.0) / 1e3,
    }
    split["other (host)"] = report["run"]["segments_s"] - sum(split.values())
    return split


def rung_stage_times(shards, group, geom, cfg, cfg_run) -> dict:
    """Median ms of the stages of one domain rung step at ``shards``."""
    from nbody_torch.core import units
    from nbody_torch.distributed import domain as td
    from nbody_torch.driver.simulate import domain_frozen_knobs
    from nbody_torch.forces.p3m_columns import (
        freeze_local_column_plan,
        p3m_local_columns_frozen_masked,
    )
    from nbody_torch.integrate.cosmo_stepping import (
        _assign_rungs,
        _rung_demand,
        log_a_steps,
    )

    box, D, R = cfg.box, group.size, cfg.rungs
    cosmo = cfg.cosmology()
    pos, vel, mass = ([getattr(s, f) for s in shards]
                      for f in ("pos", "vel", "mass"))
    fkw = dict(split=cfg.force_split, softening=cfg.softening_kernel,
               group=group)
    long_acc = td.make_domain_p3m_local(cosmo, geom, cfg.eps, part="long",
                                        **fkw)
    short_acc = td.make_domain_p3m_local(cosmo, geom, cfg.eps, part="short",
                                         **fkw)
    masked_acc = td.make_domain_p3m_local(
        cosmo, geom, cfg.eps, part="short_masked",
        target_capacity=cfg_run.rung_capacity or 128, **fkw)
    gl = long_acc(pos, mass, 1.0)
    gs, _ = short_acc(pos, mass, 1.0)
    a0, a1 = log_a_steps(cfg.a_begin, cfg.a_end, cfg.n_steps)[-2:]

    def t(x):
        return torch.tensor(float(x), device=pos[0].device)

    def assign():
        rung = [_assign_rungs(_rung_demand(
            v, x, y, t(a0), t(box / cfg.mesh_size), t(cfg.step_eta_disp),
            t(2.0 * cfg.step_eta_acc * cfg.eps), float(cosmo.H0),
            float(cosmo.Omega_m), float(cosmo.Omega_L)),
            torch.log(t(a1)) - torch.log(t(a0)), R)
            for v, x, y in zip(vel, gl, gs)]
        hist = group.psum([torch.bincount(torch.where(m > 0, r, R),
                                          minlength=R + 1)[:R]
                           for r, m in zip(rung, mass)])
        return rung, hist[0].tolist()

    rung, hist = assign()
    acts = {f"rung >= {r}": [(x >= r) & (m > 0) for x, m in zip(rung, mass)]
            for r in (R - 1, 1)}
    stages = {
        "rung assignment + histogram read": assign,
        "exchange (with gl, gs, rung)": lambda: td.slab_exchange(
            pos, vel, mass, box=box, ncell=geom.ncell, group=group,
            exchange_capacity=max(64, pos[0].shape[0] // 8),
            extras=(gl, gs, rung)),
        "boundary short force (cell planes + K6)": lambda: short_acc(
            pos, mass, 1.0),
        "long force (slab PM)": lambda: long_acc(pos, mass, 1.0),
    }
    for name, act in acts.items():
        stages[f"masked interior tick, {name} (K6 two-plane)"] = (
            lambda act=act: masked_acc(pos, mass, act, 1.0))
    skin, ck, cw = domain_frozen_knobs(cfg, geom, cfg_run.column_capacity)
    if skin > 0.0:
        skin = cfg_run.column_skin if cfg_run.column_skin > 0.0 else skin
        ckw = dict(box=box, r_cut=geom.r_cut, ncell=geom.ncell, group=group,
                   col_capacity=ck, window=max(cw, cfg_run.column_window))

        def freeze():
            return freeze_local_column_plan(pos, mass, skin=skin, **ckw)

        plans = freeze()
        stages["plan freeze"] = freeze
        for name, act in acts.items():
            stages[f"frozen interior tick, {name} (K5)"] = (
                lambda act=act: p3m_local_columns_frozen_masked(
                    pos, mass, act, plans, eps=cfg.eps, r_s=geom.r_s,
                    G=units.COSMO.G, split=cfg.force_split,
                    softening=cfg.softening_kernel, **ckw))
    out = {name: median_ms(fn) for name, fn in stages.items()}
    out["populations"] = hist
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--tier", default="supercell",
                    choices=("supercell", "columns"))
    ap.add_argument("--rungs", type=int, default=0)
    ap.add_argument("--skin", type=float, default=-1.0)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default="output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_domain: no CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nbody_torch import _kernels
    from nbody_torch.distributed import domain as td
    from nbody_torch.distributed.sharding import device_mesh
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import _domain_tier, run_simulation
    from nbody_torch.integrate.cosmo_stepping import log_a_steps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rungs = args.rungs if args.rungs >= 2 else 0
    if rungs:
        args.tier = "cells"
    cfg = SimulationConfig(n_side=64, box=500.0, pm_grid=128, n_steps=142,
                           softening_kernel="spline", devices=args.shards,
                           shortrange="auto" if args.tier != "columns"
                           else "columns", rungs=rungs,
                           column_skin=args.skin,
                           output=OutputConfig(snapshot=False))
    if _domain_tier(cfg, args.shards, rungs=bool(rungs)) != args.tier:
        raise SystemExit(f"cfg64 on {args.shards} shards does not resolve "
                         f"to the {args.tier} tier")
    name = (f"rungs{rungs}" + ("_cells" if args.skin == 0.0 else "")
            if rungs else args.tier)
    report = {"card": card, "config": f"cfg64 (64^3, box 500, mesh 128, "
              f"142 steps, spline softening), {args.shards} shards, "
              + (f"rungs={rungs}, column_skin={args.skin:g}" if rungs
                 else f"{args.tier} tier")}
    _kernels.load_library()
    work = os.path.join("output", f"profile_domain_{name}")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    res = run_simulation(cfg, 0, work)
    peak = torch.cuda.max_memory_allocated() / 2**20
    with open(os.path.join(work, "run.log")) as f:
        log = [line.rstrip() for line in f]
    seg_s = sum(float(line.split(" steps in ")[1].split(" s)")[0])
                for line in log if " steps in " in line)
    cfg_run = res.config_run
    report["run"] = {"wall_s": res.wall_s, "segments_s": seg_s,
                     "steps_per_s": cfg.n_steps / res.wall_s,
                     "heals": sum("re-running" in x for x in log),
                     "peak_mib": peak,
                     "column_capacity": cfg_run.column_capacity,
                     "column_window": cfg_run.column_window, "log": log}

    group = device_mesh(args.shards)
    geom = td.domain_p3m_geometry(cfg.box, cfg.mesh_size, args.shards,
                                  cfg.n_particles)
    healed = [int(m.group(1)) for m in (
        re.search(r"doubling bucket capacity to (\d+)", x) for x in log) if m]
    if healed:
        # the cell planes' bucket the run healed to (config_run keeps only
        # the column knobs, as the JAX driver's does)
        geom = geom._replace(bucket_capacity=healed[-1])
    shards = td.domain_decompose(res.state, group, cfg.box,
                                 td.slab_grid(geom, args.tier))
    if rungs:
        report["stages_ms_final_state"] = rung_stage_times(
            shards, group, geom, cfg, cfg_run)
        report["run"]["split_s"] = rung_split(log, report)
    else:
        report["stages_ms_final_state"] = stage_times(shards, group, geom,
                                                      cfg_run, args.tier)

    a_grid = log_a_steps(0.9, 1.0, args.steps)
    kw = dict(box=cfg.box, nmesh=cfg.mesh_size, eps=cfg.eps,
              n_global=cfg.n_particles, geom=geom, split=cfg.force_split,
              softening=cfg.softening_kernel, shortrange=args.tier,
              col_capacity=cfg_run.column_capacity,
              col_window=cfg_run.column_window or None)
    if rungs:
        from nbody_torch.driver.simulate import domain_frozen_knobs

        skin, ck, cw = domain_frozen_knobs(cfg, geom,
                                           cfg_run.column_capacity)
        if cfg_run.column_skin >= 0.0:
            skin = cfg_run.column_skin
        kw.update(rungs=rungs, eta_disp=cfg.step_eta_disp,
                  eta_acc=cfg.step_eta_acc,
                  target_capacity=cfg_run.rung_capacity or 128,
                  rung_frozen=skin > 0.0, col_capacity=ck or None,
                  col_window=max(cw, cfg_run.column_window) or None,
                  column_skin=skin)
    st = [s.replace(time=torch.as_tensor(0.9, device=s.pos.device))
          for s in shards]
    td.run_cosmological_domain(st, cfg.cosmology(), a_grid[:3], group, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = td.run_cosmological_domain(st, cfg.cosmology(), a_grid, group,
                                         **kw)
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
    report["profile"] = {
        "steps": args.steps, "window_s": window_s,
        "overflow": [out.exchange_overflow, out.bucket_overflow,
                     out.target_overflow, out.plan_overflow],
        "device_busy_ms": busy_ms, "busy_share": busy_ms / (window_s * 1e3),
        "by_kernel_ms": [{"name": k[:90], "ms": ms, "calls": c}
                         for k, ms, c in rows[:25]]}

    # the float32 spread of P(k): one device twice, and the domain run
    pks = {"domain": np.loadtxt(res.powerspecs[0])}
    for tag in ("single", "single again"):
        w = os.path.join("output", f"profile_domain_{name}_"
                         f"{tag.replace(' ', '_')}")
        shutil.rmtree(w, ignore_errors=True)
        one = run_simulation(cfg.replace(devices=1), 0, w)
        pks[tag] = np.loadtxt(one.powerspecs[0])
    k_nyq = np.pi * cfg.mesh_size / cfg.box
    spread = {}
    for a, b in (("single again", "single"), ("domain", "single")):
        rel = np.abs(pks[a][:, 2] / pks[b][:, 2] - 1.0)
        k, lo, bands = pks[b][:, 0], 0.0, []
        for frac in (1 / 8, 1 / 4, 1 / 2):
            sel = (k > lo) & (k <= frac * k_nyq)
            bands.append(float(rel[sel].max()))
            lo = frac * k_nyq
        spread[f"{a} vs {b}"] = bands
    report["pk_spread_to_k_nyq_8_4_2"] = spread

    print(f"card: {card}")
    r = report["run"]
    print(f"run ({report['config']}): wall {r['wall_s']:.3f} s "
          f"({r['steps_per_s']:.2f} steps/s), segments {r['segments_s']:.3f}"
          f" s, {r['heals']} heals, peak {r['peak_mib']:.1f} MiB; capacity "
          f"{r['column_capacity']}, window {r['column_window']}")
    print(("one rung step's stages" if rungs else "one force evaluation")
          + " at the final state (median ms): "
          + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in report["stages_ms_final_state"].items()))
    if rungs:
        print("the run's time by stage (s; counts from run.log x median "
              "stage times): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in r["split_s"].items()))
    p = report["profile"]
    print(f"profile over {p['steps']} steps: window {p['window_s']:.3f} s, "
          f"device busy {p['device_busy_ms']:.2f} ms "
          f"({100 * p['busy_share']:.1f}%), overflow {p['overflow']}")
    for row in p["by_kernel_ms"][:15]:
        print(f"  {row['ms']:9.3f} ms  {row['calls']:5d}  {row['name']}")
    for name, bands in spread.items():
        print(f"P(k) spread, {name}: max rel "
              + ", ".join(f"{m:.3e} to k_Nyq*{f:g}"
                          for f, m in zip((1 / 8, 1 / 4, 1 / 2), bands)))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_domain_{name}.json"),
              "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
