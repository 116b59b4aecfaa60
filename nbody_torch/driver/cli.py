"""Command-line interface: ``python -m nbody_torch.driver.cli <subcommand>``.

Counterpart of :mod:`nbody.driver.cli`, with its seven subcommands and
their flags:

  simulate  one run
  ensemble  a seeded many-run driver (``--batch B``: chunks of B members
            at once)
  measure   P(k) from existing HDF5 snapshots
  pipeline  the data -> simulate -> ETL -> train -> eval chain
  render    a density image from a snapshot
  sweep     a hyperparameter grid sweep of the emulator
  train     emulator training and evaluation

Each runs on the card unless ``--device cpu`` is given.  Each imports
what it needs inside its own function, so ``--help`` works without h5py
or matplotlib; ``pipeline --no-plot`` needs neither.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")


def _add_sim_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", help="JSON config file (overridden by flags)")
    p.add_argument("--box", type=float, help="box size [Mpc]")
    p.add_argument("--n-side", type=int, help="particles per dimension")
    p.add_argument("--pm-grid", type=int, help="PM mesh per dimension")
    p.add_argument("--solver", choices=("pp", "pm", "p3m"))
    p.add_argument("--a-begin", type=float)
    p.add_argument("--a-end", type=float)
    p.add_argument("--n-steps", type=int)
    p.add_argument("--lpt-order", type=int, choices=(1, 2))
    p.add_argument("--time-stepping", choices=("fixed", "adaptive"))
    p.add_argument(
        "--subcycles", type=int,
        help="P3M short-range KDK subcycles per global step "
        "(uniform cadence)")
    p.add_argument(
        "--rungs", type=int,
        help="per-particle rung stepping: R >= 2 rungs, short-range "
        "kicks for rung r every 2^(R-1-r)-th sub-tick, interior ticks "
        "evaluated for active rungs only (CONCEPT's scheme)")
    p.add_argument("--softening-kernel", choices=("spline", "plummer"))
    p.add_argument(
        "--devices", type=int,
        help="device count: 1 single-device, >1 slab domain decomposition "
        "(shards spread over the visible cards), 0 all visible cards")
    p.add_argument("--force-split", choices=("spline", "gaussian"),
                   dest="force_split")
    p.add_argument("--interlace", action="store_const", const=True,
                   default=None)
    p.add_argument(
        "--pm-gradient", choices=("spectral", "fd2", "fd4"),
        dest="pm_gradient",
        help="mesh-force differentiation kernel (CONCEPT's "
        "'differentiation' option; 'spectral' = its 'Fourier')")
    p.add_argument("--A-s", type=float, dest="A_s")
    p.add_argument("--n-s", type=float, dest="n_s")
    p.add_argument("--omega-cdm", type=float)
    p.add_argument("--h", type=float)
    p.add_argument("--seed", type=int, default=0)
    _add_device_arg(p)


def _config_from_args(args):
    from nbody_torch.driver.config import SimulationConfig

    path = getattr(args, "config", None)
    if path and path.endswith(".param"):
        # CONCEPT param-file interop
        from nbody_torch.driver.param_compat import load_concept_param

        cfg = load_concept_param(path)
    elif path:
        cfg = SimulationConfig.load(path)
    else:
        cfg = SimulationConfig()
    for flag in (
        "box", "n_side", "pm_grid", "solver", "a_begin", "a_end",
        "n_steps", "lpt_order", "A_s", "n_s", "omega_cdm", "h",
        "time_stepping", "subcycles", "rungs", "softening_kernel",
        "force_split", "interlace", "pm_gradient", "devices",
    ):
        v = getattr(args, flag, None)
        if v is not None:
            cfg = cfg.replace(**{flag: v})
    return cfg


def cmd_simulate(args) -> int:
    from nbody_torch.driver.simulate import run_simulation

    cfg = _config_from_args(args)
    res = run_simulation(
        cfg, seed=args.seed, workdir=args.output, device=args.device,
        checkpoint_every_steps=getattr(args, "checkpoint_every", 0) or None,
        resume=getattr(args, "resume", False))
    print(json.dumps({
        "solver": cfg.solver,
        "n_particles": cfg.n_particles,
        "steps": cfg.n_steps,
        "wall_s": round(res.wall_s, 3),
        "snapshots": res.snapshots,
        "powerspecs": res.powerspecs,
    }))
    return 0


def cmd_ensemble(args) -> int:
    from nbody_torch.driver.ensemble import draw_A_s, run_ensemble

    cfg = _config_from_args(args)
    A_s_values = None
    if args.vary_A_s:
        A_s_values = draw_A_s(args.total_samples, center=cfg.A_s,
                              width=args.A_s_width, draw_seed=args.draw_seed)
    res = run_ensemble(cfg, args.total_samples, workdir=args.output,
                       master_seed=args.seed, A_s_values=A_s_values,
                       max_retries=args.max_retries,
                       resume=not args.no_resume,
                       split_name=args.split_name, batch=args.batch,
                       device=args.device)
    print(json.dumps({
        "n": args.total_samples,
        "failed": res.failed,
        "skipped": res.skipped,
        "wall_s": round(res.wall_s, 3),
        "workdir": args.output,
    }))
    return 1 if res.failed else 0


def cmd_measure(args) -> int:
    from nbody_torch.core import units
    from nbody_torch.driver.config import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import measure_powerspec
    from nbody_torch.io.snapshot import find_hdf5_files, read_snapshot

    paths = []
    for target in args.snapshots:
        if os.path.isdir(target):
            paths.extend(find_hdf5_files(target))
        else:
            paths.append(target)
    if not paths:
        print("no snapshots found", file=sys.stderr)
        return 1
    for p in paths:
        state, meta = read_snapshot(p, device=args.device)
        n_side = max(2, round(state.n ** (1 / 3)))
        h = meta.H0 / units.H100_GYR if meta.H0 else 0.67
        cfg = SimulationConfig(
            box=meta.boxsize or args.box,
            n_side=n_side,
            pm_grid=args.nmesh or 0,
            h=h,
            omega_cdm=meta.Omega_cdm * h**2 if meta.Omega_cdm else 0.12,
            omega_b=meta.Omega_b * h**2 if meta.Omega_b else 0.022,
            interlace=args.interlace,
            output=OutputConfig(powerspec_interpolation=args.interpolation,
                                powerspec_binning=args.binning),
        )
        out = os.path.join(
            args.output or os.path.dirname(p),
            os.path.basename(p).replace("snapshot_", "powerspec_")
            .replace(".hdf5", ""))
        k, _, _, _, _ = measure_powerspec(state.pos, cfg, a=meta.a, path=out)
        print(json.dumps({"snapshot": p, "powerspec": out, "bins": int(len(k))}))
    return 0


def cmd_pipeline(args) -> int:
    from nbody_torch.driver.pipeline import PipelineConfig, main_pipeline

    cfg = PipelineConfig(
        box=args.box, n_side=args.n_side, n_trainval=args.n_trainval,
        n_test=args.n_test, n_steps=args.n_steps, solver=args.solver,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        uq=args.uq, experiments=tuple(args.experiments),
        master_seed=args.seed)
    results = main_pipeline(cfg, args.data_dir, plot=not args.no_plot,
                            device=args.device)
    print(json.dumps(results))
    return 0


def cmd_train(args) -> int:
    from nbody_torch.emulator.train import train_from_cli

    return train_from_cli(args)


def cmd_render(args) -> int:
    from nbody_torch.analysis.render import render_snapshot

    out = args.output or args.snapshot.rsplit(".", 1)[0] + ".png"
    render_snapshot(args.snapshot, out, res=args.res, axis=args.axis,
                    device=args.device)
    print(json.dumps({"snapshot": args.snapshot, "image": out}))
    return 0


def cmd_sweep(args) -> int:
    import numpy as np

    from nbody_torch.emulator.data import DeltaDataset
    from nbody_torch.emulator.model import max_conv_blocks
    from nbody_torch.emulator.train import run_sweep

    train_ds = DeltaDataset.from_directory(args.data_dir, "train")
    val_ds = DeltaDataset.from_directory(args.data_dir, "val")
    test_ds = DeltaDataset.from_directory(args.data_dir, "test")
    out = run_sweep(
        dict(n_out=train_ds.y.shape[1],
             n_conv=min(2, max_conv_blocks(train_ds.dim))),
        train_ds, val_ds, test_ds,
        batch_sizes=tuple(args.batch_sizes), lrs=tuple(args.lrs),
        epochs_list=tuple(args.epochs), out_dir=args.output, seed=args.seed,
        device=args.device)
    print(json.dumps(
        {k: np.asarray(v).tolist() for k, v in out.items()}
        | {"batch_sizes": args.batch_sizes, "lrs": args.lrs,
           "epochs": args.epochs}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nbody_torch",
        description="cosmological N-body framework (PyTorch + CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("simulate", help="run one simulation")
    _add_sim_args(p)
    p.add_argument("--output", default="output", help="run directory")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="autosave checkpoint every N steps (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the run dir's autosave checkpoint if "
                   "present")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("ensemble", help="run a seeded ensemble")
    _add_sim_args(p)
    p.add_argument("--total-samples", type=int, required=True)
    p.add_argument("--output", default="ensemble", help="ensemble root dir")
    p.add_argument("--vary-A-s", action="store_true", dest="vary_A_s")
    p.add_argument("--A-s-width", type=float, default=0.6e-9,
                   dest="A_s_width")
    p.add_argument("--draw-seed", type=int, default=420)
    p.add_argument("--max-retries", type=int, default=3)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--split-name", default="Training")
    p.add_argument("--batch", type=int, default=0,
                   help="batched tier: integrate chunks of B members at "
                   "once (members share all params except A_s)")
    p.set_defaults(fn=cmd_ensemble)

    p = sub.add_parser("measure", help="P(k) from HDF5 snapshots")
    p.add_argument("snapshots", nargs="+", help="snapshot files or dirs")
    p.add_argument("--nmesh", type=int, default=0)
    p.add_argument("--interpolation", choices=("cic", "tsc", "pcs"),
                   default="cic")
    p.add_argument("--binning", choices=("geomspace", "concept"),
                   default="geomspace")
    p.add_argument("--interlace", action="store_true",
                   help="two half-cell-shifted deposits combined in k space")
    p.add_argument("--box", type=float, default=500.0,
                   help="fallback box size")
    p.add_argument("--output", help="output dir (default: next to snapshot)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_measure)

    p = sub.add_parser("pipeline",
                       help="full data->simulate->ETL->train->eval chain")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--n-side", type=int, default=32)
    p.add_argument("--box", type=float, default=500.0)
    p.add_argument("--n-trainval", type=int, default=200)
    p.add_argument("--n-test", type=int, default=100)
    p.add_argument("--n-steps", type=int, default=142)
    p.add_argument("--solver", choices=("pp", "pm", "p3m"), default="p3m")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=4e-3)
    p.add_argument("--uq", choices=("MC", "nlll", "bayesian"), default="MC")
    p.add_argument("--experiments", nargs="+",
                   default=["CLASS2SIM", "SIM3"],
                   choices=["CLASS2SIM", "SIM3"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-plot", action="store_true",
                   help="no evaluation figure (no matplotlib)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_pipeline)

    p = sub.add_parser("render", help="density image from a snapshot")
    p.add_argument("snapshot")
    p.add_argument("--output", default=None, help="PNG path")
    p.add_argument("--res", type=int, default=512)
    p.add_argument("--axis", type=int, default=2, choices=(0, 1, 2))
    _add_device_arg(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("sweep",
                       help="hyperparameter grid sweep for the emulator")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[16])
    p.add_argument("--lrs", type=float, nargs="+", default=[4e-3])
    p.add_argument("--epochs", type=int, nargs="+", default=[100])
    p.add_argument("--output", default="sweep_out")
    p.add_argument("--seed", type=int, default=0)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("train", help="train the CNN emulator")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=4e-3)
    p.add_argument("--uq", choices=("MC", "nlll", "bayesian"), default="MC")
    p.add_argument("--output", default="emulator_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel training over several cards (needs "
                   "the torch.distributed backend: > 1 raises for now)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_train)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
