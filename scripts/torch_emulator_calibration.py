"""The MC-dropout calibration of the port's ``fit`` beside the JAX
package's on the CPU.

Both packages train ``CosmoCNN(n_out=1, n_conv=2)`` (dropout 0.2, batch
16, lr 4e-3, augmentation) on the same 200 + 100 volumes (box 500, the
pipeline's A_s bands, the test split from master seed 10,000), the JAX
side through its streaming loop ``_fit_host_loop``, the port through
``fit``, each from its own seed (their random streams differ, so a run
compares in distribution, not number for number), then ``evaluate_uq``
with 50 passes.  One JSON line a package and seed: the best epoch, the
last train loss, the best val loss, the A_s abs deviation, the 1/2/3-sigma
coverage, the RMS error and the mean MC sigma (% of A_s).

    python scripts/torch_emulator_calibration.py [--epochs 200]
        [--seeds 0 1] [--nmesh 16] [--packages jax port]
        [--maker jax|port] [--data DIR] [--out FILE]

``--maker`` picks the package whose ``create_linear_dataset`` writes the
volumes (JAX by default; the port's draws each volume from its own CPU
generator, so ``--maker port`` gives the volumes that
``scripts/torch_emulator_scale.py`` makes on the card); ``--data`` keeps
them in DIR (a volume already there is kept) instead of a temporary
directory; ``--out`` appends each line to FILE too; ``--save-params``
writes each fit's best params to DIR as ``.npz`` (the JAX package's
keyed ``layer/name``, for ``convert.cnn_params_from_jax``; the port's
by its state_dict) and its history beside them (``*_history.npz``); ``--eval-params
NPZ ...`` trains nothing and runs each package's ``evaluate_uq`` (50
passes, each ``--seeds`` value an MC seed) on such params, the port's
through ``cnn_params_from_jax``.  At 16^3 a seed
takes about 2 minutes at 200 epochs on four cores; at 32^3 the JAX
package's step takes about 0.3 s on eight (an hour for 1000 epochs).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def stats(ev) -> dict:
    rel = (ev.mu[:, 0] - ev.y_true[:, 0]) / ev.y_true[:, 0]
    return {"abs_dev_percent_A_s": float(ev.abs_dev_percent[0]),
            "coverage_1_2_3_sigma": [float(c) for c in ev.coverage[0]],
            "rms_err_percent": float(100 * np.sqrt(np.mean(rel**2))),
            "mean_sigma_percent": float(100 * np.mean(
                ev.sigma_total[:, 0] / ev.y_true[:, 0]))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--nmesh", type=int, default=16)
    ap.add_argument("--packages", nargs="+", default=["jax", "port"],
                    choices=("jax", "port"))
    ap.add_argument("--maker", default="jax", choices=("jax", "port"))
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-params", default=None, metavar="DIR")
    ap.add_argument("--eval-params", nargs="+", default=None,
                    metavar="NPZ")
    args = ap.parse_args()

    from nbody.driver.pipeline import A_S_CENTER, A_S_SIGMA
    from nbody.emulator import data as jdata
    from nbody.emulator import model as jmodel
    from nbody.emulator import train as jtrain
    from nbody_torch.emulator import data as tdata
    from nbody_torch.emulator import model as tmodel
    from nbody_torch.emulator import train as ttrain

    def make(root: str) -> None:
        kw = {} if args.maker == "jax" else {"device": "cpu"}
        lib = jdata if args.maker == "jax" else tdata
        lib.create_linear_dataset(
            root, 200, z=0.0, box=500.0, nmesh=args.nmesh,
            A_s_min=A_S_CENTER - 20 * A_S_SIGMA,
            A_s_max=A_S_CENTER + 20 * A_S_SIGMA, val_size=0.1, **kw)
        lib.create_linear_dataset(
            root, 100, z=0.0, box=500.0, nmesh=args.nmesh,
            A_s_min=A_S_CENTER - 10 * A_S_SIGMA,
            A_s_max=A_S_CENTER + 10 * A_S_SIGMA, test=True,
            master_seed=10_000, **kw)
        return [jdata.DeltaDataset.from_directory(root, s)
                for s in ("train", "val", "test")]

    if args.data:
        os.makedirs(args.data, exist_ok=True)
        splits = make(args.data)  # resume by skip: existing volumes stay
    else:
        with tempfile.TemporaryDirectory() as root:
            splits = make(root)
    ported = [tdata.DeltaDataset(d.X, d.y, d.maxima, d.vary_flags)
              for d in splits]

    def emit(line: dict) -> None:
        text = json.dumps(line | {"nmesh": args.nmesh,
                                  "maker": args.maker})
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    if args.eval_params:
        from nbody_torch.convert import cnn_params_from_jax

        for path in args.eval_params:
            z = np.load(path)
            params = {}
            for key in z.files:
                layer, name = key.split("/")
                params.setdefault(layer, {})[name] = z[key]
            jm = jmodel.CosmoCNN(n_out=1, n_conv=2)
            tm = tmodel.CosmoCNN(n_out=1, n_conv=2)
            for seed in args.seeds:
                for package in args.packages:
                    if package == "jax":
                        ev = jtrain.evaluate_uq(jm, params, splits[2],
                                                n_mc=50, seed=seed)
                    else:
                        ev = ttrain.evaluate_uq(
                            tm, cnn_params_from_jax(params), ported[2],
                            n_mc=50, seed=seed, device="cpu")
                    emit({"package": package, "params": path,
                          "eval_seed": seed, **stats(ev)})
        return 0

    def save(package: str, seed: int, history: dict, params: dict) -> None:
        if not args.save_params:
            return
        os.makedirs(args.save_params, exist_ok=True)
        stem = os.path.join(args.save_params,
                            f"{package}_n{args.nmesh}_e{args.epochs}"
                            f"_seed{seed}")
        np.savez(stem + ".npz", **params)
        np.savez(stem + "_history.npz",
                 **{k: np.asarray(v) for k, v in history.items()})

    for seed in args.seeds:
        if "jax" in args.packages:
            t0 = time.perf_counter()
            jm = jmodel.CosmoCNN(n_out=1, n_conv=2)
            res = jtrain._fit_host_loop(
                jm, splits[0], splits[1], epochs=args.epochs, batch_size=16,
                lr=4e-3, seed=seed, augment=True, kl_weight=None,
                early_stop_patience=None, early_stop_start=300,
                reduce_lr_patience=None, reduce_lr_factor=0.5, min_lr=1e-5,
                checkpoint_path=None, verbose=False, devices=1)
            wall = time.perf_counter() - t0
            ev = jtrain.evaluate_uq(jm, res.params, splits[2], n_mc=50,
                                    seed=seed)
            save("jax", seed, res.history,
                 {f"{layer}/{name}": np.asarray(arr)
                  for layer, group in res.params.items()
                  for name, arr in group.items()})
            emit({"package": "jax", "seed": seed, "epochs": args.epochs,
                  "best_epoch": res.best_epoch,
                  "last_train_loss": res.history["train_loss"][-1],
                  "best_val_loss": res.best_val_loss, "wall_s": wall,
                  **stats(ev)})
        if "port" in args.packages:
            t0 = time.perf_counter()
            tm = tmodel.CosmoCNN(n_out=1, n_conv=2)
            res = ttrain.fit(tm, ported[0], ported[1], epochs=args.epochs,
                             batch_size=16, lr=4e-3, seed=seed,
                             device="cpu")
            wall = time.perf_counter() - t0
            save("port", seed, res.history,
                 {k: v.numpy() for k, v in res.params.items()})
            ev = ttrain.evaluate_uq(tm, res.params, ported[2], n_mc=50,
                                    seed=seed, device="cpu")
            emit({"package": "port", "seed": seed, "epochs": args.epochs,
                  "best_epoch": res.best_epoch,
                  "last_train_loss": res.history["train_loss"][-1],
                  "best_val_loss": res.best_val_loss, "wall_s": wall,
                  **stats(ev)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
