"""The emulator at the thesis's own scale on the card (the port's
``scripts/emulator_scale.py``): 200 train/val volumes of 32^3 (val_size
0.1) and 100 test volumes from ``create_linear_dataset`` (box 500, z 0,
the pipeline's A_s bands: +-20 sigma for train/val, +-10 sigma for test,
around 2.105e-9), read back through ``DeltaDataset.from_directory`` (the
native loader), then ``fit`` of ``CosmoCNN(n_out=1, n_conv=2)`` for 1000
epochs at batch 16 and lr 4e-3 with augmentation, and ``evaluate_uq``
with 50 MC-dropout passes.  The test split's fields come from master
seed 10,000 (as ``main_pipeline`` draws them): the port's volume i of
every split draws from the generator of (master_seed, i), so one seed
would give test volume i the phases of train volume i.

    python scripts/torch_emulator_scale.py [--seeds 0 1 2] [--epochs 1000]
        [--out tests/data/torch_port/emulator_scale_h100.json]
        [--history DIR]

runs the protocol once for each fit seed (init, dropout and augmentation;
the data is drawn once; ``--compute-dtype bf16`` runs the model in
bfloat16), times 200 train steps under four cuDNN settings
(``step_times``), and writes one JSON object: the walls, ms a step, A_s
abs deviation, the 1/2/3-sigma coverage, the mean sigma beside the RMS
error and the best epoch of each seed, and the card's name and power
limit.  Needs a CUDA card (``chip_smoke.py`` [26](a) runs ``protocol``
for one seed).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_TRAINVAL, N_TEST, NMESH, BOX = 200, 100, 32, 500.0
EPOCHS, BATCH, LR, N_MC = 1000, 16, 4e-3, 50
TEST_MASTER_SEED = 10_000


def make_data(root: str, device="cuda") -> float:
    """The protocol's volumes and sidecars under ``root``; the wall."""
    from nbody_torch.driver.pipeline import A_S_CENTER, A_S_SIGMA
    from nbody_torch.emulator.data import create_linear_dataset

    t0 = time.perf_counter()
    create_linear_dataset(root, N_TRAINVAL, z=0.0, box=BOX, nmesh=NMESH,
                          A_s_min=A_S_CENTER - 20 * A_S_SIGMA,
                          A_s_max=A_S_CENTER + 20 * A_S_SIGMA,
                          val_size=0.1, device=device)
    create_linear_dataset(root, N_TEST, z=0.0, box=BOX, nmesh=NMESH,
                          A_s_min=A_S_CENTER - 10 * A_S_SIGMA,
                          A_s_max=A_S_CENTER + 10 * A_S_SIGMA, test=True,
                          master_seed=TEST_MASTER_SEED, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def load_splits(root: str):
    """(train, val, test) ``DeltaDataset`` from ``root`` and the wall of
    the reads."""
    from nbody_torch.emulator.data import DeltaDataset

    t0 = time.perf_counter()
    splits = tuple(DeltaDataset.from_directory(root, s)
                   for s in ("train", "val", "test"))
    return splits, time.perf_counter() - t0


def protocol(splits, epochs: int = EPOCHS, seed: int = 0, device="cuda",
             compute_dtype: str = "auto", history: str | None = None) -> dict:
    """``fit`` and ``evaluate_uq`` of the reference's model on the splits:
    walls, ms a step (the fit's wall over its optimizer steps, the val
    pass and the epoch's host read included), accuracy, coverage, and the
    mean MC sigma beside the RMS error (both in % of A_s)."""
    from nbody_torch.emulator.model import CosmoCNN, max_conv_blocks
    from nbody_torch.emulator.train import evaluate_uq, fit

    train, val, test = splits
    model = CosmoCNN(n_out=1, n_conv=min(2, max_conv_blocks(train.dim)),
                     compute_dtype=compute_dtype)
    res = fit(model, train, val, epochs=epochs, batch_size=BATCH, lr=LR,
              seed=seed, device=device)
    t0 = time.perf_counter()
    ev = evaluate_uq(model, res.params, test, n_mc=N_MC, seed=seed,
                     device=device)
    eval_wall = time.perf_counter() - t0
    if history:
        np.savez(history, **{k: np.asarray(v)
                             for k, v in res.history.items()})
    epochs_run = len(res.history["train_loss"])
    steps = epochs_run * (len(train) // BATCH)
    rel = (ev.mu[:, 0] - ev.y_true[:, 0]) / ev.y_true[:, 0]
    return {
        "seed": seed, "compute_dtype": compute_dtype, "epochs": epochs,
        "epochs_run": epochs_run,
        "steps": steps, "train_wall_s": res.wall_s,
        "ms_per_step": 1e3 * res.wall_s / steps, "eval_wall_s": eval_wall,
        "best_epoch": res.best_epoch, "best_val_loss": res.best_val_loss,
        "abs_dev_percent_A_s": float(ev.abs_dev_percent[0]),
        "coverage_1_2_3_sigma": [float(c) for c in ev.coverage[0]],
        "rms_err_percent": float(100 * np.sqrt(np.mean(rel**2))),
        "mean_sigma_percent": float(100 * np.mean(ev.sigma_total[:, 0]
                                                  / ev.y_true[:, 0])),
        "train_loss_first_last": [res.history["train_loss"][0],
                                  res.history["train_loss"][-1]],
    }


def step_times(train, n: int = 200, device="cuda") -> dict:
    """ms of one train step (gather, augmentation, forward, backward,
    Adam) at batch 16, CUDA events over ``n`` steps after a warm-up, in
    turns, under four cuDNN settings (no TF32 in any): the port's
    (deterministic algorithms, no autotuning), deterministic with the
    model and batch channels-last, deterministic with autotuning among
    the deterministic algorithms, and autotuned with non-deterministic
    algorithms allowed."""
    from nbody_torch.emulator import model as model_mod
    from nbody_torch.emulator import train as train_mod
    from nbody_torch.emulator.data import augment_batch

    def flags(benchmark, deterministic):
        return lambda: torch.backends.cudnn.flags(
            enabled=True, benchmark=benchmark, deterministic=deterministic,
            allow_tf32=False)

    variants = {
        "deterministic": (model_mod.deterministic_cudnn, False),
        "deterministic, channels-last": (model_mod.deterministic_cudnn,
                                         True),
        "deterministic, autotuned": (flags(True, True), False),
        "autotuned, non-deterministic": (flags(True, False), False),
    }
    X = torch.as_tensor(train.X, device=device)
    y = torch.as_tensor(train.y, device=device)
    gen = torch.Generator(device).manual_seed(0)
    idx = torch.randint(0, len(train), (n + 10, BATCH), generator=gen,
                        device=device)

    def run(ctx, channels_last: bool) -> float:
        saved = (model_mod.deterministic_cudnn, train_mod.deterministic_cudnn)
        model_mod.deterministic_cudnn = train_mod.deterministic_cudnn = ctx
        try:
            model = model_mod.CosmoCNN(n_out=1, n_conv=2).to(device)
            if channels_last:
                model.to(memory_format=torch.channels_last_3d)
            opt = torch.optim.Adam(model.parameters(), lr=LR)

            def step(i):
                x = augment_batch(X.index_select(0, idx[i]), gen)
                pred, _ = model(x, gen)
                loss = model_mod.mse_loss(pred, y.index_select(0, idx[i]))
                opt.zero_grad(set_to_none=True)
                with ctx():
                    loss.backward()
                opt.step()

            for i in range(10):
                step(i)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(n):
                step(10 + i)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / n
        finally:
            model_mod.deterministic_cudnn, train_mod.deterministic_cudnn = saved

    out = {name: [] for name in variants}
    for _ in range(2):
        for name, (ctx, cl) in variants.items():
            out[name].append(run(ctx, cl))
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--compute-dtype", default="auto",
                    choices=("auto", "f32", "bf16"))
    ap.add_argument("--history", default=None, metavar="DIR",
                    help="also write each seed's loss history to DIR")
    ap.add_argument("--out", default=os.path.join(
        "tests", "data", "torch_port", "emulator_scale_h100.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_emulator_scale: needs a CUDA card")
    with tempfile.TemporaryDirectory() as root:
        data_wall = make_data(root)
        splits, read_wall = load_splits(root)
        runs = []
        for seed in args.seeds:
            hist = None
            if args.history:
                os.makedirs(args.history, exist_ok=True)
                hist = os.path.join(args.history, f"history_seed{seed}.npz")
            runs.append(protocol(splits, args.epochs, seed,
                                 compute_dtype=args.compute_dtype,
                                 history=hist))
            print(json.dumps(runs[-1]), flush=True)
        steps = step_times(splits[0])
    out = {
        "metric": "emulator reference-scale fit on the card",
        "protocol": "scripts/torch_emulator_scale.py",
        "card": card(), "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "n_trainval": N_TRAINVAL, "n_test": N_TEST, "nmesh": NMESH,
        "epochs": args.epochs, "batch_size": BATCH, "lr": LR, "n_mc": N_MC,
        "data_wall_s": data_wall, "read_wall_s": read_wall,
        "runs": runs, "step_ms": steps,
    }
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
