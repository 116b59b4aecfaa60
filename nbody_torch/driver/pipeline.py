"""End-to-end pipeline: data generation -> simulations -> ETL -> emulator.

Counterpart of :mod:`nbody.driver.pipeline`, which rebuilds the
reference's ``Feeder_pipe.py`` orchestrator: ``main_pipeline`` chains the
linear-theory data (the +-20 sigma A_s train band and +-10 sigma test
band around 2.105e-9), the simulation-derived delta grids (the
reference's CONCEPT snapshots, here this package's own ensembles) and
the EXPERIMENTS registry, which trains the CNN on one data source and
tests it on another.  Every data root has the standard layout
(Training & val data / Test data / sidecars).

The simulation source runs ``run_ensemble`` on the card, SIM_BATCH
members at once (its batched tier: each member's state is its own run's,
bit for bit), and hands each member's final state to ``state_to_delta``
in memory: the JAX package writes a final HDF5 snapshot per member and
reads it back through ``snapshots_to_delta``, which applies the same
function to each file, but the card's machine has no h5py.  A member
whose volume is on disk is not run again.  ``plot=False`` skips the
figure (matplotlib is imported only to draw it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Sequence

import numpy as np

from nbody_torch.driver.config import OutputConfig, SimulationConfig
from nbody_torch.driver.ensemble import (
    TEST_DRAW_SEED,
    TRAIN_DRAW_SEED,
    draw_A_s,
    run_ensemble,
)
from nbody_torch.emulator.data import (
    DeltaDataset,
    create_linear_dataset,
    delta_path,
    save_delta,
    state_to_delta,
)
from nbody_torch.io.sidecars import (
    BoxParams,
    MaxMinParams,
    write_box_params,
    write_maxmin_params,
    write_param_table,
)

A_S_CENTER = 2.105e-9  # the reference's Feeder_pipe.py
A_S_SIGMA = 0.030e-9

#: Experiment registry: train/test data-source pairs (the reference's
#: EXPERIMENTS; 'linear' is its CLASS path, 'sim' its CONCEPT path).
EXPERIMENTS = {
    "CLASS2SIM": {"train": "linear", "test": "sim"},
    "SIM3": {"train": "sim", "test": "sim"},
}

#: the simulation source's members integrated at once
SIM_BATCH = 8


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    z: float = 0.0
    box: float = 500.0
    n_side: int = 32
    n_trainval: int = 200
    n_test: int = 100
    sigma_train: float = 20.0  # A_s band half-widths in units of A_S_SIGMA
    sigma_test: float = 10.0
    val_size: float = 0.1
    # simulation source settings (the reference's NN.param: P3M, a=0.02->1)
    solver: str = "p3m"
    n_steps: int = 142
    master_seed: int = 0
    # emulator settings (the reference's epochs, batch size and rate)
    epochs: int = 1000
    batch_size: int = 16
    lr: float = 4e-3
    uq: str = "MC"
    experiments: Sequence[str] = ("CLASS2SIM", "SIM3")

    @property
    def a_end(self) -> float:
        return 1.0 / (1.0 + self.z)

    def sim_config(self) -> SimulationConfig:
        return SimulationConfig(
            box=self.box, n_side=self.n_side, solver=self.solver,
            n_steps=self.n_steps, a_end=self.a_end,
            output=OutputConfig(snapshot_times=(self.a_end,),
                                powerspec=False, snapshot=False))

    def bands(self):
        tr = (A_S_CENTER - self.sigma_train * A_S_SIGMA,
              A_S_CENTER + self.sigma_train * A_S_SIGMA)
        te = (A_S_CENTER - self.sigma_test * A_S_SIGMA,
              A_S_CENTER + self.sigma_test * A_S_SIGMA)
        return tr, te


def create_simulation_dataset(cfg: PipelineConfig, out_dir: str,
                              n_samples: int, A_s_values: np.ndarray,
                              test: bool = False, *, device="cuda") -> str:
    """Run a solver ensemble for the given A_s draws on ``device`` and
    turn the members' final states into a standard-layout delta-grid data
    root (the reference's CONCEPT branch), in memory through
    ``state_to_delta``; a member whose volume exists is skipped."""
    sim = cfg.sim_config()
    ens_root = os.path.join(out_dir, "runs_test" if test else "runs_trainval")

    def etl(i, state):
        save_delta(out_dir, i + 1,
                   state_to_delta(state.pos, cfg.box, cfg.n_side), test)

    run_ensemble(sim, n_samples, workdir=ens_root,
                 master_seed=cfg.master_seed + (1 if test else 0),
                 A_s_values=A_s_values,
                 split_name="Test" if test else "Training", batch=SIM_BATCH,
                 device=device, on_final_state=etl,
                 members=[i for i in range(n_samples) if not os.path.exists(
                     delta_path(out_dir, i + 1, test))])
    labels = np.column_stack([A_s_values, np.full(n_samples, sim.n_s),
                              np.full(n_samples, sim.omega_cdm)])
    write_box_params(os.path.join(out_dir, "BoxParams.txt"),
                     BoxParams(cfg.z, cfg.box, cfg.n_side))
    write_maxmin_params(
        os.path.join(out_dir, "MaxMinParams.txt"),
        MaxMinParams(float(A_s_values.min()), float(A_s_values.max()),
                     sim.n_s, sim.n_s, sim.omega_cdm, sim.omega_cdm,
                     n_samples))
    if test:
        write_param_table(os.path.join(out_dir, "TestParams.txt"), labels)
    else:
        n_train = int(n_samples * (1.0 - cfg.val_size))
        write_param_table(os.path.join(out_dir, "TrainingParams.txt"),
                          labels[:n_train])
        write_param_table(os.path.join(out_dir, "ValParams.txt"),
                          labels[n_train:])
    return out_dir


def run_experiment(name: str, cfg: PipelineConfig, roots: dict,
                   out_dir: str, plot: bool = True, *,
                   device="cuda") -> dict:
    """Train on one source, test on another, on ``device``; save the
    metrics, the history and (``plot``) the figure."""
    from nbody_torch.emulator.model import CosmoCNN, max_conv_blocks
    from nbody_torch.emulator.train import evaluate_uq, fit

    spec = EXPERIMENTS[name]
    train_ds = DeltaDataset.from_directory(roots[spec["train"]], "train")
    val_ds = DeltaDataset.from_directory(roots[spec["train"]], "val")
    test_ds = DeltaDataset.from_directory(roots[spec["test"]], "test")
    model = CosmoCNN(n_out=train_ds.y.shape[1],
                     n_conv=min(2, max_conv_blocks(train_ds.dim)),
                     heteroscedastic=cfg.uq == "nlll",
                     variational=cfg.uq == "bayesian")
    res = fit(model, train_ds, val_ds, epochs=cfg.epochs,
              batch_size=cfg.batch_size, lr=cfg.lr, seed=cfg.master_seed,
              checkpoint_path=os.path.join(out_dir, f"{name}_params.pt"),
              device=device)
    ev = evaluate_uq(model, res.params, test_ds, seed=cfg.master_seed,
                     device=device)
    info = {
        "experiment": name,
        "train_source": spec["train"],
        "test_source": spec["test"],
        "uq": cfg.uq,
        "best_val_loss": res.best_val_loss,
        "wall_s": round(res.wall_s, 2),
        **ev.to_json(),
    }
    with open(os.path.join(out_dir, f"{name}_result.json"), "w") as f:
        json.dump(info | {"history": res.history}, f, indent=2)
    if plot:
        _experiment_figure(name, res, ev, out_dir, cfg)
    return info


def _experiment_figure(name, res, ev, out_dir, cfg):
    """Loss curves and predicted against true with error bars, the
    reference's evaluation figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    ax = axes[0]
    ax.plot(res.history["train_loss"], label="train")
    ax.plot(res.history["val_loss"], label="val")
    ax.set(xlabel="epoch", ylabel="loss", yscale="log",
           title=f"{name} ({cfg.uq})")
    ax.legend()
    ax = axes[1]
    t, m, s = ev.y_true[:, 0], ev.mu[:, 0], ev.sigma_total[:, 0]
    ax.errorbar(t, m, yerr=s, fmt="o", ms=3, alpha=0.7, lw=0.8)
    lo, hi = min(t.min(), m.min()), max(t.max(), m.max())
    ax.plot([lo, hi], [lo, hi], "k--", lw=1)
    ax.set(xlabel="true $A_s$", ylabel="predicted $A_s$",
           title=f"dev={ev.abs_dev_percent[0]:.1f}%  "
           f"cov(1σ)={ev.coverage[0, 0]:.2f}")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"{name}_eval.png"), dpi=120)
    plt.close(fig)


def main_pipeline(cfg: PipelineConfig, data_dir: str, *, plot: bool = True,
                  device="cuda") -> dict:
    """The full chain (the reference's ``main_pipeline``), on ``device``:

      1. linear-theory train/val and test delta volumes ('linear' root);
      2. solver-ensemble train/val and test delta volumes ('sim' root),
         from the SAME pinned A_s draws per split;
      3. each registered experiment: train -> UQ eval -> figure
         (``plot``).
    """
    t0 = time.perf_counter()
    (tr_lo, tr_hi), (te_lo, te_hi) = cfg.bands()
    linear_root = os.path.join(data_dir, "linear")
    sim_root = os.path.join(data_dir, "sim")
    create_linear_dataset(
        linear_root, cfg.n_trainval, z=cfg.z, box=cfg.box, nmesh=cfg.n_side,
        A_s_min=tr_lo, A_s_max=tr_hi, val_size=cfg.val_size,
        master_seed=cfg.master_seed, device=device)
    create_linear_dataset(
        linear_root, cfg.n_test, z=cfg.z, box=cfg.box, nmesh=cfg.n_side,
        A_s_min=te_lo, A_s_max=te_hi, test=True,
        master_seed=cfg.master_seed + 10_000, device=device)

    roots = {"linear": linear_root, "sim": sim_root}
    if any("sim" in EXPERIMENTS[e].values() for e in cfg.experiments):
        A_s_tv = draw_A_s(cfg.n_trainval, center=(tr_lo + tr_hi) / 2,
                          width=(tr_hi - tr_lo) / 2,
                          draw_seed=TRAIN_DRAW_SEED)
        A_s_te = draw_A_s(cfg.n_test, center=(te_lo + te_hi) / 2,
                          width=(te_hi - te_lo) / 2, draw_seed=TEST_DRAW_SEED)
        create_simulation_dataset(cfg, sim_root, cfg.n_trainval, A_s_tv,
                                  device=device)
        create_simulation_dataset(cfg, sim_root, cfg.n_test, A_s_te,
                                  test=True, device=device)

    results = {}
    exp_dir = os.path.join(data_dir, "experiments")
    os.makedirs(exp_dir, exist_ok=True)
    for name in cfg.experiments:
        results[name] = run_experiment(name, cfg, roots, exp_dir, plot=plot,
                                       device=device)
    results["wall_s"] = round(time.perf_counter() - t0, 2)
    with open(os.path.join(data_dir, "pipeline_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results
