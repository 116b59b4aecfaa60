"""The torch port's pipeline and CLI on the CPU: the tiny pipeline of
``tests/test_pipeline.py``, whose simulation source takes each member's
final state through ``state_to_delta`` in memory (settled: the card's
machine has no h5py) and must write the volumes that the JAX package's
route, HDF5 snapshots read back by ``snapshots_to_delta``, writes for
the same members; its resume by the volumes on disk; the pinned A_s
draws against the JAX package's; the experiment registry; ``cli
pipeline`` and ``cli train``; ``--help`` without h5py and matplotlib."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from nbody.driver import ensemble as jens
from nbody.driver import pipeline as jpipe
from nbody_torch.driver.ensemble import run_ensemble
from nbody_torch.driver.pipeline import (
    EXPERIMENTS,
    SIM_BATCH,
    PipelineConfig,
    create_simulation_dataset,
    main_pipeline,
)
from nbody_torch.emulator.data import delta_path, snapshots_to_delta

TINY = PipelineConfig(
    n_side=8, box=200.0, n_trainval=8, n_test=4, n_steps=3,
    epochs=3, batch_size=4, solver="pm", val_size=0.25,
)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The tiny pipeline, with the figure."""
    d = str(tmp_path_factory.mktemp("pipe"))
    return d, main_pipeline(TINY, d, plot=True, device="cpu")


def test_main_pipeline(run):
    d, results = run
    for name in TINY.experiments:
        r = results[name]
        assert np.isfinite(r["best_val_loss"])
        assert np.isfinite(r["abs_dev_percent"]).all()
        exp = os.path.join(d, "experiments")
        for f in (f"{name}_result.json", f"{name}_params.pt",
                  f"{name}_eval.png"):
            assert os.path.exists(os.path.join(exp, f)), f
    for root in ("linear", "sim"):
        assert os.path.exists(os.path.join(d, root, "MaxMinParams.txt"))
        assert os.path.exists(os.path.join(d, root, "TestParams.txt"))
    assert os.path.exists(os.path.join(d, "pipeline_results.json"))
    assert not any(f.endswith(".hdf5") for _, _, fs in os.walk(
        os.path.join(d, "sim")) for f in fs)


@pytest.mark.parametrize("test", [False, True])
def test_routes_write_the_same_volumes(run, tmp_path, test):
    """The pipeline's volumes (in memory) are the JAX package's route's
    for the same members: the ensemble with final HDF5 snapshots, then
    ``snapshots_to_delta``."""
    sim_root = os.path.join(run[0], "sim")
    n = TINY.n_test if test else TINY.n_trainval
    table = "TestParams.txt" if test else "TrainingParams.txt"
    A_s = np.loadtxt(os.path.join(sim_root, table), skiprows=1, ndmin=2)
    if not test:
        A_s = np.concatenate([A_s, np.loadtxt(os.path.join(
            sim_root, "ValParams.txt"), skiprows=1, ndmin=2)])
    sim = TINY.sim_config()
    sim = sim.replace(output=dataclasses.replace(sim.output, snapshot=True))
    ens = str(tmp_path / "ens")
    run_ensemble(sim, n, workdir=ens, master_seed=TINY.master_seed + test,
                 A_s_values=A_s[:, 0], batch=SIM_BATCH, device="cpu")
    files = snapshots_to_delta(ens, str(tmp_path / "etl"), TINY.n_side,
                               test=test, device="cpu")
    assert len(files) == n
    for i in range(1, n + 1):
        a = np.load(delta_path(str(tmp_path / "etl"), i, test))
        b = np.load(delta_path(sim_root, i, test))
        assert b.shape == (8, 8, 8, 1) and b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-5 * np.abs(a).max())
        assert abs(float(b.mean())) < 1e-5


def test_sim_source_resumes_by_volume(run, tmp_path):
    """A member whose volume is on disk is not run again; a missing one
    is, now alone in its batch, and comes back the same to float32's
    rounding (on the CPU a member's bits depend on its batch)."""
    import shutil

    root = str(tmp_path / "sim")
    shutil.copytree(os.path.join(run[0], "sim"), root)
    gone = delta_path(root, 3)
    before = np.load(gone)
    os.remove(gone)
    stamps = {i: os.stat(delta_path(root, i)).st_mtime_ns
              for i in range(1, TINY.n_trainval + 1) if i != 3}
    A_s = np.concatenate([np.loadtxt(os.path.join(root, f), skiprows=1,
                                     ndmin=2)[:, 0]
                          for f in ("TrainingParams.txt", "ValParams.txt")])
    create_simulation_dataset(TINY, root, TINY.n_trainval, A_s,
                              device="cpu")
    np.testing.assert_allclose(np.load(gone), before, rtol=0,
                               atol=1e-5 * np.abs(before).max())
    assert all(os.stat(delta_path(root, i)).st_mtime_ns == t
               for i, t in stamps.items())


def test_same_parameter_draws_as_jax(run):
    """The linear and sim test sets use the same pinned A_s draws, and
    they are the JAX package's."""
    d, _ = run
    lin = np.loadtxt(os.path.join(d, "linear", "TestParams.txt"),
                     skiprows=1, ndmin=2)
    sim = np.loadtxt(os.path.join(d, "sim", "TestParams.txt"), skiprows=1,
                     ndmin=2)
    np.testing.assert_allclose(lin[:, 0], sim[:, 0], rtol=1e-12)
    (_, _), (lo, hi) = jpipe.PipelineConfig(**{
        k: getattr(TINY, k) for k in ("sigma_train", "sigma_test")}).bands()
    want = jens.draw_A_s(TINY.n_test, center=(lo + hi) / 2,
                         width=(hi - lo) / 2, draw_seed=jens.TEST_DRAW_SEED)
    np.testing.assert_array_equal(sim[:, 0], want)
    assert TINY.bands() == jpipe.PipelineConfig(**{
        k: getattr(TINY, k) for k in ("sigma_train", "sigma_test")}).bands()


def test_experiment_registry():
    assert EXPERIMENTS == jpipe.EXPERIMENTS
    jfields = {f for f in jpipe.PipelineConfig.__dataclass_fields__}
    assert jfields <= set(PipelineConfig.__dataclass_fields__)
    # no HDF5 snapshot: the members' final states go to the ETL in memory
    assert not PipelineConfig().sim_config().output.snapshot


def test_cli_pipeline(tmp_path, capsys):
    from nbody_torch.driver.cli import main

    rc = main(["pipeline", "--data-dir", str(tmp_path), "--n-side", "8",
               "--box", "200", "--n-trainval", "8", "--n-test", "4",
               "--n-steps", "3", "--solver", "pm", "--epochs", "2",
               "--batch-size", "4", "--experiments", "SIM3",
               "--no-plot", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "SIM3" in out and "CLASS2SIM" not in out


def test_cli_train(run, tmp_path, capsys):
    from nbody_torch.driver.cli import main

    data = os.path.join(run[0], "linear")
    rc = main(["train", "--data-dir", data, "--epochs", "2",
               "--batch-size", "2", "--output", str(tmp_path),
               "--device", "cpu"])
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["epochs_run"] == 2 and "test" in info
    assert os.path.exists(tmp_path / "params.pt")
    with open(tmp_path / "train_result.json") as f:
        assert len(json.load(f)["history"]["train_loss"]) == 2
    with pytest.raises(ValueError, match="torch.distributed"):
        main(["train", "--data-dir", data, "--epochs", "1", "--devices", "2",
              "--output", str(tmp_path), "--device", "cpu"])


def test_cli_help_without_h5py_and_matplotlib(monkeypatch, capsys):
    from nbody_torch.driver.cli import main

    monkeypatch.setitem(sys.modules, "h5py", None)  # an import would raise
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for cmd in ([], ["simulate"], ["ensemble"], ["measure"], ["pipeline"],
                ["render"], ["sweep"], ["train"]):
        with pytest.raises(SystemExit) as e:
            main(cmd + ["--help"])
        assert e.value.code == 0, cmd
    assert "{simulate,ensemble,measure,pipeline,render,sweep,train}" in \
        capsys.readouterr().out
