"""Seeded ensemble runner: many realizations, resume and retry semantics.

Counterpart of :mod:`nbody.driver.ensemble`, which rebuilds the
reference's two CONCEPT orchestration drivers (`SnapVsPK/Ucertain.py`:
seed-only scatter ensembles with retries; `TheFeedingPipeline/
NeuNetværk_test.py`: A_s-varying NN-data ensembles, resume by skip,
missing-job detection, summary sidecars).  Each job is an in-process
simulation, so a retry guards only against a transient device error.

Two tiers, as in the JAX package: members one after another, each through
:func:`~nbody_torch.driver.simulate.run_simulation` with the ensemble's
config as its ``base``; or chunks of B members integrated at once
(:func:`run_members_batched`), where the JAX package wraps the run in
``jax.vmap``: here the state carries a leading member axis, the PM
deposit is one fixed-point sum over the members and the FFTs are
batched, and each kernel makes one launch for all B members: K1 on the
dense tier and in the Ewald PP force, K2 and K3 on the supercell tier,
K4 on the columns tier, K6 on the cells tier.  The plane tiers share one
capacity and window across the members, pre-warmed from all of them and
healed when any member overflows.
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Sequence

import numpy as np
import torch

from nbody_torch.core.types import ParticleState
from nbody_torch.driver.config import SimulationConfig
from nbody_torch.driver.simulate import (
    HEAL_ATTEMPTS,
    SAMPLE_EVERY_STEPS,
    _apply_capacity_memory,
    _device_dtype,
    _n_devices,
    _record_capacity_memory,
    build_cosmo_force,
    check_base,
    heal_capacity,
    measure_powerspec,
    prewarm_capacity,
    realize_ics,
    run_simulation,
)
from nbody_torch.integrate.cosmo_stepping import kdk_steps, log_a_steps
from nbody_torch.io.sidecars import (
    BoxParams,
    MaxMinParams,
    write_box_params,
    write_maxmin_params,
    write_param_table,
)

# Fixed draw seeds: the reference's pinned 420 (train/val) and 39 (test)
# parameter draws (`Cosmo data create (new).py:175-176,235`).
TRAIN_DRAW_SEED = 420
TEST_DRAW_SEED = 39


def make_seeds(n: int, master_seed: int = 0) -> np.ndarray:
    """n independent realization seeds (the role of the reference's
    ``random_seeds`` overrides, `Ucertain.py:57-61`)."""
    return np.random.default_rng(master_seed).integers(2**31, size=n)


def draw_A_s(n: int, center: float = 2.105e-9, width: float = 0.6e-9,
             draw_seed: int = TRAIN_DRAW_SEED) -> np.ndarray:
    """Uniform A_s draws in [center - width, center + width] with a pinned
    seed: the reference's +/- sigma-band label sampling
    (`Feeder_pipe.py:243-250`; the test band inside the training band)."""
    rng = np.random.default_rng(draw_seed)
    return rng.uniform(center - width, center + width, size=n)


@dataclasses.dataclass
class EnsembleResult:
    run_dirs: list
    params: np.ndarray  # (n, 3): (A_s, n_s, omega_cdm) per member
    seeds: np.ndarray
    failed: list  # indices that failed after all retries
    skipped: list  # indices resumed by skip
    wall_s: float


def _run_dir(root: str, idx: int, A_s: float) -> str:
    # the reference's id0000_A_s... run directory layout
    return os.path.join(root, f"id{idx:04d}_A_s{A_s:.6e}")


def _final_snapshot(run_dir: str, config: SimulationConfig) -> str:
    return os.path.join(run_dir, "snapshots",
                        f"snapshot_a={config.a_end:.2f}.hdf5")


def find_missing_jobs(root: str, config: SimulationConfig,
                      params: np.ndarray) -> list:
    """Indices whose run directory lacks the final snapshot (the
    reference's `find_missing_jobs`, `NeuNetværk_test.py:297-313`)."""
    return [i for i in range(len(params))
            if not os.path.exists(_final_snapshot(
                _run_dir(root, i, float(params[i, 0])), config))]


def realize_members(config: SimulationConfig, seeds, A_s_values,
                    base: SimulationConfig | None = None, *,
                    device="cuda", dtype=None, noise=None) -> ParticleState:
    """The B members' LPT ICs, stacked along a leading axis: member b is
    ``config`` with A_s = ``A_s_values[b]`` realized from ``seeds[b]``
    (a CPU generator each) or from ``noise[b]`` (noise (B, n, n, n)), on
    the anchor ``base`` (or ``config``), as
    :func:`~nbody_torch.driver.simulate.realize_ics` realizes a member of
    the sequential tier: the same bits."""
    anchor = base or config
    states = [realize_ics(config.replace(A_s=float(A_s)), int(seed),
                          device=device, dtype=dtype, base=anchor,
                          noise=None if noise is None else noise[b])
              for b, (seed, A_s) in enumerate(zip(seeds, A_s_values))]
    return ParticleState(pos=torch.stack([s.pos for s in states]),
                         vel=torch.stack([s.vel for s in states]),
                         mass=torch.stack([s.mass for s in states]),
                         time=states[0].time)


def run_members_batched(config: SimulationConfig, seeds, A_s_values,
                        base: SimulationConfig | None = None, *,
                        device="cuda", dtype=None, noise=None,
                        log=None) -> ParticleState:
    """Integrate B realizations at once: their ICs
    (:func:`realize_members`), then the fixed log-a KDK of
    ``config`` on the batched state (one force evaluation at the start and
    one a step, each over all B members: one launch of each kernel, the
    FFTs batched), as the JAX package's ``vmap`` of one member's run.
    Every member shares every config field but A_s with the anchor
    (``base`` or ``config``); its force is the anchor's, on every solver
    and P3M tier.

    The steps go in the stretches of
    :func:`~nbody_torch.driver.simulate.run_simulation`.  Before each, the
    plane tiers' capacities are pre-warmed from all members' positions
    (:func:`~nbody_torch.driver.simulate.prewarm_capacity`), and a stretch
    whose overflow word (the batch's: each field the neediest member's) is
    not 0 is healed (:func:`~nbody_torch.driver.simulate.heal_capacity`)
    and re-run from its start for the whole batch, with the run's
    capacity memory as in ``run_simulation``.  (The JAX package's batched
    runner builds an unchecked force and drops the force of an overflowed
    particle without a word.)  ``log(msg)`` receives the run.log lines of
    the pre-warms and heals (default: printed).  Since the column sums
    and K2's deposit do not depend on the capacities, each member ends in
    the bits of its own run.  Returns the batched final state: pos, vel
    (B, N, 3), mass (B, N)."""
    device, dtype = _device_dtype(device, dtype)
    anchor = check_base(config, base)
    if _n_devices(anchor, device) > 1:
        raise ValueError("run_members_batched runs its members on one "
                         "device (config.devices = 1)")
    if log is None:
        def log(msg: str) -> None:
            print(f"[batch] {msg}", flush=True)
    state = realize_members(config, seeds, A_s_values, anchor,
                            device=device, dtype=dtype, noise=noise)
    cosmo = anchor.cosmology()
    a_grid = log_a_steps(config.a_begin, config.a_end, config.n_steps)
    last = len(a_grid) - 1
    seg = max(4, SAMPLE_EVERY_STEPS)
    bounds = sorted(set(range(seg, last, seg)) | {last})
    cfg_run = _apply_capacity_memory(anchor)
    acc_fn = build_cosmo_force(cfg_run, device=device, dtype=dtype,
                               checked=True)
    g, prev, repeated = None, 0, 0
    for idx in bounds:
        a_seg = a_grid[prev:idx + 1]
        grown, lines = prewarm_capacity(anchor, cfg_run, state.pos)
        for line in lines:
            log(line)
        for _ in range(HEAL_ATTEMPTS):
            if grown is not cfg_run:
                cfg_run = grown
                acc_fn = build_cosmo_force(cfg_run, device=device,
                                           dtype=dtype, checked=True)
            new, g_new, overflow = kdk_steps(state, cosmo, a_seg, acc_fn,
                                             config.box, g=g)
            if overflow == 0:
                break
            repeated += len(a_seg) - 1 + (g is None)
            grown, line = heal_capacity(anchor, cfg_run, overflow)
            log(line)
        else:
            raise RuntimeError("P3M capacity retries exhausted in the "
                               "batched tier: state too clustered")
        state, g, prev = new, g_new, idx
    if repeated:
        log(f"Capacity heals repeated {repeated} force evaluations")
    _record_capacity_memory(anchor, cfg_run)
    return state


def run_ensemble(config: SimulationConfig, n_samples: int, workdir: str,
                 master_seed: int = 0,
                 A_s_values: Sequence[float] | None = None,
                 max_retries: int = 3, resume: bool = True,
                 split_name: str = "Training", batch: int = 0, *,
                 device="cuda", dtype=None, members=None,
                 on_final_state=None) -> EnsembleResult:
    """Run n_samples seeded realizations of ``config``, on the card unless
    ``device`` says otherwise.

    ``A_s_values``: per-member amplitudes (None: every member at
    config.A_s, a realization-scatter ensemble as `Ucertain.py`).  With
    ``batch`` <= 1 the members run one after another through
    :func:`~nbody_torch.driver.simulate.run_simulation` (``base=config``,
    each with its run.log, retried alone).  ``batch=B`` > 1 runs chunks
    of B members at once (:func:`run_members_batched`, a chunk retried
    as a whole; its pre-warm and heal lines go to every member's run.log)
    and writes each member's snapshot and P(k) afterwards.
    A member whose run dir holds its final snapshot is skipped
    (``resume``); one that fails ``max_retries`` times is recorded in
    ``failed`` and ``failures.log``.  The sidecars BoxParams,
    MaxMinParams and <split>Params go to ``workdir`` for the emulator.
    The snapshot writer needs h5py; with ``output.snapshot=False`` (the
    card's machine has no h5py) no final snapshot exists, so a resume
    finds none and runs every member again, as the JAX package's contract
    says.  ``members``, when given, names the members to run; the others
    are skipped (the emulator's pipeline resumes by the volumes it has
    written).  ``on_final_state(i, state)``, when given, receives each
    member run's final state (the pipeline's in-memory ETL)."""
    t0 = time.perf_counter()
    seeds = make_seeds(n_samples, master_seed)
    if A_s_values is None:
        A_s_values = np.full(n_samples, config.A_s)
    A_s_values = np.asarray(A_s_values, dtype=np.float64)
    if len(A_s_values) != n_samples:
        raise ValueError("len(A_s_values) != n_samples")

    params = np.column_stack([A_s_values, np.full(n_samples, config.n_s),
                              np.full(n_samples, config.omega_cdm)])
    os.makedirs(workdir, exist_ok=True)
    write_box_params(os.path.join(workdir, "BoxParams.txt"),
                     BoxParams(z=1.0 / config.a_end - 1.0, L=config.box,
                               N=config.n_side))
    write_maxmin_params(
        os.path.join(workdir, "MaxMinParams.txt"),
        MaxMinParams(A_s_min=float(A_s_values.min()),
                     A_s_max=float(A_s_values.max()),
                     n_s_min=config.n_s, n_s_max=config.n_s,
                     omega_cdm_min=config.omega_cdm,
                     omega_cdm_max=config.omega_cdm, n_samples=n_samples))
    write_param_table(os.path.join(workdir, f"{split_name}Params.txt"),
                      params)
    run_dirs = [_run_dir(workdir, i, float(A_s_values[i]))
                for i in range(n_samples)]
    failed, skipped = [], []
    wanted = set(range(n_samples) if members is None else members)

    def record(what: str) -> None:
        with open(os.path.join(workdir, "failures.log"), "a") as f:
            f.write(f"{what}:\n{traceback.format_exc()}\n")

    if batch > 1:
        todo = []
        for i in range(n_samples):
            if i not in wanted or (resume and os.path.exists(
                    _final_snapshot(run_dirs[i], config))):
                skipped.append(i)
            else:
                todo.append(i)
        for lo in range(0, len(todo), batch):
            chunk = todo[lo:lo + batch]
            states = None
            for attempt in range(max_retries):
                try:
                    states = run_members_batched(
                        config, seeds[chunk], A_s_values[chunk], base=config,
                        device=device, dtype=dtype,
                        log=_chunk_log(chunk, run_dirs))
                    break
                except Exception:  # noqa: BLE001 - retry, then record
                    if attempt == max_retries - 1:
                        failed.extend(chunk)
                        record(f"batch {chunk}")
            if states is None:
                continue
            _write_members(config, states, chunk, run_dirs, seeds, A_s_values)
            if on_final_state is not None:
                for j, i in enumerate(chunk):
                    on_final_state(i, ParticleState(
                        pos=states.pos[j], vel=states.vel[j],
                        mass=states.mass[j], time=states.time))
    else:
        for i in range(n_samples):
            member = config.replace(A_s=float(A_s_values[i]))
            rd = run_dirs[i]
            if i not in wanted or (resume and os.path.exists(
                    _final_snapshot(rd, member))):
                skipped.append(i)
                continue
            res = None
            for attempt in range(max_retries):
                try:
                    res = run_simulation(member, seed=int(seeds[i]),
                                         workdir=rd, base=config,
                                         device=device, dtype=dtype)
                    break
                except Exception:  # noqa: BLE001 - retry, then record
                    if attempt == max_retries - 1:
                        failed.append(i)
                        record(f"member {i}")
            if res is not None and on_final_state is not None:
                on_final_state(i, res.state)
    return EnsembleResult(run_dirs=run_dirs, params=params, seeds=seeds,
                          failed=failed, skipped=skipped,
                          wall_s=time.perf_counter() - t0)


def _chunk_log(chunk: list, run_dirs: list):
    """A batched chunk's run.log writer: each line to every member's."""
    def log(msg: str) -> None:
        for i in chunk:
            os.makedirs(run_dirs[i], exist_ok=True)
            with open(os.path.join(run_dirs[i], "run.log"), "a") as f:
                f.write(msg + "\n")

    return log


def _write_members(config: SimulationConfig, states: ParticleState,
                   chunk: list, run_dirs: list, seeds, A_s_values) -> None:
    """The batched tier's outputs, member by member: the final snapshot,
    the final P(k) (with the member's realization correction) and
    config.json, as the JAX package writes them after its ``vmap``."""
    from nbody_torch.io.snapshot import SnapshotMeta, write_snapshot

    cosmo = config.cosmology()
    tag = f"a={config.a_end:.2f}"
    for j, i in enumerate(chunk):
        member = config.replace(A_s=float(A_s_values[i]))
        st = ParticleState(pos=states.pos[j], vel=states.vel[j],
                           mass=states.mass[j], time=states.time)
        rd = run_dirs[i]
        if config.output.snapshot:
            write_snapshot(os.path.join(rd, "snapshots",
                                        f"snapshot_{tag}.hdf5"), st,
                           SnapshotMeta.from_cosmology(cosmo, config.box,
                                                       a=config.a_end))
        if config.output.powerspec:
            measure_powerspec(st.pos, member, config.a_end,
                              path=os.path.join(rd, "powerspec",
                                                f"powerspec_{tag}"),
                              seed=int(seeds[i]))
        member.save(os.path.join(rd, "config.json"))
