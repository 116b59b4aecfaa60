"""Make the JAX-side reference data that the torch port is held to on the
GPU, where JAX is not installed.

Writes, under ``tests/data/torch_port/``:

* ``white_noise_n16_seed0.npy``: the real white noise (16, 16, 16)
  float32 that ``nbody.driver.simulate.realize_ics`` draws for
  ``SimulationConfig(n_side=16)`` and seed 0;
* ``powerspec_a=1.00_n16_seed0``: the JAX package's CONCEPT-format P(k)
  at a = 1 of that run (142 fixed steps, P3M dense tier), float32 on the
  CPU;
* ``powerspec_a=1.00_n16_supercell_seed0``: the same run with
  ``shortrange='supercell'`` (chaining grid 4, S = 8), the Pallas kernels
  in interpret mode;
* ``powerspec_a=1.00_n16_rungs3_seed0`` and
  ``powerspec_a=1.00_n16_supercell_rungs3_seed0``: the same two tiers
  with ``rungs=3`` (dense tier: interior ticks on the two-plane cell
  kernel; supercell tier: frozen column plans, interior ticks on the
  masked column kernel), and
  ``rung_population_n16[_supercell]_rungs3_seed0.txt``, their per-step
  "Rung population" counts from run.log (columns: step, then the count on
  each rung).  These two start at a = 0.3 and take 6 steps: at 16^3 in a
  500 Mpc box the 142 steps from a = 0.02 put a particle above rung 0 at
  8 of the 142 steps only, while these steps populate rungs 1 and 2 at
  every step;
* ``powerspec_a=1.00_n16_pp_seed0``: the same 16^3 run with
  ``solver='pp'`` (the Ewald PP force: K1 with the Gaussian split in
  interpret mode, plus the k-space sum);
* ``powerspec_a=1.00_n16_domain2_seed0``, ``..._n16_domain4_seed0``,
  ``..._n16_domain4_supercell_seed0`` and ``..._n16_domain4_columns_seed0``:
  the same 16^3 run on the slab domain decomposition (``devices`` = 2 and
  4 of the 8-device CPU mesh; the cells tier, and at 4 devices the
  supercell and columns tiers), its P(k) from the sharded estimator.  The
  JAX driver's supercell branch reads a name ``sc`` at
  ``nbody/driver/simulate.py:1900`` that the function never defines (the
  chaining grid ``_domain_tier`` computes and drops); the script supplies
  that value as the module global the lookup falls through to, and changes
  nothing else;
* ``powerspec_a=1.00_n16_domain2_rungs3_seed0``,
  ``..._n16_domain4_rungs3_seed0`` and ``..._n16_domain4_cells_rungs3_seed0``
  with ``rung_population_n16_domain{2,4,4_cells}_rungs3_seed0.txt``: the
  rung runs (``rungs=3``, a = 0.3, 6 steps) on the slab domain
  decomposition, on 2 and 4 devices with the driver's auto skin (frozen
  local column plans for the interior ticks) and on 4 devices with
  ``column_skin=0`` (the masked cell planes).  The header of each
  population file keeps the run.log lines of that run's route and its
  frozen-plan staleness;
* ``powerspec_a=1.00_n16_pp_d4_seed0``: the 16^3 PP run on 4 devices
  (the ring Ewald force of ``nbody.distributed.sharding``), and
  ``sharded_p3m_n16_d4_seed0.npy``: (2, 4096, 3) float32, that run's IC
  positions and the output of ``make_sharded_p3m_cosmo_force`` on 4
  devices there (the config's eps and force split, a = a_begin; the
  masses are the config's particle mass);
* ``powerspec_a=1.00_n16_sub4_seed0``,
  ``..._n16_supercell_sub4_seed0`` and
  ``..._n16_domain4_supercell_sub4_seed0``: the same 16^3 run with
  ``subcycles=4`` (the split-Hamiltonian KDK: the dense tier; the
  supercell tier with frozen column plans for the interior subcycles and
  the fused boundary tick; the supercell tier on 4 devices of the slab
  domain decomposition);
* ``white_noise_n16_domain4_seed0.npy``: (4, 4, 16, 16) float32, the
  per-slab white noise ``nbody.distributed.ic.lpt_ic_domain`` draws for
  ``SimulationConfig(n_side=16)``, seed 0 and 4 devices (one key a slab,
  ``jax.random.split(key, 4)``);
  ``lpt_ic_domain_n16_domain4_order{1,2}_seed0.npz``: the slab-resident ICs of that draw (``counts``: each shard's particles,
  which lead its rows; ``pos``, ``vel``: those rows in shard order,
  float32; ``mass``, ``capacity``: the particle mass and the rows a
  shard); ``realized_spectrum_n16_domain4_seed0.txt``:
  ``nbody.distributed.measure.realized_spectrum_domain`` of the same
  draw on the config's 48 P(k) bins (columns: k, modes, P);
* ``plummer4096_energy_seed0.txt``: the energy and momentum series of
  ``systems.plummer(4096, seed=0)`` (float32) over 200 KDK steps of
  ``allpairs_pallas`` (eps 0.05, dt 1e-3, interpret mode), sampled every
  25 steps and at the start (columns: step, time, E_kin, E_pot, E, the
  three momentum components);
* ``powerspec_a=1.00_n16_adaptive_seed0``,
  ``..._n16_adaptive_sub4_seed0``, ``..._n16_adaptive_rungs3_seed0`` and
  ``..._n16_domain4_adaptive_rungs2_seed0``: the same 16^3 run with
  ``time_stepping='adaptive'`` (the plain KDK and ``subcycles=4`` from
  a = 0.02; ``rungs=3``, and ``rungs=2`` on 4 devices of the slab domain
  decomposition, from a = 0.3 like the rung runs), and
  ``adaptive_steps_n16{tag}_seed0.txt`` beside each: its run.log's
  "Time step ... dln(a) = ..." lines (one a stretch of steps: the step
  count so far, a and the last step's dln(a)) and its "Total adaptive
  steps" line;
* ``white_noise_n16_ensemble4_seed0.npy``: (4, 16, 16, 16) float32, the
  white noise of each of the 4 members of a 16^3 ensemble
  (``ensemble_n16_members_seed0.txt``: each member's seed,
  ``nbody.driver.ensemble.make_seeds(4, 0)``, and A_s,
  ``draw_A_s(4)``), and ``powerspec_a=1.00_n16_ensemble4_member{b}_seed0``:
  the P(k) at a = 1 of member b of ``run_members_batched(CONFIG, seeds,
  A_s, base=CONFIG)`` (the ``vmap`` of the fixed-step run, P3M dense tier;
  K1 in interpret mode), measured with ``measure_powerspec``;
* ``emulator_n16_seed0.npz``: the 16^3 emulator fixture: 20 volumes of
  ``create_linear_dataset`` (box 500, the pipeline's +-20 sigma A_s band,
  val_size 0.25) as ``DeltaDataset`` splits (``X_train``, ``y_train``,
  ``X_val``, ``y_val``, ``maxima``), the init params of
  ``CosmoCNN(n_out=1, n_conv=2, dropout_rate=0)`` that
  ``_fit_host_loop`` draws for seed 0 (``param:<layer>/<name>``), and
  that loop's history over 3 epochs at batch 4, lr 4e-3, no augmentation
  (``train_loss``, ``val_loss``, ``lr``, ``best_epoch``,
  ``best_val_loss``).

It also checks that the port's ICs from the saved noise equal the JAX
package's ICs.  Run from the repository root on a CPU machine with JAX:

    python scripts/torch_port_reference.py [pk] [pp] [plummer] [domain]
        [domain_rungs] [sharded] [sub] [domain_ic] [adaptive] [ensemble]
        [emulator] [_TAG ...]

where ``pk`` writes the noise and the dense, supercell and rung files,
``pp`` the PP run's P(k), ``plummer`` the Plummer series, ``domain``
the four domain runs' P(k), ``domain_rungs`` the three domain rung
runs, ``sharded`` the 4-device PP run's P(k) and the sharded P3M
force, ``sub`` the three subcycled runs' P(k), ``domain_ic`` the
domain draw, its ICs and its realized spectrum, ``adaptive`` the four
adaptive runs, ``ensemble`` the batched 16^3 ensemble and ``emulator``
the emulator fixture (all eleven without arguments); an argument ``_TAG`` runs the one run of that file-name tag
(e.g. ``_sub4``), so that the runs can go in parallel processes.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("NBODY_NO_COMPILE_CACHE", "1")
# the domain runs shard over a virtual 8-device CPU mesh (tests/conftest.py)
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nbody.driver.config import OutputConfig, SimulationConfig  # noqa: E402
from nbody.driver.simulate import realize_ics, run_simulation  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "data", "torch_port")
SEED = 0
CONFIG = SimulationConfig(n_side=16, output=OutputConfig(snapshot=False))
#: the rung runs: a late start and few steps, so that every step has
#: particles above rung 0
RUNG_CONFIG = CONFIG.replace(rungs=3, a_begin=0.3, n_steps=6)
#: the committed runs: file-name tag -> config, all from the same noise
RUNS = {"": CONFIG, "_supercell": CONFIG.replace(shortrange="supercell"),
        "_rungs3": RUNG_CONFIG,
        "_supercell_rungs3": RUNG_CONFIG.replace(shortrange="supercell")}
PP_RUNS = {"_pp": CONFIG.replace(solver="pp")}
SHARDED_RUNS = {"_pp_d4": CONFIG.replace(solver="pp", devices=4)}
DOMAIN_RUNS = {
    "_domain2": CONFIG.replace(devices=2),
    "_domain4": CONFIG.replace(devices=4),
    "_domain4_supercell": CONFIG.replace(devices=4, shortrange="supercell"),
    "_domain4_columns": CONFIG.replace(devices=4, shortrange="columns"),
}
#: the split-Hamiltonian KDK (scripts/parity_study.py's default subcycles)
SUB_RUNS = {
    "_sub4": CONFIG.replace(subcycles=4),
    "_supercell_sub4": CONFIG.replace(shortrange="supercell", subcycles=4),
    "_domain4_supercell_sub4": CONFIG.replace(devices=4,
                                              shortrange="supercell",
                                              subcycles=4),
}
#: adaptive stepping: the plain and subcycled KDK over the whole run, the
#: rung runner and the domain runner from the rung runs' a = 0.3
ADAPTIVE_RUNS = {
    "_adaptive": CONFIG.replace(time_stepping="adaptive"),
    "_adaptive_sub4": CONFIG.replace(time_stepping="adaptive", subcycles=4),
    "_adaptive_rungs3": RUNG_CONFIG.replace(time_stepping="adaptive"),
    "_domain4_adaptive_rungs2": RUNG_CONFIG.replace(
        time_stepping="adaptive", rungs=2, devices=4),
}
#: the slab-resident ICs: shards and LPT orders
DOMAIN_IC_DEVICES = 4
DOMAIN_IC_ORDERS = (1, 2)
DOMAIN_RUNG_RUNS = {
    "_domain2_rungs3": RUNG_CONFIG.replace(devices=2),
    "_domain4_rungs3": RUNG_CONFIG.replace(devices=4),
    "_domain4_cells_rungs3": RUNG_CONFIG.replace(devices=4, column_skin=0.0),
}
#: run.log lines kept beside a domain rung run's data: its route and the
#: frozen plans' staleness
ROUTE_WORDS = ("Domain decomposition", "staleness", "drift note")
#: the Plummer drive: N, seed, eps, dt, steps, sample stride
PLUMMER = dict(n=4096, seed=0, eps=0.05, dt=1e-3, steps=200, every=25)


def rung_populations(log_path: str, n_rungs: int) -> np.ndarray:
    """(n_steps, 1 + n_rungs) int array of run.log's "Rung population"
    lines: the step, then the count on each rung (0 where the line stops
    at a shallower rung)."""
    rows = []
    with open(log_path) as f:
        for line in f:
            if "Rung population" not in line:
                continue
            step = int(line.split()[2])
            pops = [int(x) for x in line.split("matter:")[1].split(",")]
            rows.append([step] + pops + [0] * (n_rungs - len(pops)))
    return np.array(rows, dtype=np.int64)


def plummer_series() -> None:
    """The Plummer drive's energy and momentum series."""
    from nbody.forces import allpairs_pallas
    from nbody.ic import systems
    from nbody.integrate import run_with_diagnostics

    p = PLUMMER
    state = systems.plummer(p["n"], seed=p["seed"])
    _, d0, diags = run_with_diagnostics(
        state, p["dt"], p["steps"],
        lambda pos, m: allpairs_pallas(pos, m, eps=p["eps"]),
        diag_every=p["every"])
    rows = [[0, float(d0.time), float(d0.e_kin), float(d0.e_pot)]
            + [float(x) for x in np.asarray(d0.momentum)]]
    for k in range(p["steps"] // p["every"]):
        rows.append([(k + 1) * p["every"], float(diags.time[k]),
                     float(diags.e_kin[k]), float(diags.e_pot[k])]
                    + [float(x) for x in np.asarray(diags.momentum[k])])
    rows = np.array(rows)
    rows = np.concatenate([rows[:, :4], rows[:, 2:3] + rows[:, 3:4],
                           rows[:, 4:]], axis=1)
    name = f"plummer{p['n']}_energy_seed{p['seed']}.txt"
    np.savetxt(os.path.join(OUT, name), rows, fmt="%.9e",
               header=f"plummer(n={p['n']}, seed={p['seed']}) float32, "
                      f"allpairs_pallas eps={p['eps']}, dt={p['dt']}, "
                      f"{p['steps']} KDK steps\n"
                      "step time E_kin E_pot E px py pz")
    drift = np.abs(rows[:, 4] - rows[0, 4]).max() / abs(rows[0, 4])
    print(f"wrote {name}: |dE/E| {drift:.3e}, max |p| "
          f"{np.abs(rows[:, 5:]).max():.3e}")


def sharded_p3m_force(ics) -> None:
    """make_sharded_p3m_cosmo_force on 4 devices at the 16^3 ICs."""
    from nbody.distributed.sharding import (
        device_mesh,
        make_sharded_p3m_cosmo_force,
    )

    mesh = device_mesh(4)
    fn = make_sharded_p3m_cosmo_force(
        CONFIG.cosmology(), CONFIG.box, CONFIG.mesh_size, mesh,
        eps=CONFIG.eps, split=CONFIG.force_split)
    g = np.asarray(jax.jit(fn)(ics.pos, ics.mass,
                               jnp.asarray(CONFIG.a_begin, ics.pos.dtype)))
    name = "sharded_p3m_n16_d4_seed0.npy"
    np.save(os.path.join(OUT, name), np.stack([np.asarray(ics.pos), g]))
    print(f"wrote {name}: positions and force {g.shape} {g.dtype}, max |g| "
          f"{np.linalg.norm(g, axis=1).max():.6e}")


def domain_ics() -> None:
    """The per-slab draw of ``lpt_ic_domain`` on 4 devices, its ICs at
    both LPT orders and ``realized_spectrum_domain`` of it; checks the
    port's ``lpt_ic_domain`` and ``realized_spectrum_domain`` from the
    saved draw against them."""
    import torch

    from nbody.distributed.ic import lpt_ic_domain
    from nbody.distributed.measure import realized_spectrum_domain
    from nbody.distributed.sharding import device_mesh
    from nbody.driver.simulate import _linear_power_fn, _measurement_options
    from nbody.ic.gaussian import GRFSpec
    from nbody_torch.distributed.ic import lpt_ic_domain as t_lpt_ic_domain
    from nbody_torch.distributed.measure import (
        realized_spectrum_domain as t_realized,
    )
    from nbody_torch.distributed.sharding import device_mesh as t_mesh
    from nbody_torch.driver import SimulationConfig as TorchConfig
    from nbody_torch.driver.simulate import _linear_power_fn as t_power_fn
    from nbody_torch.ic.gaussian import GRFSpec as TSpec

    D, n = DOMAIN_IC_DEVICES, CONFIG.n_side
    key = jax.random.key(SEED)
    keys = jax.random.split(key, D)
    noise = np.stack([np.asarray(jax.random.normal(
        k, (n // D, n, n), jnp.float32)) for k in keys])
    np.save(os.path.join(OUT, f"white_noise_n16_domain{D}_seed0.npy"), noise)
    mesh = device_mesh(D)
    cosmo = CONFIG.cosmology()
    power = _linear_power_fn(cosmo, CONFIG.transfer)
    spec = GRFSpec(nmesh=n, box=CONFIG.box)
    tcfg = TorchConfig.from_dict(CONFIG.to_dict())
    tcosmo = tcfg.cosmology()
    group = t_mesh(D, device="cpu")
    for order in DOMAIN_IC_ORDERS:
        st, ov = lpt_ic_domain(key, spec, power, cosmo, CONFIG.a_begin, mesh,
                               order=order)
        C = st.pos.shape[0] // D
        rows = [np.asarray(x).reshape(D, C, -1)
                for x in (st.pos, st.vel, st.mass)]
        counts = (rows[2][..., 0] > 0).sum(axis=1)
        for d in range(D):
            if not (rows[2][d, :counts[d], 0] > 0).all():
                raise SystemExit("a shard's particles do not lead its rows")
        pos = np.concatenate([rows[0][d, :counts[d]] for d in range(D)])
        vel = np.concatenate([rows[1][d, :counts[d]] for d in range(D)])
        mass = float(rows[2][0, 0, 0])
        name = f"lpt_ic_domain_n16_domain{D}_order{order}_seed0.npz"
        np.savez(os.path.join(OUT, name), counts=counts.astype(np.int64),
                 pos=pos.astype(np.float32), vel=vel.astype(np.float32),
                 mass=np.float32(mass), capacity=np.int64(C))
        shards, tov = t_lpt_ic_domain(
            SEED, TSpec(nmesh=n, box=CONFIG.box),
            t_power_fn(tcosmo, tcfg.transfer), tcosmo, CONFIG.a_begin, group,
            order=order, noise=list(noise))
        tpos = torch.cat([s.pos for s in shards]).numpy()
        tvel = torch.cat([s.vel for s in shards]).numpy()
        dp = tpos - np.asarray(st.pos)
        dp -= CONFIG.box * np.round(dp / CONFIG.box)
        dv = np.abs(tvel - np.asarray(st.vel)).max()
        print(f"wrote {name}: overflow {int(ov)}, shard counts "
              f"{counts.tolist()} of C = {C}; the port from the saved draw: "
              f"max |dpos| {np.abs(dp).max():.3e} Mpc, max |dvel| / max |vel| "
              f"{dv / np.abs(np.asarray(st.vel)).max():.3e}, overflow {tov}")
        if int(ov) or tov or np.abs(dp).max() > 1e-5 * CONFIG.box:
            raise SystemExit("port domain ICs differ from the JAX ICs")
    edges = _measurement_options(CONFIG)[0]
    res = realized_spectrum_domain(key, spec, power, mesh, edges)
    table = np.stack([np.asarray(res.k), np.asarray(res.n_modes),
                      np.asarray(res.power)], axis=1)
    name = f"realized_spectrum_n16_domain{D}_seed0.txt"
    np.savetxt(os.path.join(OUT, name), table, fmt="%.9e",
               header=f"realized_spectrum_domain of white_noise_n16_domain{D}"
                      f"_seed0.npy on SimulationConfig(n_side=16)'s "
                      f"{len(edges) - 1} P(k) bins\nk modes P")
    got = t_realized(SEED, TSpec(nmesh=n, box=CONFIG.box),
                     t_power_fn(tcosmo, tcfg.transfer), group, edges,
                     noise=list(noise))
    m = table[:, 1] > 0
    rel = np.abs(got.power.numpy()[m] / table[m, 2] - 1.0).max()
    print(f"wrote {name}: {int(m.sum())} populated bins; the port from the "
          f"saved draw: max rel {rel:.3e}")
    if rel > 1e-4:
        raise SystemExit("port realized spectrum differs from JAX's")


#: the batched ensemble: members of CONFIG
ENSEMBLE_MEMBERS = 4


def ensemble_runs() -> None:
    """The 16^3 batched ensemble's noise, seeds and A_s, and each member's
    final P(k); checks that the port's member ICs from the saved noise
    (``base=CONFIG``) equal the JAX package's."""
    import torch

    from nbody.driver.ensemble import draw_A_s, make_seeds, run_members_batched
    from nbody.driver.simulate import measure_powerspec
    from nbody_torch.driver import SimulationConfig as TorchConfig
    from nbody_torch.driver.simulate import realize_ics as torch_ics

    seeds = make_seeds(ENSEMBLE_MEMBERS, SEED)
    A_s = draw_A_s(ENSEMBLE_MEMBERS)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.key(int(s)), (CONFIG.n_side,) * 3, jnp.float32))
        for s in seeds])
    tag = f"n16_ensemble{ENSEMBLE_MEMBERS}_seed{SEED}"
    np.save(os.path.join(OUT, f"white_noise_{tag}.npy"), noise)
    np.savetxt(os.path.join(OUT, f"ensemble_n16_members_seed{SEED}.txt"),
               np.column_stack([seeds, A_s]), fmt=["%d", "%.17g"],
               header="seed A_s")
    base = TorchConfig.from_dict(CONFIG.to_dict())
    for b in range(ENSEMBLE_MEMBERS):
        member = CONFIG.replace(A_s=float(A_s[b]))
        ref = realize_ics(member, int(seeds[b]), base=CONFIG)
        port = torch_ics(base.replace(A_s=float(A_s[b])), 0, device="cpu",
                         dtype=torch.float32, noise=noise[b], base=base)
        d = np.asarray(ref.pos) - port.pos.numpy()
        d -= CONFIG.box * np.round(d / CONFIG.box)
        if np.abs(d).max() > 1e-3:
            raise SystemExit(f"member {b}: port ICs differ from the JAX ICs")
    t0 = time.perf_counter()
    states = run_members_batched(CONFIG, seeds, A_s, base=CONFIG)
    pos = np.asarray(states.pos)
    print(f"JAX batched ensemble ({ENSEMBLE_MEMBERS} members): "
          f"{time.perf_counter() - t0:.1f} s")
    for b in range(ENSEMBLE_MEMBERS):
        name = f"powerspec_a=1.00_n16_ensemble{ENSEMBLE_MEMBERS}_member{b}" \
               f"_seed{SEED}"
        measure_powerspec(jnp.asarray(pos[b]),
                          CONFIG.replace(A_s=float(A_s[b])), CONFIG.a_end,
                          path=os.path.join(OUT, name))
        print(f"  wrote {name}")


#: the emulator fixture: volumes, split, fit
EMULATOR = dict(n=20, nmesh=16, box=500.0, val_size=0.25, batch_size=4,
                epochs=3, lr=4e-3, seed=0)


def emulator_fixture() -> None:
    """The 16^3 emulator fixture: the volumes and labels, the init
    params ``_fit_host_loop`` draws for its seed and its 3-epoch history
    with dropout 0 and no augmentation."""
    from nbody.driver.pipeline import A_S_CENTER, A_S_SIGMA
    from nbody.emulator.data import DeltaDataset, create_linear_dataset
    from nbody.emulator.model import CosmoCNN
    from nbody.emulator.train import _fit_host_loop

    e = EMULATOR
    with tempfile.TemporaryDirectory() as root:
        create_linear_dataset(root, e["n"], z=0.0, box=e["box"],
                              nmesh=e["nmesh"],
                              A_s_min=A_S_CENTER - 20 * A_S_SIGMA,
                              A_s_max=A_S_CENTER + 20 * A_S_SIGMA,
                              val_size=e["val_size"])
        train = DeltaDataset.from_directory(root, "train")
        val = DeltaDataset.from_directory(root, "val")
    model = CosmoCNN(n_out=1, n_conv=2, dropout_rate=0.0)
    # the init of _fit_host_loop (nbody/emulator/train.py:366-373)
    _, kinit = jax.random.split(jax.random.key(e["seed"]))
    params = model.init({"params": kinit, "dropout": kinit, "sample": kinit},
                        jnp.zeros((1,) + (e["nmesh"],) * 3, jnp.float32),
                        deterministic=True)["params"]
    res = _fit_host_loop(
        model, train, val, epochs=e["epochs"], batch_size=e["batch_size"],
        lr=e["lr"], seed=e["seed"], augment=False, kl_weight=None,
        early_stop_patience=None, early_stop_start=300,
        reduce_lr_patience=None, reduce_lr_factor=0.5, min_lr=1e-5,
        checkpoint_path=None, verbose=False, devices=1)
    flat = {f"param:{layer}/{name}": np.asarray(arr)
            for layer, group in params.items() for name, arr in group.items()}
    path = os.path.join(OUT, f"emulator_n{e['nmesh']}_seed{e['seed']}.npz")
    np.savez(path, X_train=train.X, y_train=train.y, X_val=val.X,
             y_val=val.y, maxima=train.maxima,
             train_loss=np.asarray(res.history["train_loss"]),
             val_loss=np.asarray(res.history["val_loss"]),
             lr=np.asarray(res.history["lr"]),
             best_epoch=res.best_epoch, best_val_loss=res.best_val_loss,
             **flat)
    print(f"emulator fixture: {len(train)} train, {len(val)} val volumes; "
          f"history {res.history['train_loss']} / {res.history['val_loss']};"
          f" wrote {os.path.basename(path)} ({os.path.getsize(path)} bytes)")


def main(which) -> None:
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(OUT, exist_ok=True)
    if "emulator" in which:
        emulator_fixture()
    if "plummer" in which:
        plummer_series()
    # the draw inside lpt_ic -> gaussian_delta_k -> white_noise_k
    noise = np.asarray(jax.random.normal(
        jax.random.key(SEED), (CONFIG.n_side,) * 3, jnp.float32))
    if "pk" not in which:
        saved = np.load(os.path.join(OUT, "white_noise_n16_seed0.npy"))
        if not np.array_equal(saved, noise):
            raise SystemExit("the committed white noise is not this draw")
    else:
        np.save(os.path.join(OUT, "white_noise_n16_seed0.npy"), noise)

    import torch

    from nbody_torch.driver import SimulationConfig as TorchConfig
    from nbody_torch.driver.simulate import realize_ics as torch_ics

    ref = realize_ics(CONFIG, SEED)
    port = torch_ics(TorchConfig.from_dict(CONFIG.to_dict()), SEED,
                     device="cpu", dtype=torch.float32, noise=noise)
    d = np.asarray(ref.pos) - port.pos.numpy()
    d -= CONFIG.box * np.round(d / CONFIG.box)
    dv = np.abs(np.asarray(ref.vel) - port.vel.numpy()).max()
    print(f"ICs from the saved noise: max |dpos| {np.abs(d).max():.3e} Mpc, "
          f"max |dvel| / max |vel| {dv / np.abs(np.asarray(ref.vel)).max():.3e}")
    if np.abs(d).max() > 1e-3 or dv > 1e-4 * np.abs(np.asarray(ref.vel)).max():
        raise SystemExit("port ICs differ from the JAX ICs")

    if "sharded" in which:
        sharded_p3m_force(ref)
    if "domain_ic" in which:
        domain_ics()
    if "ensemble" in which:
        ensemble_runs()
    every = dict(RUNS, **SHARDED_RUNS, **PP_RUNS, **DOMAIN_RUNS,
                 **DOMAIN_RUNG_RUNS, **SUB_RUNS, **ADAPTIVE_RUNS)
    runs = dict(RUNS if "pk" in which else {},
                **{tag: every[tag] for tag in which if tag.startswith("_")},
                **(SUB_RUNS if "sub" in which else {}),
                **(SHARDED_RUNS if "sharded" in which else {}),
                **(PP_RUNS if "pp" in which else {}),
                **(DOMAIN_RUNS if "domain" in which else {}),
                **(DOMAIN_RUNG_RUNS if "domain_rungs" in which else {}),
                **(ADAPTIVE_RUNS if "adaptive" in which else {}))
    for tag, cfg in runs.items():
        if cfg.devices > 1 and cfg.shortrange == "supercell":
            from nbody.driver import simulate
            from nbody.forces.p3m import p3m_short_params, supercell_ncell

            simulate.sc = supercell_ncell(
                cfg.box, cfg.mesh_size,
                p3m_short_params(cfg.box, cfg.mesh_size,
                                 cfg.n_particles)[1])
        with tempfile.TemporaryDirectory() as work:
            res = run_simulation(cfg, SEED, work)
            name = f"{os.path.basename(res.powerspecs[-1])}_n16{tag}_seed0"
            shutil.copy(res.powerspecs[-1], os.path.join(OUT, name))
            print(f"JAX run ({cfg.solver}, {cfg.shortrange}, rungs="
                  f"{cfg.rungs}, devices={cfg.devices}): "
                  f"{res.wall_s:.1f} s, wrote {name}")
            if cfg.time_stepping == "adaptive":
                with open(os.path.join(work, "run.log")) as f:
                    steps = [line.rstrip() for line in f
                             if "dln(a)" in line or "Total adaptive" in line
                             or "re-running" in line]
                sname = f"adaptive_steps_n16{tag}_seed0.txt"
                with open(os.path.join(OUT, sname), "w") as f:
                    f.write("\n".join(steps) + "\n")
                print(f"  {sname}: {steps[-1]}")
            if cfg.rungs and cfg.time_stepping == "fixed":
                log_path = os.path.join(work, "run.log")
                pops = rung_populations(log_path, cfg.rungs)
                pname = f"rung_population_n16{tag}_seed0.txt"
                with open(log_path) as f:
                    route = [line.rstrip() for line in f
                             if any(w in line for w in ROUTE_WORDS)]
                np.savetxt(os.path.join(OUT, pname), pops, fmt="%d",
                           header="\n".join(
                               [f"run.log: {line}" for line in route]
                               + ["step " + " ".join(
                                   f"rung{r}" for r in range(cfg.rungs))]))
                for line in route:
                    print(f"  {line}")
                deep = int((pops[:, 2:].sum(axis=1) > 0).sum())
                print(f"  {pname}: {len(pops)} steps, rungs >= 1 populated "
                      f"at {deep} of them")


if __name__ == "__main__":
    main(sys.argv[1:] or ["pk", "pp", "plummer", "domain", "domain_rungs",
                          "sharded", "sub", "domain_ic", "adaptive",
                          "ensemble", "emulator"])
