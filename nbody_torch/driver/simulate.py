"""Single simulation runs: config -> ICs -> KDK -> outputs.

Counterpart of :func:`nbody.driver.simulate.run_simulation` for the
single-device, fixed-step slice: LPT ICs, the comoving KDK with the PM or
P3M force (dense, supercell or columns short-range tier), the column
tiers' capacity pre-warm and self-heal, the Layzer-Irvine energy samples,
and P(k) and snapshot outputs at the output times, in the same run.log,
powerspec and snapshot formats.  The entry points run on the card unless
the caller passes ``device="cpu"``.  Options outside the slice raise
``NotImplementedError`` (``solver='pp'``, ``subcycles > 1``,
``rungs >= 2``, ``time_stepping='adaptive'``, more than one device, and
``shortrange='cells'``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable

import numpy as np
import torch

from nbody_torch.core import units
from nbody_torch.core.cosmology import Cosmology, TabulatedPowerSpectrum
from nbody_torch.core.types import ParticleState
from nbody_torch.diagnostics.layzer_irvine import (
    layzer_irvine_residual,
    peculiar_energies,
)
from nbody_torch.driver.config import SimulationConfig
from nbody_torch.forces.p3m import (
    auto_column_capacity,
    p3m_acc,
    p3m_short_params,
    resolve_shortrange,
    supercell_ncell,
)
from nbody_torch.forces.p3m_columns import column_window
from nbody_torch.forces.pm import make_pm_cosmo_force
from nbody_torch.ic.gaussian import GRFSpec, gaussian_delta_k
from nbody_torch.ic.zeldovich import lpt_ic
from nbody_torch.integrate.cosmo_stepping import kdk_steps, log_a_steps
from nbody_torch.io.checkpoint import (
    CHECKPOINT_NAME,
    load_checkpoint,
    save_checkpoint,
)
from nbody_torch.io.powerspec import write_powerspec
from nbody_torch.io.snapshot import SnapshotMeta, write_snapshot
from nbody_torch.mesh.cic import (
    bspline_deposit,
    bspline_deposit_interlaced_k,
    density_to_delta,
)
from nbody_torch.mesh.spectrum import concept_bin_edges, power_spectrum

#: steps between the run.log progress lines and Layzer-Irvine samples:
#: the a values at which the JAX driver ends its segments, so the energy
#: residual is the same quadrature over the same samples
SAMPLE_EVERY_STEPS = 32


@functools.lru_cache(maxsize=64)
def _linear_power_fn(cosmo: Cosmology, transfer: str) -> Callable:
    """Linear P(k, a=1) host callable (numpy k -> numpy P)."""
    if transfer in ("eh", "bbks"):
        return lambda k: cosmo.linear_power(k, a=1.0, transfer=transfer)
    return TabulatedPowerSpectrum.from_file(transfer)


def _device_dtype(device, dtype) -> tuple[torch.device, torch.dtype]:
    """The run's device and dtype: float32 unless given; the CUDA path
    runs float32 only (K1 is a float32 kernel)."""
    device = torch.device(device)
    dtype = torch.float32 if dtype is None else dtype
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"the CUDA path runs float32, got {dtype}")
    return device, dtype


def check_supported(config: SimulationConfig, device=None) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if config.solver == "pp":
        raise NotImplementedError("solver='pp' (Ewald PP, K7) is not ported yet")
    if config.subcycles > 1:
        raise NotImplementedError("subcycles > 1 (subcycled KDK) is not ported yet")
    if config.rungs >= 2:
        raise NotImplementedError("rungs >= 2 (rung stepping) is not ported yet")
    if config.time_stepping != "fixed":
        raise NotImplementedError(
            f"time_stepping={config.time_stepping!r} is not ported yet"
        )
    n_dev = config.devices
    if n_dev == 0:
        dev = torch.device(device) if device is not None else None
        n_dev = (torch.cuda.device_count()
                 if dev is not None and dev.type == "cuda" else 1)
    if n_dev > 1:
        raise NotImplementedError(
            f"devices={config.devices} (slab domain decomposition) is not "
            f"ported yet"
        )
    if config.solver == "p3m" and _resolved_shortrange(config) == "cells":
        raise NotImplementedError(
            "shortrange='cells' (the cell-plane tier, K6) is not ported yet")


def _resolved_shortrange(config: SimulationConfig) -> str:
    """The short-range tier p3m_acc uses for this config: the rule of
    :func:`resolve_shortrange` with the config's own or healed column
    capacity, except that an unported 'cells' comes back as 'cells' (for
    :func:`check_supported` to refuse).  The capacity bookkeeping keys on
    it.  'supercell' shares the columns tier's capacity knobs and overflow
    word on its own (possibly coarser) chaining grid."""
    r_cut = p3m_short_params(config.box, config.mesh_size,
                             config.n_particles)[1]
    if config.shortrange == "cells":
        return "allpairs" if config.box / r_cut < 3.0 else "cells"
    return resolve_shortrange(config.shortrange, config.n_particles,
                              config.box, r_cut, config.mesh_size,
                              config.column_capacity or None)


def _tier_ncell(config: SimulationConfig, tier: str) -> int:
    """Chaining-grid side of the resolved tier (the unit of the occupancy
    pre-warm and the capacity heal)."""
    r_cut = p3m_short_params(config.box, config.mesh_size,
                             config.n_particles)[1]
    if tier == "supercell":
        return supercell_ncell(config.box, config.mesh_size, r_cut)
    return max(3, int(config.box / r_cut))


def _tier_capacity(config: SimulationConfig):
    """(field_name, value-or-None) of the capacity knob of the config's
    resolved short-range tier."""
    if _resolved_shortrange(config) in ("columns", "supercell"):
        return "column_capacity", (config.column_capacity or None)
    return "cell_capacity", (config.cell_capacity or None)


def realize_ics(config: SimulationConfig, seed: int, *, device="cuda",
                dtype=None, noise=None) -> ParticleState:
    """LPT initial conditions at a_begin for the config's cosmology.

    The white noise is drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` (so a seed gives the same ICs on every device), or given as
    ``noise`` (real, (n_side,)*3), e.g. the JAX package's own draw."""
    device, dtype = _device_dtype(device, dtype)
    cosmo = config.cosmology()
    generator = None if noise is not None else torch.Generator().manual_seed(seed)
    return lpt_ic(
        GRFSpec(nmesh=config.n_side, box=config.box),
        _linear_power_fn(cosmo, config.transfer), cosmo, config.a_begin,
        order=config.lpt_order, generator=generator, noise=noise,
        device=device, dtype=dtype,
    )


def build_cosmo_force(config: SimulationConfig, *, device="cuda",
                      dtype=None, checked: bool = False) -> Callable:
    """acc_fn(pos, mass, a) -> canonical-momentum force for the config's
    solver ('pm' or 'p3m'), the Newtonian periodic force in comoving
    coordinates scaled by 1/a.  ``checked=True`` returns (g, overflow) for
    the checked integrator: overflow is 0 iff no force was dropped (the
    column tiers' field-encoded word, a 0-d tensor on the device)."""
    device, dtype = _device_dtype(device, dtype)
    check_supported(config, device)
    box, eps, G = config.box, config.eps, units.COSMO.G
    nmesh = config.mesh_size
    if config.solver == "pm":
        pm_fn = make_pm_cosmo_force(
            config.cosmology(), box, nmesh,
            deconvolve_p=config.deconvolve_p, interlace=config.interlace,
            grad_order=config.pm_gradient,
            cell_centered=config.cell_centered, device=device, dtype=dtype,
        )
        if not checked:
            return pm_fn
        return lambda pos, mass, a: (pm_fn(pos, mass, a), 0)

    _, tier_cap = _tier_capacity(config)

    def p3m_fn(pos, mass, a):
        acc, ov = p3m_acc(
            pos, mass, box, nmesh, G=G, eps=eps,
            deconvolve_p=config.deconvolve_p, interlace=config.interlace,
            split=config.force_split, shortrange=config.shortrange,
            softening=config.softening_kernel, capacity=tier_cap,
            window=config.column_window or None, with_overflow=True,
            grad_order=config.pm_gradient,
        )
        return (acc / a, ov) if checked else acc / a

    return p3m_fn


def _sigma8_from_pk(k: np.ndarray, P: np.ndarray, h: float) -> float:
    """Top-hat sigma_8 (R = 8 Mpc/h) from a binned spectrum (trapezoid in
    ln k over the measured range)."""
    good = (k > 0) & (P > 0)
    k, P = k[good], P[good]
    if k.size < 2:
        return float("nan")
    x = k * 8.0 / h
    W = 3.0 * (np.sin(x) - x * np.cos(x)) / x**3
    return float(
        np.sqrt(np.trapezoid(k**3 * P * W**2 / (2 * np.pi**2), np.log(k)))
    )


def _measurement_options(config: SimulationConfig):
    """(edges, bspline order, interlace) of the P(k) measurement."""
    nmesh = config.mesh_size
    n_bins = config.output.powerspec_bins
    order = {"cic": 2, "tsc": 3, "pcs": 4}[config.output.powerspec_interpolation]
    if config.output.powerspec_binning == "concept":
        edges = concept_bin_edges(
            config.box, nmesh, config.output.bins_per_decade,
            config.output.powerspec_k_max,
        )
    else:
        # explicit geomspace edges from the measurement mesh, shared by
        # every power_spectrum call of the run (the realization
        # correction's n_side grid included)
        k_fund = 2.0 * np.pi / config.box
        k_corner = k_fund * nmesh * np.sqrt(3.0) / 2.0 * 1.0000001
        edges = np.geomspace(k_fund * 0.999, k_corner, n_bins + 1)
    interlace = (
        bool(config.interlace)
        if config.output.powerspec_interlace < 0
        else bool(config.output.powerspec_interlace)
    )
    return edges, order, interlace


def measure_powerspec(pos, config: SimulationConfig, a: float,
                      path: str | None = None, seed: int | None = None):
    """B-spline deposit -> P(k) of a particle snapshot; optionally write
    the CONCEPT-format text file with corrected + linear columns.
    Returns (k, modes, P, P_corrected, P_linear) as numpy."""
    nmesh = config.mesh_size
    edges, order, interlace = _measurement_options(config)
    if interlace:
        rho_k = bspline_deposit_interlaced_k(pos, config.box, nmesh, order=order)
        delta = rho_k / (pos.shape[0] / nmesh**3)
        delta[0, 0, 0] = 0.0
    else:
        grid = bspline_deposit(pos, config.box, nmesh, order=order)
        delta = density_to_delta(grid, pos.shape[0])
    raw = power_spectrum(delta, config.box, is_fourier=interlace, edges=edges)
    corr = power_spectrum(delta, config.box, deconvolve_p=1,
                          is_fourier=interlace, edges=edges,
                          window_order=order)
    return _finish_powerspec(raw, corr, config, a, edges=edges, path=path,
                             seed=seed)


def _finish_powerspec(raw, corr, config: SimulationConfig, a: float, *,
                      edges, path: str | None = None,
                      seed: int | None = None):
    """Linear column, realization correction, sigma8 headers and the
    CONCEPT-format write, shared tail of the P(k) measurement."""
    nmesh = config.mesh_size
    k = raw.k.cpu().numpy()
    modes = raw.n_modes.cpu().numpy()
    cosmo = config.cosmology()
    if config.transfer in ("eh", "bbks"):
        P_lin = cosmo.linear_power(k, a=a, transfer=config.transfer)
    else:
        tab = _linear_power_fn(cosmo, config.transfer)
        P_lin = tab(k) * float(cosmo.growth_D(a)) ** 2
    keep = modes > 0
    k, modes = k[keep], modes[keep]
    P = raw.power.cpu().numpy()[keep]
    Pc = corr.power.cpu().numpy()[keep]
    P_lin = P_lin[keep]

    if config.output.realization_correction and seed is not None:
        # divide the drawn realization's own linear spectrum out of the
        # corrected column (CONCEPT's 'realization correction'): the same
        # seeded draw as realize_ics
        power1 = _linear_power_fn(config.cosmology(), config.transfer)
        dk = gaussian_delta_k(
            GRFSpec(nmesh=config.n_side, box=config.box), power1,
            generator=torch.Generator().manual_seed(seed),
            device=raw.k.device, dtype=raw.k.dtype,
        )
        realized = power_spectrum(dk, config.box, is_fourier=True, edges=edges)
        Pr = realized.power.cpu().numpy()[keep].astype(np.float64)
        P_th = np.asarray(power1(k), dtype=np.float64)
        Pc = Pc * np.where(Pr > 0, P_th / np.where(Pr > 0, Pr, 1.0), 1.0)
    if path is not None:
        write_powerspec(
            path, k, modes, P, P_corrected=Pc, P_linear=P_lin,
            a=a, gridsize=nmesh,
            sigma8=_sigma8_from_pk(k, P, config.h),
            sigma8_corrected=_sigma8_from_pk(k, Pc, config.h),
            sigma8_linear=_sigma8_from_pk(k, P_lin, config.h),
        )
    return k, modes, P, Pc, P_lin


@dataclasses.dataclass
class SimulationResult:
    state: ParticleState
    config: SimulationConfig
    seed: int
    snapshots: list
    powerspecs: list
    wall_s: float
    # the config the run finished with: the capacity knobs include every
    # pre-warm and self-heal the driver applied (== config when nothing
    # healed); the next run of the same geometry in this process starts
    # from them (_CAPACITY_MEMORY)
    config_run: SimulationConfig | None = None
    # per-sample Layzer-Irvine (a, T, W) when output.energy_log is on
    energy_samples: list | None = None


# In-process capacity carry-forward: runs of the same geometry cluster
# alike, so the capacities one run learned through pre-warms and heals
# start the next one (each heal costs a segment re-run).  Only fields the
# caller left at 0 (auto) take part: explicit capacities are respected.
# The port heals the column tiers' knobs only.
_CAPACITY_FIELDS = ("column_capacity", "column_window")
_CAPACITY_MEMORY: dict[tuple, dict[str, int]] = {}


def _capacity_signature(config: SimulationConfig) -> tuple:
    """Geometry + schedule fields that set a run's clustering statistics
    (and so its capacity demand)."""
    return (
        config.solver, config.box, config.n_side, config.mesh_size,
        _resolved_shortrange(config), config.force_split,
        config.rungs, config.subcycles, config.a_end, config.devices,
    )


def _apply_capacity_memory(config: SimulationConfig) -> SimulationConfig:
    mem = _CAPACITY_MEMORY.get(_capacity_signature(config))
    if not mem:
        return config
    learned = {f: v for f, v in mem.items() if v and not getattr(config, f)}
    return config.replace(**learned) if learned else config


def _record_capacity_memory(config: SimulationConfig,
                            cfg_run: SimulationConfig) -> None:
    mem = _CAPACITY_MEMORY.setdefault(_capacity_signature(config), {})
    for f in _CAPACITY_FIELDS:
        v = getattr(cfg_run, f)
        # only driver-learned values (auto in the caller's config); they
        # only ever grow above the auto default
        if v and not getattr(config, f):
            mem[f] = max(mem.get(f, 0), v)


#: attempts of one segment before the capacity heal gives up
HEAL_ATTEMPTS = 5


def column_knobs(config: SimulationConfig,
                 cfg_run: SimulationConfig) -> tuple[int, int, int]:
    """(ncell, capacity, window) of the column plane that the run of
    ``config`` builds with the knobs of ``cfg_run`` (its healed config):
    the explicit or healed values, else the auto sizing on the resolved
    tier's chaining grid."""
    tier = _resolved_shortrange(config)
    r_cut = p3m_short_params(config.box, config.mesh_size,
                             config.n_particles)[1]
    ncell = _tier_ncell(config, tier)
    ck = cfg_run.column_capacity or auto_column_capacity(config.n_particles,
                                                         ncell)
    w = cfg_run.column_window or column_window(config.box, r_cut, ck)
    return ncell, ck, w


def prewarm_capacity(config: SimulationConfig, cfg_run: SimulationConfig,
                     pos) -> tuple[SimulationConfig, list[str]]:
    """Before a stretch of steps, grow the column capacity and z-window of
    ``cfg_run`` to fit the positions' densest column and densest 3-cell
    z-run (with headroom for the stretch's clustering), which costs one
    pass over the positions instead of an overflow and a re-run.
    Returns (the grown config, its run.log lines)."""
    r_cut = p3m_short_params(config.box, config.mesh_size,
                             config.n_particles)[1]
    if (config.solver != "p3m"
            or _resolved_shortrange(config) not in ("columns", "supercell")
            or int(config.box / r_cut) < 3):
        return cfg_run, []
    nct, ck, cur_w = column_knobs(config, cfg_run)
    pos = torch.remainder(pos, config.box)
    c = torch.clamp((pos * (nct / config.box)).to(torch.int64), 0, nct - 1)
    cid = c[:, 0] * nct + c[:, 1]
    occ = int(torch.bincount(cid, minlength=nct**2).max())
    # a chunk's sources lie within +- r_cut in z of the 9 neighbour
    # columns: at most the densest 3-cell z-run (cell z-height
    # box/nct >= r_cut)
    cnt3 = torch.bincount(cid * nct + c[:, 2], minlength=nct**3).reshape(
        nct, nct, nct)
    run3 = cnt3 + torch.roll(cnt3, 1, dims=2) + torch.roll(cnt3, -1, dims=2)
    zrun = int(run3.max())
    lines = []
    # the 256-slot chunk scaled 1.15x for the density ratio between
    # columns + the measured z-run + alignment
    needed_w = -(-int(295 + 1.25 * zrun + 260) // 128) * 128
    if needed_w > cur_w:
        lines.append(f"pre-warming column z-window to {needed_w} "
                     f"(densest 3-cell z-run {zrun})")
        cfg_run = cfg_run.replace(column_window=needed_w)
    # the next 128-slot quantum above the densest column + 10%
    needed = -(-int(occ * 1.10 + 4) // 128) * 128
    if needed > ck:
        lines.append(f"pre-warming P3M column capacity to {needed} "
                     f"(densest bucket {occ})")
        cfg_run = cfg_run.replace(column_capacity=needed)
    return cfg_run, lines


def heal_capacity(config: SimulationConfig, cfg_run: SimulationConfig,
                  ov: int) -> tuple[SimulationConfig, str]:
    """Grow the knob of ``cfg_run`` that the overflow word ``ov`` names:
    window misses widen ``column_window`` 1.5x, bucket/ghost spills
    double ``column_capacity`` (and widen an explicit window with it).
    Returns (the healed config, its run.log line)."""
    _, ck, cur_w = column_knobs(config, cfg_run)
    if (ov >> 16) == 0:
        # window misses only: widen the window (p3m_acc clamps it to the
        # column stride, so over-widening only scans whole columns)
        new_w = -(-int(1.5 * cur_w) // 128) * 128
        return cfg_run.replace(column_window=new_w), (
            f"column z-window misses inside scan ({ov & 0xffff} slots) — "
            f"widening z-window to {new_w}, re-running segment")
    line = (f"P3M bucket overflow inside scan ({ov >> 16} particles) — "
            f"doubling column capacity to {2 * ck}, re-running segment")
    cfg_run = cfg_run.replace(column_capacity=2 * ck)
    if cfg_run.column_window:
        # keep an explicit window in step with the larger buckets
        cfg_run = cfg_run.replace(column_window=-(
            -int(1.5 * cfg_run.column_window) // 128) * 128)
    return cfg_run, line


def run_simulation(
    config: SimulationConfig,
    seed: int = 0,
    workdir: str | None = None,
    *,
    device="cuda",
    dtype=None,
    initial_state: ParticleState | None = None,
    checkpoint_every_steps: int | None = None,
    resume: bool = False,
) -> SimulationResult:
    """Run one full simulation: ICs at a_begin -> fixed log-a KDK to a_end.

    Output times (``config.output.snapshot_times``) are snapped onto the
    step grid; P(k) files and snapshots are written there under
    ``workdir`` (default ``config.output.dir``), with a CONCEPT-style
    run.log.  ``initial_state`` replaces the realized ICs.  The force is
    evaluated once per step plus once at the start (the last force of one
    stretch of steps is the first of the next).

    ``checkpoint_every_steps`` writes an atomic autosave checkpoint every
    k steps; ``resume=True`` continues from the workdir's autosave if
    there is one.

    The column tiers pre-warm their capacity and z-window from the state
    before each stretch of steps, and a stretch whose overflow word is
    not 0 re-runs from its start after a heal: window misses widen
    ``column_window`` 1.5x, bucket/ghost spills double ``column_capacity``
    (at most ``HEAL_ATTEMPTS`` attempts).  ``result.config_run`` is the
    healed config."""
    device, dtype = _device_dtype(device, dtype)
    check_supported(config, device)
    t0 = time.perf_counter()
    cosmo = config.cosmology()
    cfg_run = _apply_capacity_memory(config)
    acc_fn = build_cosmo_force(cfg_run, device=device, dtype=dtype,
                               checked=True)

    a_grid = log_a_steps(config.a_begin, config.a_end, config.n_steps)
    out_idx = sorted(
        {
            int(np.argmin(np.abs(a_grid - a)))
            for a in config.output.snapshot_times
            if config.a_begin < a <= config.a_end
        }
    )
    out_idx = [i for i in out_idx if i > 0]
    last = len(a_grid) - 1

    workdir = workdir if workdir is not None else config.output.dir
    snapshots, powerspecs = [], []
    if workdir:
        config.save(os.path.join(workdir, "config.json"))
    ckpt_path = (os.path.join(workdir, "autosave", CHECKPOINT_NAME)
                 if workdir else None)
    state, start_idx = None, 0
    if resume and ckpt_path and os.path.exists(ckpt_path):
        state, extra = load_checkpoint(ckpt_path, device=device, dtype=dtype)
        start_idx = int(extra["grid_index"])
    bounds = set(out_idx) | {last} | set(
        range(start_idx + SAMPLE_EVERY_STEPS, last, SAMPLE_EVERY_STEPS))
    if checkpoint_every_steps:
        bounds |= set(range(checkpoint_every_steps, last,
                            checkpoint_every_steps))
    bounds = sorted(i for i in bounds if i > start_idx)
    log_path = os.path.join(workdir, "run.log") if workdir else None

    def log(msg: str) -> None:
        if log_path:
            with open(log_path, "a") as f:
                f.write(msg + "\n")
        else:
            print(f"[run] {msg}", flush=True)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    col_like = config.solver == "p3m" and _resolved_shortrange(config) in (
        "columns", "supercell")
    rerun_evals = 0

    def segment_with_heal(st, g, a_seg):
        """One stretch of steps from ``st`` (``g`` its force or None),
        re-run from its start after each heal until nothing overflows."""
        nonlocal rerun_evals, cfg_run, acc_fn
        grown, lines = prewarm_capacity(config, cfg_run, st.pos)
        for line in lines:
            log(line)
        for _ in range(HEAL_ATTEMPTS):
            if grown is not cfg_run:
                cfg_run = grown
                acc_fn = build_cosmo_force(cfg_run, device=device,
                                           dtype=dtype, checked=True)
            new, g_new, overflow = kdk_steps(st, cosmo, a_seg, acc_fn,
                                             config.box, g=g)
            if overflow == 0:
                return new, g_new
            if not col_like:
                raise RuntimeError(
                    f"short-range force dropped for {overflow} particles")
            rerun_evals += len(a_seg) - 1 + (g is None)
            grown, line = heal_capacity(config, cfg_run, overflow)
            log(line)
        raise RuntimeError(
            "P3M cell capacity retries exhausted — state too clustered")

    ic_wall = 0.0
    if state is None and initial_state is not None:
        state = initial_state.to(device=device, dtype=dtype)
    elif state is None:
        t_ic = time.perf_counter()
        state = realize_ics(config, seed, device=device, dtype=dtype)
        sync()
        ic_wall = time.perf_counter() - t_ic

    log(
        f"nbody run: solver={config.solver} N={config.n_particles} "
        f"box={config.box:g} Mpc mesh={config.mesh_size} "
        f"a={config.a_begin:g}->{config.a_end:g} in {config.n_steps} steps"
        f" (seed={seed}, start_idx={start_idx})"
    )
    if ic_wall:
        log(f"Initial conditions realized ({ic_wall:.2f} s)")
    energy_samples: list[tuple[float, float, float]] = []

    def sample_energy(st) -> None:
        if not config.output.energy_log:
            return
        T, W = peculiar_energies(st, cosmo, config.box, config.mesh_size)
        energy_samples.append((float(st.time), float(T), float(W)))

    def log_energy() -> None:
        if len(energy_samples) < 2:
            return
        a_s, T_s, W_s = (np.array(c) for c in zip(*energy_samples))
        res = layzer_irvine_residual(a_s, T_s, W_s)
        log(
            f"Energy budget: T = {T_s[-1]:.6e}  W = {W_s[-1]:.6e}  "
            f"Layzer-Irvine residual = {100.0 * res:.2f}%"
        )

    def write_outputs(a: float) -> None:
        log_energy()
        tag = f"a={a:.2f}"
        if config.output.snapshot:
            spath = os.path.join(workdir, "snapshots", f"snapshot_{tag}.hdf5")
            write_snapshot(spath, state,
                           SnapshotMeta.from_cosmology(cosmo, config.box, a=a))
            snapshots.append(spath)
            log(f"Snapshot written: {spath}")
        if config.output.powerspec:
            ppath = os.path.join(workdir, "powerspec", f"powerspec_{tag}")
            measure_powerspec(state.pos, config, a, path=ppath, seed=seed)
            powerspecs.append(ppath)
            log(f"Power spectrum written: {ppath}")

    sample_energy(state)
    g = None
    prev = last_ckpt = start_idx
    for idx in bounds:
        t_seg = time.perf_counter()
        state, g = segment_with_heal(state, g, a_grid[prev: idx + 1])
        sync()
        sample_energy(state)
        log(
            f"Time step {idx:4d}   a = {a_grid[idx]:.4f}   "
            f"({idx - prev} steps in {time.perf_counter() - t_seg:.2f} s)"
        )
        if idx in out_idx and workdir:
            write_outputs(float(a_grid[idx]))
        if (checkpoint_every_steps and ckpt_path and idx < last
                and idx - last_ckpt >= checkpoint_every_steps):
            save_checkpoint(ckpt_path, state, {
                "grid_index": idx, "seed": seed, "a": float(a_grid[idx]),
            })
            last_ckpt = idx
        prev = idx
    log_energy()
    if rerun_evals:
        log(f"Capacity heals repeated {rerun_evals} force evaluations")
    sync()
    _record_capacity_memory(config, cfg_run)
    return SimulationResult(
        state=state,
        config=config,
        seed=seed,
        snapshots=snapshots,
        powerspecs=powerspecs,
        wall_s=time.perf_counter() - t0,
        config_run=cfg_run,
        energy_samples=energy_samples or None,
    )
