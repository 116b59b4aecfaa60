"""Single simulation runs: config -> ICs -> KDK -> outputs.

Counterpart of :func:`nbody.driver.simulate.run_simulation`: LPT ICs, the
comoving KDK with the PM, P3M (dense, cells, supercell or columns
short-range tier) or exact periodic PP force (Ewald: K1 with the Gaussian
split plus the k-space sum), the split-Hamiltonian subcycled KDK (P3M
with ``subcycles > 1``: the far field at the global step, the short-range
force subcycled inside it, on frozen column plans on the column tiers and
with the fused boundary evaluation), or the per-particle rung KDK
(``rungs >= 2``: dense or cell-plane boundary ticks with two-plane cell
interior ticks, or frozen column plans on the supercell tier, with the
compact active-row kicks of ``rung_active_capacity > 0``), on the fixed
log-a grid or with adaptive steps (``time_stepping='adaptive'``: the
plain, subcycled and rung runners, outputs at the requested a
themselves), the capacity pre-warm and self-heal, the Layzer-Irvine
energy samples, and P(k) and snapshot outputs at the output times, in the
same run.log, powerspec and snapshot formats.  The entry points run on
the card unless the caller passes ``device="cpu"``.  On more than one
device ``ic_realization='domain'`` with ``solver='pp'`` raises
``NotImplementedError``, and adaptive steps with subcycles and no rungs
``ValueError`` (as in the JAX package).  With ``devices > 1`` (D shards
driven by one process, placed round-robin over the visible cards) pm and
p3m run the slab domain decomposition
(:mod:`nbody_torch.distributed.domain`), with fixed steps, subcycles,
rungs or adaptive steps, from ICs realized on one device or slab by slab
(``ic_realization='domain'``, :mod:`nbody_torch.distributed.ic`), and
``solver='pp'`` stays on the single-device flow with the ring Ewald force
over D particle blocks
(:func:`nbody_torch.distributed.sharding.make_ring_ewald_acc_fn`).
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
from nbody_torch.distributed.sharding import (
    device_mesh,
    make_ring_ewald_acc_fn,
)
from nbody_torch.driver.config import SimulationConfig
from nbody_torch.forces.ewald import ewald_pp_acc
from nbody_torch.forces.p3m import (
    auto_column_capacity,
    p3m_acc,
    p3m_short_cells_pallas_masked,
    p3m_short_params,
    resolve_shortrange,
    supercell_ncell,
)
from nbody_torch.forces.p3m_columns import (
    _ceil128,
    column_window,
    freeze_column_plan,
    p3m_short_columns_frozen,
    p3m_short_columns_frozen_masked,
    plan_drift,
    plan_drift_ok,
)
from nbody_torch.forces.pm import make_pm_cosmo_force
from nbody_torch.forces.pm_supercell import (
    p3m_supercell_acc,
    p3m_supercell_frozen,
)
from nbody_torch.ic.gaussian import GRFSpec, gaussian_delta_k
from nbody_torch.ic.zeldovich import lpt_ic
from nbody_torch.integrate.cosmo_stepping import (
    kdk_steps,
    log_a_steps,
    make_adaptive_cosmo_runner,
    make_adaptive_rung_runner,
    run_cosmological_rungs,
    run_cosmological_subcycled,
)
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
from nbody_torch.mesh.cells import cell_ids
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


def _n_devices(config: SimulationConfig, device=None) -> int:
    """The run's shard count: ``config.devices``, or with 0 every visible
    card (one shard on the CPU)."""
    if config.devices > 0:
        return config.devices
    dev = torch.device(device) if device is not None else None
    return (torch.cuda.device_count()
            if dev is not None and dev.type == "cuda" else 1)


def check_supported(config: SimulationConfig, device=None) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet,
    and ``ValueError`` for rungs without the P3M solver and, on more than
    one device, for adaptive steps with subcycles and no rungs (as the
    JAX package does)."""
    if config.rungs >= 2 and config.solver != "p3m":
        raise ValueError("rungs requires the p3m solver")
    n_dev = _n_devices(config, device)
    if n_dev > 1:
        missing = []
        if config.solver == "pp":
            # the ring Ewald force on the single-device flow
            route = "solver='pp' on the ring Ewald decomposition"
            if config.ic_realization != "host":
                missing.append(f"ic_realization={config.ic_realization!r} "
                               f"(the ring PP realizes its ICs on one "
                               f"device)")
        elif (config.time_stepping == "adaptive" and config.rungs < 2
              and config.subcycles > 1):
            raise ValueError(
                "devices > 1 with adaptive stepping subdivides via rungs, "
                "not uniform subcycles: set rungs >= 2 (or subcycles=1); "
                "the single-device path composes adaptive x subcycles")
        if missing:
            raise NotImplementedError(
                f"devices={n_dev} ({route}): not ported yet: "
                + "; ".join(missing))


def _n_sub_eff(config: SimulationConfig) -> int:
    """Sub-steps a global step: 2^(rungs - 1) with rungs, else the
    subcycles (the JAX driver cuts its stretches of steps by it)."""
    if config.rungs >= 2:
        return 2 ** (int(config.rungs) - 1)
    return max(1, int(config.subcycles))


def _subcycled(config: SimulationConfig) -> bool:
    """The run takes the split-Hamiltonian subcycled KDK: P3M with
    ``subcycles > 1`` and no rungs (elsewhere subcycles change nothing)."""
    return (config.solver == "p3m" and config.subcycles > 1
            and config.rungs < 2)


def _resolved_shortrange(config: SimulationConfig) -> str:
    """The short-range tier p3m_acc uses for this config: the rule of
    :func:`resolve_shortrange` with the config's own or healed column
    capacity.  The capacity bookkeeping keys on it.  'supercell' shares
    the columns tier's capacity knobs and overflow word on its own
    (possibly coarser) chaining grid."""
    r_cut = p3m_short_params(config.box, config.mesh_size,
                             config.n_particles)[1]
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


def check_base(config: SimulationConfig,
               base: SimulationConfig | None) -> SimulationConfig:
    """The anchor of an ensemble member: ``base``, which may differ from
    ``config`` only in ``A_s`` and ``output`` (``ValueError`` otherwise),
    or ``config`` itself without one."""
    if base is None:
        return config
    if base.replace(A_s=config.A_s, output=config.output) != config:
        raise ValueError("base config may differ from config only in A_s")
    return base


def realize_ics(config: SimulationConfig, seed: int, *, device="cuda",
                dtype=None, noise=None,
                base: SimulationConfig | None = None) -> ParticleState:
    """LPT initial conditions at a_begin for the config's cosmology.

    The white noise is drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` (so a seed gives the same ICs on every device), or given as
    ``noise`` (real, (n_side,)*3), e.g. the JAX package's own draw.

    ``base``: the ensemble's anchor (:func:`check_base`): its cosmology
    gives the power spectrum and the growth, and ``config.A_s`` enters as
    the amplitude ratio A_s / base.A_s, as the JAX package's amplitude-only
    ensembles do (the reference regex-substitutes A_s alone)."""
    device, dtype = _device_dtype(device, dtype)
    anchor = check_base(config, base)
    cosmo = anchor.cosmology()
    generator = None if noise is not None else torch.Generator().manual_seed(seed)
    return lpt_ic(
        GRFSpec(nmesh=config.n_side, box=config.box),
        _linear_power_fn(cosmo, anchor.transfer), cosmo, config.a_begin,
        order=config.lpt_order, amplitude=config.A_s / anchor.A_s,
        generator=generator, noise=noise, device=device, dtype=dtype,
    )


def build_cosmo_force(config: SimulationConfig, *, device="cuda",
                      dtype=None, checked: bool = False) -> Callable:
    """acc_fn(pos, mass, a) -> canonical-momentum force for the config's
    solver ('pm', 'p3m' or 'pp', the exact periodic Ewald force, on the
    ring of D particle blocks with ``devices > 1``), the Newtonian
    periodic force in comoving coordinates scaled by 1/a.
    ``checked=True`` returns (g, overflow) for the checked integrator:
    overflow is 0 iff no force was dropped (the column tiers'
    field-encoded word, a 0-d tensor on the device; always 0 for pm and
    pp)."""
    device, dtype = _device_dtype(device, dtype)
    check_supported(config, device)
    n_dev = _n_devices(config, device)
    if n_dev > 1 and config.solver != "pp":
        raise NotImplementedError(
            "build_cosmo_force with devices > 1 builds the ring Ewald PP "
            "force only; run_simulation runs pm and p3m with devices > 1 on "
            "the domain decomposition")
    box, nmesh = config.box, config.mesh_size
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
    if config.solver == "pp" and n_dev > 1:
        # the exact periodic PP force over D particle blocks (CONCEPT runs
        # its PP under the same MPI decomposition)
        if config.n_particles % n_dev:
            raise ValueError(
                f"devices={n_dev} must divide N={config.n_particles} for the "
                f"ring PP decomposition")
        ring = make_ring_ewald_acc_fn(
            device_mesh(n_dev, device), box, float(config.eps),
            G=units.COSMO.G, softening=config.softening_kernel)

        def pp_fn_ring(pos, mass, a):
            g = ring(pos, mass) / a
            return (g, 0) if checked else g

        return pp_fn_ring
    if config.solver == "pp":
        eps, softening = config.eps, config.softening_kernel

        def pp_fn(pos, mass, a):
            g = ewald_pp_acc(pos, mass, box, eps=eps, G=units.COSMO.G,
                             softening=softening) / a
            return (g, 0) if checked else g

        return pp_fn

    kw = _p3m_kw(config)

    def p3m_fn(pos, mass, a):
        acc, ov = p3m_acc(pos, mass, box, nmesh, with_overflow=True, **kw)
        return (acc / a, ov) if checked else acc / a

    return p3m_fn


def _p3m_kw(config: SimulationConfig) -> dict:
    """p3m_acc's keywords for the config (its healed capacity knobs)."""
    _, tier_cap = _tier_capacity(config)
    return dict(G=units.COSMO.G, eps=config.eps,
                deconvolve_p=config.deconvolve_p, interlace=config.interlace,
                split=config.force_split, shortrange=config.shortrange,
                softening=config.softening_kernel, capacity=tier_cap,
                window=config.column_window or None,
                grad_order=config.pm_gradient)


def build_cosmo_force_both(config: SimulationConfig):
    """both_fn(pos, mass, a_s, a_l) -> (gs, gl, overflow): both halves of
    the force at the same positions from one ``p3m_acc(part='split')``
    evaluation (one plane build and deposit on the supercell tier), each
    scaled by its own 1/a."""
    if config.solver != "p3m":
        raise ValueError("the fused split force applies to p3m only")
    box, nmesh, kw = config.box, config.mesh_size, _p3m_kw(config)

    def both_fn(pos, mass, a_s, a_l):
        gl, gs, ov = p3m_acc(pos, mass, box, nmesh, part="split", **kw)
        return gs / a_s, gl / a_l, ov

    return both_fn


def build_cosmo_force_split(config: SimulationConfig):
    """(long_fn, short_fn): the halves of the P3M canonical-momentum force
    for the subcycled KDK, ``long_fn(pos, mass, a) -> g`` (the mesh far
    field) and ``short_fn(pos, mass, a) -> (g, overflow)`` (the pair
    correction on the config's tier; the supercell tier's short half is
    K4 on its chaining grid)."""
    if config.solver != "p3m":
        raise ValueError("subcycling applies to the p3m solver only")
    box, nmesh, kw = config.box, config.mesh_size, _p3m_kw(config)

    def long_fn(pos, mass, a):
        return p3m_acc(pos, mass, box, nmesh, part="long", **kw) / a

    def short_fn(pos, mass, a):
        acc, ov = p3m_acc(pos, mass, box, nmesh, part="short",
                          with_overflow=True, **kw)
        return acc / a, ov

    return long_fn, short_fn


def _frozen_geometry(config: SimulationConfig):
    """(tier, r_s, r_cut, ncell, ck, w, skin) of the config's frozen
    column-plan geometry, or None when the resolved tier has no column
    geometry or the skin is off.  The auto skin is 5% of r_cut, clamped
    to the frozen-xy slack; with rungs it grows to cover one global
    step's deepest-rung interior drift (2 x 3/4 x 2^(R-1) x eta_disp
    cells with a 1.1 safety), within the same slack; on the supercell
    tier it stays below 1.8 mesh cells (skin/2 < one cell)."""
    if config.solver != "p3m":
        return None
    tier = _resolved_shortrange(config)
    if tier not in ("columns", "supercell"):
        return None
    box, nmesh = config.box, config.mesh_size
    r_s, r_cut, _, _ = p3m_short_params(box, nmesh, config.n_particles)
    ncell = _tier_ncell(config, tier)
    ck = config.column_capacity or auto_column_capacity(config.n_particles,
                                                        ncell)
    w = config.column_window or column_window(box, float(r_cut), ck)
    skin = config.column_skin
    if skin < 0.0:
        skin = min(0.05 * r_cut, 0.49 * (box / ncell - r_cut))
        if int(config.rungs) >= 2:
            skin_r = (1.65 * float(config.step_eta_disp)
                      * (2 ** (int(config.rungs) - 1)) * (box / nmesh))
            skin = max(skin, min(skin_r, 0.49 * (box / ncell - r_cut)))
    if tier == "supercell":
        skin = min(skin, 1.8 * box / nmesh)
    if skin <= 0.0:
        return None
    if not config.column_window:
        # the skin-widened thresholds must fit inside the window
        ckq = -(-ck // 128) * 128
        rc_slots = (r_cut / box) * ckq
        span = 256.0 + 2.2 * rc_slots + 127.0 + 2.0 * skin * ckq / box
        w = max(w, -(-int(span) // 128) * 128)
    return tier, float(r_s), float(r_cut), ncell, ck, w, float(skin)


def _grow_skin(config: SimulationConfig):
    """The next column_skin of the staleness heal (1.5x, clamped to the
    frozen geometry's maxima), or None at the geometric ceiling."""
    geom = _frozen_geometry(config)
    if geom is None:
        return None
    tier, _, r_cut, ncell, _, _, skin = geom
    box, nmesh = config.box, config.mesh_size
    smax = 0.49 * (box / ncell - r_cut)
    if tier == "supercell":
        smax = min(smax, 1.8 * box / nmesh)
    if config.interlace:
        smax = min(smax, 0.9 * box / nmesh)
    if skin >= 0.999 * smax:
        return None
    return min(1.5 * skin, smax)


def build_cosmo_force_frozen(config: SimulationConfig):
    """(freeze_fn, short_frozen_fn, drift_ok_fn) for the subcycled KDK's
    short-range evaluations on a frozen column plan (K4,
    ``p3m_short_columns_frozen``), or None when the resolved tier has no
    column geometry or the skin is off.  ``drift_ok_fn`` holds while every
    particle is within skin/2 of its freeze position.  The plan geometry
    is :func:`_frozen_geometry`'s, which
    :func:`build_cosmo_force_frozen_both` shares, so one plan serves the
    interior subcycles and the fused boundary evaluation."""
    geom = _frozen_geometry(config)
    if geom is None:
        return None
    _, r_s, r_cut, ncell, ck, w, skin = geom
    box, G, eps = config.box, units.COSMO.G, float(config.eps)

    def freeze_fn(pos, mass):
        return freeze_column_plan(pos, mass, box, r_cut, ncell, ck, w,
                                  skin=skin)

    def short_frozen_fn(pos, mass, a, plan):
        acc, ov = p3m_short_columns_frozen(
            pos, mass, plan, box, eps, r_s, r_cut, G=G, ncell=ncell,
            col_capacity=ck, window=w, split=config.force_split,
            softening=config.softening_kernel)
        return acc / a, ov

    def drift_ok_fn(pos, plan):
        return plan_drift_ok(pos, plan, box, skin)

    return freeze_fn, short_frozen_fn, drift_ok_fn


def build_cosmo_force_frozen_both(config: SimulationConfig):
    """The frozen-plan forms of the rung tier on the supercell tier, or
    None on any other tier: (freeze_fn, both_frozen_fn, drift_ok_fn,
    masked_frozen_fn, stale_fn, fresh_plan_fn), or the first three alone
    when the skin cannot cover one step's deepest-rung drift (interior
    ticks then ride the two-plane cell kernel).

    The boundary tick evaluates both halves on the carried plan
    (``p3m_supercell_frozen``, K2 + K3) while ``drift_ok_fn`` (half the
    skin, so that the plan handed to the next step's interior ticks keeps
    half its budget) holds, else freshly with a new plan
    (``p3m_supercell_acc(with_plan=True)``); interior ticks run K5 on the
    plan unconditionally, and ``stale_fn`` counts the particles beyond
    skin/2."""
    geom = _frozen_geometry(config)
    if geom is None or geom[0] != "supercell":
        return None
    _, r_s, r_cut, ncell, ck, w, skin = geom
    box, nmesh = config.box, config.mesh_size
    if config.interlace:
        # the shifted pass reaches node -2 once drift exceeds half a cell
        skin = min(skin, 0.9 * box / nmesh)
    G, eps = units.COSMO.G, float(config.eps)
    fkw = dict(G=G, eps=eps, r_s=r_s, r_cut=r_cut,
               deconvolve_p=config.deconvolve_p, split=config.force_split,
               softening=config.softening_kernel, ncell=ncell,
               col_capacity=ck, window=w, grad_order=config.pm_gradient,
               part_split=True, interlace=config.interlace)

    def freeze_fn(pos, mass):
        return freeze_column_plan(pos, mass, box, r_cut, ncell, ck, w,
                                  skin=skin)

    def both_frozen_fn(pos, mass, a_s, a_l, plan):
        gl, gs, ov = p3m_supercell_frozen(pos, mass, plan, box, nmesh, **fkw)
        return gs / a_s, gl / a_l, ov

    def drift_ok_fn(pos, plan):
        return plan_drift_ok(pos, plan, box, 0.5 * skin)

    def masked_frozen_fn(pos, mass, act, a, plan, buckets=False):
        # buckets=True: the slot table, which the compact kicks gather
        acc, ov = p3m_short_columns_frozen_masked(
            pos, mass, act, plan, box, eps, r_s, r_cut, G=G, ncell=ncell,
            col_capacity=ck, window=w, split=config.force_split,
            softening=config.softening_kernel, return_buckets=buckets)
        return acc / a, ov

    def stale_fn(pos, plan):
        return torch.sum(plan_drift(pos, plan, box) > (0.5 * skin) ** 2)

    def fresh_plan_fn(pos, mass, a_s, a_l):
        gl, gs, ov, plan = p3m_supercell_acc(pos, mass, box, nmesh,
                                             skin=skin, with_plan=True,
                                             **fkw)
        return gs / a_s, gl / a_l, ov, plan

    if int(config.rungs) >= 2:
        # the interior ticks ride the plan only when the full skin covers
        # one step's deepest-rung drift bound
        needed = (0.75 * (2 ** (int(config.rungs) - 1))
                  * float(config.step_eta_disp) * (box / nmesh) * 1.05)
        if skin < needed:
            return (freeze_fn, both_frozen_fn, drift_ok_fn)
    return (freeze_fn, both_frozen_fn, drift_ok_fn, masked_frozen_fn,
            stale_fn, fresh_plan_fn)


def _cell_knobs(config: SimulationConfig, cfg_run: SimulationConfig):
    """(r_s, r_cut, ncell, capacity) of the cell plane of ``config`` with
    the cell capacity of ``cfg_run`` (explicit or healed, else auto)."""
    r_s, r_cut, ncell, auto_cap = p3m_short_params(
        config.box, config.mesh_size, config.n_particles)
    return r_s, r_cut, ncell, cfg_run.cell_capacity or auto_cap


def build_cosmo_force_rungs(config: SimulationConfig):
    """masked_fn(pos, mass, act, a) -> (g, ov_source, ov_target,
    occupancy_target) for the rung integrator's interior ticks off frozen
    plans: the two-plane cell kernel (K6) on the active targets, on the
    cell geometry whatever the boundary tier (auto target capacity: one
    128-slot lane)."""
    if config.solver != "p3m":
        raise ValueError("rung stepping applies to the p3m solver only")
    box, G, eps = config.box, units.COSMO.G, config.eps
    r_s, r_cut, ncell, capacity = _cell_knobs(config, config)
    target_capacity = config.rung_capacity or 128

    def masked_fn(pos, mass, act, a):
        g, ov_s, ov_t, occ_t = p3m_short_cells_pallas_masked(
            pos, mass, act, box, eps, r_s, r_cut, G=G, ncell=ncell,
            capacity=capacity, target_capacity=target_capacity,
            split=config.force_split, softening=config.softening_kernel)
        return g / a, ov_s, ov_t, occ_t

    return masked_fn


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
                      seed: int | None = None, realized=None):
    """Linear column, realization correction, sigma8 headers and the
    CONCEPT-format write, shared tail of the P(k) measurement.
    ``realized``: the binned spectrum of the run's own IC realization on
    ``edges`` (the sharded path passes the domain draw's,
    :func:`~nbody_torch.distributed.measure.realized_spectrum_domain`);
    None re-draws the single-device realization of ``seed``."""
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
        # seeded draw as realize_ics, unless the caller has the run's own
        power1 = _linear_power_fn(config.cosmology(), config.transfer)
        if realized is None:
            dk = gaussian_delta_k(
                GRFSpec(nmesh=config.n_side, box=config.box), power1,
                generator=torch.Generator().manual_seed(seed),
                device=raw.k.device, dtype=raw.k.dtype,
            )
            realized = power_spectrum(dk, config.box, is_fourier=True,
                                      edges=edges)
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
    # rung runs on frozen plans: the largest count of particles in one
    # segment that drifted beyond skin/2 of their plan and were accepted
    # with only a run.log note (at most max(16, N // 65536))
    stale_max: int = 0


# In-process capacity carry-forward: runs of the same geometry cluster
# alike, so the capacities one run learned through pre-warms and heals
# start the next one (each heal costs a segment re-run).  Only fields the
# caller left at 0 (auto) take part: explicit capacities are respected.
_CAPACITY_FIELDS = ("cell_capacity", "column_capacity", "column_window",
                    "rung_capacity")
_CAPACITY_MEMORY: dict[tuple, dict[str, int]] = {}


def _capacity_signature(config: SimulationConfig) -> tuple:
    """Geometry + schedule fields that set a run's clustering statistics
    (and so its capacity demand)."""
    return (
        config.solver, config.box, config.n_side, config.mesh_size,
        _resolved_shortrange(config), config.force_split,
        config.rungs, config.subcycles, config.a_end, config.devices,
    )


def forget_capacities() -> None:
    """Forget the capacities earlier runs of this process learned: the
    next run of every geometry starts from its config's and the pre-warm's
    capacities, as in a fresh process.  A run's bits depend on the
    capacities it starts from (they set the column tiers' launch shapes
    and so the order of their sums), so two runs that are to agree bit
    for bit each start after this call or in a process of their own."""
    _CAPACITY_MEMORY.clear()


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
                     pos, rung_occ: int = 0
                     ) -> tuple[SimulationConfig, list[str]]:
    """Before a stretch of steps, grow the knobs of ``cfg_run`` to fit the
    positions (with headroom for the stretch's clustering), which costs
    one pass over the positions instead of an overflow and a re-run: the
    column tiers' z-window and capacity from the densest 3-cell z-run and
    column; the cell capacity from the densest cell where a cell plane is
    built (the cells tier, and the rung tier's masked source plane); the
    rung target capacity from ``rung_occ``, the densest active cell the
    last stretch saw.  Returns (the grown config, its run.log lines).
    The dense tier without rungs builds no plane and grows nothing.  B
    members' positions (B, N, 3) size the knobs for the densest member
    (one capacity serves the batch)."""
    r_cut = p3m_short_params(config.box, config.mesh_size,
                             config.n_particles)[1]
    if config.solver != "p3m" or int(config.box / r_cut) < 3:
        return cfg_run, []
    tier = _resolved_shortrange(config)
    col_like = tier in ("columns", "supercell")
    rungs = config.rungs >= 2
    if not (col_like or rungs or tier == "cells"):
        return cfg_run, []
    lines = []
    pos = torch.remainder(pos, config.box).reshape(-1, pos.shape[-2], 3)
    B = pos.shape[0]
    # each member's buckets its own: ids offset by the member
    member = torch.arange(B, device=pos.device)[:, None]
    ncell = int(config.box / r_cut)

    def densest_cell(nc: int) -> int:
        ids = cell_ids(pos.reshape(-1, 3), config.box, nc).reshape(B, -1)
        return int(torch.bincount((ids + member * nc**3).reshape(-1),
                                  minlength=B * nc**3).max())

    if col_like:
        nct, ck, cur_w = column_knobs(config, cfg_run)
        c = torch.clamp((pos * (nct / config.box)).to(torch.int64), 0,
                        nct - 1)
        cid = c[..., 0] * nct + c[..., 1]
        occ = int(torch.bincount((cid + member * nct**2).reshape(-1),
                                 minlength=B * nct**2).max())
        # a chunk's sources lie within +- r_cut in z of the 9 neighbour
        # columns: at most the densest 3-cell z-run (cell z-height
        # box/nct >= r_cut)
        cnt3 = torch.bincount((cid * nct + c[..., 2]
                               + member * nct**3).reshape(-1),
                              minlength=B * nct**3).reshape(B, nct, nct, nct)
        run3 = cnt3 + torch.roll(cnt3, 1, dims=3) + torch.roll(cnt3, -1,
                                                                dims=3)
        zrun = int(run3.max())
        # the 256-slot chunk scaled 1.15x for the density ratio between
        # columns + the measured z-run + alignment
        needed_w = -(-int(295 + 1.25 * zrun + 260) // 128) * 128
        if needed_w > cur_w:
            lines.append(f"pre-warming column z-window to {needed_w} "
                         f"(densest 3-cell z-run {zrun})")
            cfg_run = cfg_run.replace(column_window=needed_w)
        field, cur = "column_capacity", ck
    else:
        occ = densest_cell(ncell)
        field, cur = "cell_capacity", _cell_knobs(config, cfg_run)[3]
    if rungs and col_like:
        # the masked cell kernel's source plane rides the cell geometry
        # whatever the boundary tier
        occ3 = densest_cell(ncell)
        needed3 = -(-int(occ3 * 1.10 + 4) // 128) * 128
        if needed3 > _cell_knobs(config, cfg_run)[3]:
            lines.append(f"pre-warming P3M cell capacity to {needed3} "
                         f"(densest cell {occ3}; masked-kernel source "
                         f"plane)")
            cfg_run = cfg_run.replace(cell_capacity=needed3)
    # the next 128-slot quantum above the densest bucket + 10%
    needed = -(-int(occ * 1.10 + 4) // 128) * 128
    if needed > cur:
        lines.append(f"pre-warming P3M {field.replace('_', ' ')} to "
                     f"{needed} (densest bucket {occ})")
        cfg_run = cfg_run.replace(**{field: needed})
    if rungs and rung_occ:
        # 35% headroom for the populations' growth within the stretch
        needed_t = -(-int(rung_occ * 1.35 + 4) // 128) * 128
        if needed_t > (cfg_run.rung_capacity or 128):
            lines.append(f"pre-warming rung target capacity to {needed_t} "
                         f"(densest active bucket {rung_occ})")
            cfg_run = cfg_run.replace(rung_capacity=needed_t)
    return cfg_run, lines


def heal_capacity(config: SimulationConfig, cfg_run: SimulationConfig,
                  ov: int) -> tuple[SimulationConfig, str]:
    """Grow the knob of ``cfg_run`` that the overflow word ``ov`` of the
    config's short-range tier names.  On the column tiers window misses
    widen ``column_window`` 1.5x, bucket/ghost spills double
    ``column_capacity`` (and widen an explicit window with it); elsewhere
    ``ov`` counts the particles a cell plane dropped and doubles
    ``cell_capacity``.  Returns (the healed config, its run.log line)."""
    if _resolved_shortrange(config) not in ("columns", "supercell"):
        new_cap = 2 * _cell_knobs(config, cfg_run)[3]
        return cfg_run.replace(cell_capacity=new_cap), (
            f"P3M bucket overflow inside scan ({ov} particles) — doubling "
            f"cell capacity to {new_cap}, re-running segment")
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


def heal_rung_channels(config: SimulationConfig, cfg_run: SimulationConfig,
                       ov: int, ovt: int, ovm: int, compact: bool = False
                       ) -> tuple[SimulationConfig, list[str]]:
    """Grow the knobs of ``cfg_run`` that a rung stretch's overflow
    channels name, in the JAX driver's order: the target plane's spills
    (``ovt``) double ``rung_capacity``, or with ``compact`` (the compact
    kicks on the frozen plans, where ``ovt`` counts the active rows past
    the capacity) ``rung_active_capacity``; the masked source plane's
    (``ovm``) ``cell_capacity``, and the boundary word ``ov`` heals the
    tier's own knob (:func:`heal_capacity`; off the column tiers the
    boundary and the masked source plane share the cell capacity, which
    then doubles once).  Returns (the healed config, its run.log lines)."""
    if _resolved_shortrange(config) not in ("columns", "supercell"):
        ov, ovm = max(ov, ovm), 0
    lines = []
    if ovt and compact:
        new_acap = 2 * cfg_run.rung_active_capacity
        lines.append(f"compact active-row overflow ({ovt} particles beyond "
                     f"capacity) — doubling rung_active_capacity to "
                     f"{new_acap}, re-running segment")
        cfg_run = cfg_run.replace(rung_active_capacity=new_acap)
    elif ovt:
        new_rcap = 2 * (cfg_run.rung_capacity or 128)
        lines.append(f"rung target-plane overflow ({ovt} particles) — "
                     f"doubling rung capacity to {new_rcap}, re-running "
                     f"segment")
        cfg_run = cfg_run.replace(rung_capacity=new_rcap)
    if ovm:
        new_ccap = 2 * _cell_knobs(config, cfg_run)[3]
        lines.append(f"masked-kernel source-plane overflow ({ovm} "
                     f"particles) — doubling cell capacity to {new_ccap}, "
                     f"re-running segment")
        cfg_run = cfg_run.replace(cell_capacity=new_ccap)
    if ov:
        cfg_run, line = heal_capacity(config, cfg_run, ov)
        lines.append(line)
    return cfg_run, lines


def stale_tolerance(config: SimulationConfig) -> int:
    """Particles beyond skin/2 in one stretch that the rung tier accepts
    with only a run.log note (rung-clamped outliers); more grow the
    skin."""
    return max(16, config.n_particles // 65536)


def _drift_note(n: int) -> str:
    """run.log's note for ``n`` stale particles kept (see
    :func:`stale_tolerance`)."""
    return (f"frozen-plan drift note: {n} rung-clamped particles exceeded "
            f"the skin/2 budget this segment (window coverage not "
            f"guaranteed for them; matches CONCEPT's rung-clamp accuracy)")


def _rung_population_lines(a_grid, lo: int, hists) -> list[str]:
    """run.log's "Rung population" line of each step after ``lo``: the
    counts up to the deepest populated rung."""
    lines = []
    for k, h in enumerate(hists):
        top = int(np.max(np.nonzero(h)[0])) + 1
        lines.append(f"Time step {lo + 1 + k:4d}   a = "
                     f"{a_grid[lo + 1 + k]:.4f}   Rung population: matter: "
                     + ", ".join(str(int(x)) for x in h[:top]))
    return lines


def run_simulation(
    config: SimulationConfig,
    seed: int = 0,
    workdir: str | None = None,
    base: SimulationConfig | None = None,
    *,
    device="cuda",
    dtype=None,
    initial_state: ParticleState | None = None,
    checkpoint_every_steps: int | None = None,
    resume: bool = False,
) -> SimulationResult:
    """Run one full simulation: ICs at a_begin -> KDK to a_end.

    On the fixed log-a grid the output times
    (``config.output.snapshot_times``) are snapped onto the step grid;
    with ``time_stepping='adaptive'`` each output time ends a segment and
    the run arrives there exactly.  P(k) files and snapshots are written
    under
    ``workdir`` (default ``config.output.dir``), with a CONCEPT-style
    run.log.  ``initial_state`` replaces the realized ICs.  The stretches of
    steps are ``SAMPLE_EVERY_STEPS // n_sub`` steps long (at least 4, as
    the JAX driver cuts them; n_sub the subcycles, or 2^(rungs - 1)).
    Without rungs or subcycles the force is evaluated once per step plus
    once at the start (the last force of one stretch of steps is the first
    of the next).  With ``rungs >= 2`` or the subcycled KDK (P3M with
    ``subcycles > 1``) each stretch starts with its own evaluation; with
    rungs run.log gets a "Rung population" line per step, and with
    subcycles a line of the evaluations made by kind.

    ``checkpoint_every_steps`` writes an atomic autosave checkpoint every
    k steps; ``resume=True`` continues from the workdir's autosave if
    there is one.  ``base``: an ensemble's anchor, which ``config`` may
    differ from only in A_s and output (``ValueError`` otherwise): the ICs
    take its cosmology and power at the amplitude ratio A_s / base.A_s
    (:func:`realize_ics`), as the JAX package's ensemble members do.

    The tiers that build a plane pre-warm their knobs from the state
    before each stretch of steps (:func:`prewarm_capacity`), and a
    stretch that dropped force re-runs from its start after a heal
    (:func:`heal_capacity`, :func:`heal_rung_channels`; at most
    ``HEAL_ATTEMPTS`` attempts).  On frozen plans, particles that drifted
    beyond skin/2 grow ``column_skin`` and re-run the stretch, unless they
    are at most :func:`stale_tolerance`: then run.log notes them and
    ``result.stale_max`` keeps the largest such count.  The compact kicks'
    truncation doubles ``rung_active_capacity``.
    ``result.config_run`` is the healed config.

    Adaptive steps (the JAX driver's ``seg_adaptive``): the rung runner
    (:func:`~nbody_torch.integrate.cosmo_stepping.make_adaptive_rung_runner`)
    with rungs, else the plain or subcycled one
    (:func:`~nbody_torch.integrate.cosmo_stepping.make_adaptive_cosmo_runner`),
    in stretches of at most ``SAMPLE_EVERY_STEPS // n_sub`` steps (at
    least 4, with rungs at least 2), each logged as "Time step N  a = ...
    dln(a) = ...  Rung population: ..." with N the steps so far, then
    "Reached a = ..." at each segment's end and "Total adaptive steps: N".
    A stretch that dropped force is healed and re-run from its own start
    (the JAX driver re-runs the segment from its entry): a heal that drops
    no force changes no step, so the result is the same, and the steps of
    a try that did not stand are not counted.  Checkpoints carry
    ``grid_index = -1`` and the a they were taken at, where a resume
    continues."""
    device, dtype = _device_dtype(device, dtype)
    check_supported(config, device)
    check_base(config, base)
    n_dev = _n_devices(config, device)
    if n_dev > 1 and config.solver != "pp":
        return _run_simulation_domain(
            config, seed, workdir, device, dtype, initial_state,
            checkpoint_every_steps, resume, n_dev, base)
    t0 = time.perf_counter()
    cosmo = config.cosmology()
    cfg_run = _apply_capacity_memory(config)
    rungs = int(config.rungs) if config.rungs >= 2 else 0
    subcycled = _subcycled(config)

    def build_forces(cfg):
        """The force closures of the run at the knobs of ``cfg``."""
        if rungs:
            return (build_cosmo_force_rungs(cfg), build_cosmo_force_both(cfg),
                    build_cosmo_force_frozen_both(cfg))
        if subcycled:
            return (build_cosmo_force_split(cfg), build_cosmo_force_both(cfg),
                    build_cosmo_force_frozen(cfg),
                    build_cosmo_force_frozen_both(cfg))
        return build_cosmo_force(cfg, device=device, dtype=dtype,
                                 checked=True)

    forces = build_forces(cfg_run)

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
    state, start_idx, a_start = None, 0, config.a_begin
    if resume and ckpt_path and os.path.exists(ckpt_path):
        state, extra = load_checkpoint(ckpt_path, device=device, dtype=dtype)
        start_idx, a_start = int(extra["grid_index"]), float(extra["a"])
    # the JAX driver's stretches: 32 sub-steps (at least 4 steps; an
    # adaptive rung stretch at least 2)
    seg_steps = max(4, SAMPLE_EVERY_STEPS // _n_sub_eff(config))
    stretch = max(2 if rungs else 4, SAMPLE_EVERY_STEPS // _n_sub_eff(config))
    adaptive = config.time_stepping == "adaptive"
    # adaptive outputs at the requested a themselves, each a segment bound
    out_a = sorted({float(a) for a in config.output.snapshot_times
                    if config.a_begin < a <= config.a_end})
    a_bounds = sorted({a for a in out_a if a > a_start} | {config.a_end})
    bounds = set(out_idx) | {last} | set(
        range(start_idx + seg_steps, last, seg_steps))
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

    rerun_evals = rerun_masked = rerun_short = 0
    rung_occ_seen = stale_max = 0
    totals = dict(boundary_evals=0, interior_evals=0, refreezes=0,
                  step_reads=0, drift_reads=0)
    ada_totals = dict(evals=0, long_evals=0, short_evals=0, both_evals=0,
                      step_reads=0)
    sub_totals = dict(long_evals=0, short_evals=0, frozen_evals=0,
                      both_evals=0, refreezes=0, drift_reads=0)

    def fixed_attempt(acc_fn, st, g, a_seg):
        """One try of a stretch of fixed steps from ``st`` (``g`` its
        force or None): ((state, g), None), or (None, the healed config)."""
        nonlocal rerun_evals
        new, g_new, overflow = kdk_steps(st, cosmo, a_seg, acc_fn,
                                         config.box, g=g)
        if overflow == 0:
            return (new, g_new), None
        rerun_evals += len(a_seg) - 1 + (g is None)
        grown, line = heal_capacity(config, cfg_run, overflow)
        log(line)
        return None, grown

    def sub_attempt(fns, st, a_seg):
        """One try of a stretch of subcycled steps from ``st``: (state,
        None), or (None, the healed config).  The evaluations of every
        try count in ``sub_totals``."""
        nonlocal rerun_evals
        split_fns, both_fn, frozen_fns, frozen_both = fns
        stats = {}
        new, overflow = run_cosmological_subcycled(
            st, cosmo, a_seg, split_fns[0], split_fns[1], config.box,
            config.subcycles, acc_both_fn=both_fn, frozen_fns=frozen_fns,
            frozen_both_fn=(frozen_both[1] if frozen_both is not None
                            and frozen_fns is not None else None),
            stats=stats)
        for key in sub_totals:
            sub_totals[key] += stats[key]
        if overflow == 0:
            return new, None
        rerun_evals += stats["long_evals"] + stats["both_evals"]
        grown, line = heal_capacity(config, cfg_run, overflow)
        log(line)
        return None, grown

    def active_capacity(frozen_fns) -> int:
        """The compact active-row capacity of the rung kicks: the healed
        ``rung_active_capacity`` where the interior ticks ride the frozen
        plans, else 0 (the full-N kicks)."""
        if frozen_fns is None or len(frozen_fns) < 6:
            return 0
        return int(cfg_run.rung_active_capacity)

    def rung_attempt(fns, st, a_seg):
        """One try of a stretch of rung steps from ``st``: ((state,
        per-step rung histograms), None), or (None, the healed config)."""
        masked_fn, both_fn, frozen_fns = fns
        stats = {}
        new, ov, ovm, ovt, occt, ovst, hists = run_cosmological_rungs(
            st, cosmo, a_seg, both_fn, masked_fn, config.box, rungs,
            config.box / config.mesh_size, eta_disp=config.step_eta_disp,
            eta_acc=config.step_eta_acc, eps=config.eps,
            frozen_both_fns=frozen_fns,
            active_capacity=active_capacity(frozen_fns), stats=stats)
        grown = rung_outcome(stats, ov, ovm, ovt, occt, ovst,
                             active_capacity(frozen_fns) > 0)
        return ((new, hists), None) if grown is None else (None, grown)

    def rung_outcome(stats, ov, ovm, ovt, occt, ovst, compact):
        """The heal after a try of rung steps: None when the stretch is
        kept (its counts added to the totals), else the healed config,
        its run.log lines written.  On the compact route ``ovt`` counts
        the active rows past ``rung_active_capacity``, which doubles."""
        nonlocal rerun_evals, rerun_masked, rung_occ_seen, stale_max
        if ovst and ovst <= stale_tolerance(config):
            log(_drift_note(ovst))
            stale_max = max(stale_max, ovst)
            ovst = 0
        if ovst:
            new_skin = _grow_skin(cfg_run)
            if new_skin is None:
                raise RuntimeError(
                    f"frozen-plan staleness ({ovst} particles beyond "
                    f"skin/2) with the skin at its geometric maximum — "
                    f"reduce the step (more n_steps) or lower rungs")
            lines = [f"frozen-plan staleness ({ovst} particles) — "
                     f"growing column skin to {new_skin:.3f}, "
                     f"re-running segment"]
            grown = cfg_run.replace(column_skin=new_skin)
        elif ov == 0 and ovt == 0 and ovm == 0:
            rung_occ_seen = occt
            for key in totals:
                totals[key] += stats[key]
            return None
        else:
            grown, lines = heal_rung_channels(config, cfg_run, ov, ovt, ovm,
                                              compact=compact)
        rerun_evals += stats["boundary_evals"]
        rerun_masked += stats["interior_evals"]
        for line in lines:
            log(line)
        return grown

    def adaptive_attempt(fns, st, a_hi):
        """One try of a stretch of at most ``stretch`` adaptive steps from
        ``st`` toward ``a_hi``: ((state, steps, last dln(a), last rung
        histogram), None), or (None, the healed config).  The runner is
        built from the forces of this try (no compile to amortise)."""
        nonlocal rerun_evals, rerun_short
        stats = {}
        cell = config.box / config.mesh_size
        if rungs:
            masked_fn, both_fn, frozen_fns = fns
            acap = active_capacity(frozen_fns)
            runner = make_adaptive_rung_runner(
                cosmo, both_fn, masked_fn, config.box, cell,
                dla_max=config.step_dla_max, eta_disp=config.step_eta_disp,
                eta_acc=config.step_eta_acc, eps=config.eps, n_rungs=rungs,
                frozen_both_fns=frozen_fns, active_capacity=acap)
            new, n, ov, ovm, ovt, occt, ovst, dla, hist = runner(
                st, a_hi, max_steps=stretch, stats=stats)
            grown = rung_outcome(stats, ov, ovm, ovt, occt, ovst, acap > 0)
        else:
            if subcycled:
                runner = make_adaptive_cosmo_runner(
                    cosmo, None, config.box, cell,
                    dla_max=config.step_dla_max,
                    eta_disp=config.step_eta_disp, split_fns=fns[0],
                    n_sub=config.subcycles, acc_both_fn=fns[1])
            else:
                runner = make_adaptive_cosmo_runner(
                    cosmo, fns, config.box, cell,
                    dla_max=config.step_dla_max,
                    eta_disp=config.step_eta_disp)
            new, n, ov, dla, hist = runner(st, a_hi, max_steps=stretch,
                                           stats=stats)
            for key in ada_totals:
                ada_totals[key] += stats[key]
            grown = None
            if ov:
                rerun_evals += sum(stats[k] for k in (
                    "evals", "long_evals", "both_evals"))
                rerun_short += stats["short_evals"]
                grown, line = heal_capacity(config, cfg_run, ov)
                log(line)
        return ((new, n, dla, hist), None) if grown is None else (None, grown)

    def segment_with_heal(attempt, st, *args, rung_occ: int = 0):
        """One stretch of steps from ``st`` after the pre-warm, re-run from
        its start by ``attempt(forces, st, *args)`` after each heal until
        nothing overflows."""
        nonlocal cfg_run, forces
        grown, lines = prewarm_capacity(config, cfg_run, st.pos, rung_occ)
        for line in lines:
            log(line)
        for _ in range(HEAL_ATTEMPTS):
            if grown is not cfg_run:
                cfg_run = grown
                forces = build_forces(cfg_run)
            done, grown = attempt(forces, st, *args)
            if done is not None:
                return done
        raise RuntimeError(
            "P3M cell capacity retries exhausted — state too clustered")

    ic_wall = 0.0
    if state is None and initial_state is not None:
        state = initial_state.to(device=device, dtype=dtype)
    elif state is None:
        t_ic = time.perf_counter()
        state = realize_ics(config, seed, device=device, dtype=dtype,
                            base=base)
        sync()
        ic_wall = time.perf_counter() - t_ic

    log(
        f"nbody run: solver={config.solver} N={config.n_particles} "
        f"box={config.box:g} Mpc mesh={config.mesh_size} "
        f"a={config.a_begin:g}->{config.a_end:g} "
        + ("(adaptive stepping)" if adaptive
           else f"in {config.n_steps} steps")
        + f" (seed={seed}, start_idx={start_idx})"
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
    n_adaptive = 0
    for a_hi in a_bounds if adaptive else ():
        t_seg = time.perf_counter()
        a_hi_t = float(torch.tensor(a_hi, dtype=dtype))
        while float(state.time) < a_hi_t:
            state, n, dla, hist = segment_with_heal(adaptive_attempt, state,
                                                    a_hi,
                                                    rung_occ=rung_occ_seen)
            n_adaptive += n
            top = max((r for r, c in enumerate(hist) if c), default=0) + 1
            log(f"Time step {n_adaptive:4d}   a = {float(state.time):.4f}   "
                f"dln(a) = {dla:.5f}   Rung population: matter: "
                + ", ".join(str(int(x)) for x in hist[:top]))
        sync()
        sample_energy(state)
        log(f"Reached a = {a_hi:.4f} ({time.perf_counter() - t_seg:.2f} s)")
        if a_hi in out_a and workdir:
            write_outputs(a_hi)
        if checkpoint_every_steps and ckpt_path and a_hi < config.a_end:
            save_checkpoint(ckpt_path, state, {
                "grid_index": -1, "seed": seed, "a": float(a_hi)})
    if adaptive:
        log(f"Total adaptive steps: {n_adaptive}")
    for idx in bounds if not adaptive else ():
        t_seg = time.perf_counter()
        a_seg = a_grid[prev: idx + 1]
        if rungs:
            state, hists = segment_with_heal(rung_attempt, state, a_seg,
                                             rung_occ=rung_occ_seen)
            for line in _rung_population_lines(a_grid, prev, hists):
                log(line)
        elif subcycled:
            state = segment_with_heal(sub_attempt, state, a_seg)
        else:
            state, g = segment_with_heal(fixed_attempt, state, g, a_seg)
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
    if rerun_masked:
        log(f"Capacity heals repeated {rerun_masked} masked interior "
            f"evaluations")
    if rerun_short:
        log(f"Capacity heals repeated {rerun_short} short-range "
            f"evaluations")
    if adaptive and not rungs:
        t = ada_totals
        log(f"Adaptive stepping ({config.subcycles} subcycles, heals' "
            f"repeats included): {t['evals']} plain, {t['long_evals']} long, "
            f"{t['short_evals']} short and {t['both_evals']} fused force "
            f"evaluations, {t['step_reads']} host reads of the step")
    elif adaptive:
        log(f"Adaptive rung stepping: {totals['step_reads']} host reads of "
            f"the step and its rung histogram, {totals['drift_reads']} of "
            f"the drift predicate")
    if subcycled and not adaptive:
        t = sub_totals
        log(f"Subcycled stepping ({config.subcycles} subcycles, heals' "
            f"repeats included): {t['long_evals']} long, {t['short_evals']} "
            f"short, {t['frozen_evals']} frozen-plan short and "
            f"{t['both_evals']} fused force evaluations, {t['refreezes']} "
            f"plan refreezes, {t['drift_reads']} host reads of the drift "
            f"predicate")
    if rungs:
        log(f"Rung stepping: {totals['boundary_evals']} boundary and "
            f"{totals['interior_evals']} masked interior force evaluations, "
            f"{totals['refreezes']} plan refreezes"
            + (f", at most {stale_max} particles beyond skin/2 in a "
               f"segment" if stale_max else ""))
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
        stale_max=stale_max,
    )


# ---------------------------------------------------------------------------
# devices > 1: the slab domain decomposition
# ---------------------------------------------------------------------------


def _domain_tier(config: SimulationConfig, n_dev: int, *,
                 rungs: bool = False, adaptive: bool = False) -> str:
    """Short-range tier of the domain path: 'supercell' where the mesh
    tiles a chaining grid that also splits over the shards, else
    'columns' beyond the dense tier's range; 'cells' otherwise, and for
    the rung and adaptive paths and the PM solver."""
    if rungs or adaptive or config.solver != "p3m":
        return "cells"
    resolved = _resolved_shortrange(config)
    if resolved == "supercell":
        sc = supercell_ncell(
            config.box, config.mesh_size,
            p3m_short_params(config.box, config.mesh_size,
                             config.n_particles)[1])
        return "supercell" if sc and sc % n_dev == 0 else "columns"
    if resolved == "columns":
        return "columns"
    return "cells"


def measure_powerspec_sharded(shards: list, group, config: SimulationConfig,
                              a: float, path: str | None = None,
                              seed: int | None = None):
    """:func:`measure_powerspec` of a slab-resident state through the
    sharded estimator
    (:func:`nbody_torch.distributed.measure.measure_powerspec_domain`):
    the same columns and file, with nothing larger than nmesh^3 / D on a
    shard.  Returns (k, modes, P, P_corrected, P_linear) as numpy."""
    from nbody_torch.distributed.measure import (
        measure_powerspec_domain,
        realized_spectrum_domain,
    )

    edges, order, interlace = _measurement_options(config)
    raw, corr = measure_powerspec_domain(
        shards, group, box=config.box, nmesh=config.mesh_size,
        n_global=config.n_particles, edges=edges, deconvolve_p=1,
        window_order=order, interlace=interlace)
    realized = None
    if (config.output.realization_correction and seed is not None
            and config.ic_realization == "domain"):
        # the domain draw is another sample than the single-device one:
        # correct by its own realization, slab by slab
        realized = realized_spectrum_domain(
            seed, GRFSpec(nmesh=config.n_side, box=config.box),
            _linear_power_fn(config.cosmology(), config.transfer), group,
            edges, dtype=raw.k.dtype)
    return _finish_powerspec(raw, corr, config, a, edges=edges, path=path,
                             seed=seed, realized=realized)


def domain_column_knobs(config: SimulationConfig, tier: str,
                        geom) -> tuple[int, int]:
    """(column capacity, column window; 0 = auto) a domain run of
    ``config`` starts from on a column tier (both 0 on the cells tier):
    the config's own, else the mean column + 6 sigma Poisson tail of the
    tier's chaining grid (the supercell grid divides the mesh; the
    columns grid is the domain geometry's, slab-divisible), 128-aligned,
    or what an earlier run of the same geometry healed to."""
    if tier not in ("columns", "supercell"):
        return 0, 0
    mem = _CAPACITY_MEMORY.get(_capacity_signature(config), {})
    nct = (supercell_ncell(config.box, config.mesh_size, geom.r_cut)
           if tier == "supercell" else geom.ncell)
    mean_col = config.n_particles / nct**2
    ck = config.column_capacity or max(
        -(-int(mean_col + 6.0 * mean_col**0.5 + 8) // 128) * 128,
        mem.get("column_capacity", 0))
    return ck, config.column_window or mem.get("column_window", 0)


def heal_domain(config: SimulationConfig, tier: str, geom, ck: int, cw: int,
                E: int, ov_b: int, ov_e: int):
    """The domain run's heal after a stretch dropped force: on the column
    tiers the field-encoded word's window misses widen the window 1.5x and
    its bucket spills double the capacity; on the cells tier the planes'
    128-slot bucket doubles (the JAX driver doubles the capacity, which
    below 128 leaves the bucket as it was); exchange overflow doubles the
    exchange capacity.
    Returns (geom, ck, cw, E, run.log lines)."""
    lines = []
    if ov_b and tier in ("columns", "supercell"):
        cur_w = cw or column_window(config.box, geom.r_cut, ck)
        if (ov_b >> 16) == 0:
            cw = -(-int(1.5 * cur_w) // 128) * 128
            lines.append(f"column z-window misses inside scan "
                         f"({ov_b & 0xffff} slots) — widening z-window to "
                         f"{cw}, re-running segment")
        else:
            ck *= 2
            cw = -(-int(1.5 * cur_w) // 128) * 128 if cw else 0
            lines.append(f"column bucket overflow inside scan "
                         f"({ov_b >> 16} particles) — doubling column "
                         f"capacity to {ck}, re-running segment")
    elif ov_b:
        # the planes round the capacity up to 128-slot buckets: double the
        # bucket, or a heal below the rounding changes nothing
        geom = geom._replace(bucket_capacity=2 * _ceil128(
            geom.bucket_capacity))
        lines.append(f"P3M bucket overflow inside scan ({ov_b} particles) — "
                     f"doubling bucket capacity to {geom.bucket_capacity}, "
                     f"re-running segment")
    if ov_e:
        E *= 2
        lines.append(f"slab-exchange overflow ({ov_e} particles) — doubling "
                     f"exchange capacity to {E}, re-running segment")
    return geom, ck, cw, E, lines


def domain_frozen_knobs(config: SimulationConfig, geom,
                        ck: int = 0) -> tuple[float, int, int]:
    """(skin, column capacity, column window) of the frozen local column
    plans a domain rung run of ``config`` starts from on ``geom``'s
    chaining grid, or skin 0 (the masked cell planes) when the skin is off
    or the column side cannot hold it (side >= r_cut + 2 skin).  The auto
    skin (``column_skin < 0``) is the rung sizing of
    :func:`_frozen_geometry`, capped at the geometric ceiling 0.49 (side -
    r_cut); the capacity is ``ck``, the config's or the mean column + 6
    sigma, or what an earlier run of the same geometry healed to; the
    window is widened to hold the skin-widened thresholds."""
    if config.rungs < 2 or config.solver != "p3m":
        return 0.0, ck, 0
    mem = _CAPACITY_MEMORY.get(_capacity_signature(config), {})
    side = config.box / geom.ncell
    skin = config.column_skin
    if skin < 0.0:
        skin_r = (1.65 * float(config.step_eta_disp)
                  * (2 ** (int(config.rungs) - 1))
                  * (config.box / config.mesh_size))
        skin = min(max(0.05 * geom.r_cut, skin_r),
                   0.49 * (side - geom.r_cut))
    if not (skin > 0.0 and side >= geom.r_cut + 2.0 * skin):
        return 0.0, ck, 0
    mean_col = config.n_particles / geom.ncell**2
    ck = ck or config.column_capacity or max(
        -(-int(mean_col + 6.0 * mean_col**0.5 + 8) // 128) * 128,
        mem.get("column_capacity", 0))
    base_w = (config.column_window or mem.get("column_window", 0)
              or column_window(config.box, geom.r_cut, ck))
    return float(skin), ck, max(base_w, _skin_window(config, geom, ck, skin))


def _skin_window(config: SimulationConfig, geom, ck: int,
                 skin: float) -> int:
    """The z-window that holds a frozen plan's skin-widened thresholds."""
    rc_slots = (geom.r_cut / config.box) * ck
    span = 256.0 + 2.2 * rc_slots + 127.0 + 2.0 * skin * ck / config.box
    return -(-int(span) // 128) * 128


def heal_domain_frozen(config: SimulationConfig, geom, ck: int, cw: int,
                       skin: float, ov_p: int, ov_s: int):
    """The frozen local plans' heals after a domain rung segment, in the
    JAX driver's order: the plans' field-encoded word first (window misses
    widen the window 1.5x, bucket spills double the capacity), then their
    staleness ``ov_s`` (the most particles of one shard beyond skin/2 at
    one tick).  Up to :func:`stale_tolerance` stale particles are kept;
    more grow the skin 1.5x toward its ceiling 0.49 (side - r_cut) (with
    the window widened to hold it); at the ceiling the skin heals to 0,
    which moves the interior ticks to the masked cell planes (the JAX
    driver keeps such a segment with a warning and leaves those
    particles' pairs unchecked).  Returns (ck, cw, skin, run.log lines of
    a heal that re-runs the segment, the stale count kept with a note or
    0)."""
    if ov_p:
        if (ov_p >> 16) == 0:
            cw = -(-int(1.5 * cw) // 128) * 128
            return ck, cw, skin, [
                f"frozen-plan z-window misses ({ov_p & 0xffff} slots) — "
                f"widening z-window to {cw}, re-running segment"], 0
        return 2 * ck, cw, skin, [
            f"frozen-plan bucket overflow ({ov_p >> 16} particles) — "
            f"doubling column capacity to {2 * ck}, re-running segment"], 0
    if not ov_s:
        return ck, cw, skin, [], 0
    if ov_s <= stale_tolerance(config):
        return ck, cw, skin, [], ov_s
    smax = 0.49 * (config.box / geom.ncell - geom.r_cut)
    if skin < smax:
        skin = min(1.5 * skin, smax)
        return ck, max(cw, _skin_window(config, geom, ck, skin)), skin, [
            f"frozen-plan staleness ({ov_s} particles beyond skin/2) — "
            f"growing column_skin to {skin:.3g}, re-running segment"], 0
    return ck, cw, 0.0, [
        f"frozen-plan staleness ({ov_s} particles beyond skin/2) with "
        f"column_skin at the geometric ceiling {skin:.3g} — healing "
        f"column_skin to 0 (masked cell planes for the interior ticks), "
        f"re-running segment"], 0


def _run_simulation_domain(config: SimulationConfig, seed: int,
                           workdir: str | None, device, dtype,
                           initial_state: ParticleState | None,
                           checkpoint_every_steps: int | None, resume: bool,
                           n_dev: int,
                           base: SimulationConfig | None = None
                           ) -> SimulationResult:
    """The ``devices > 1`` branch of :func:`run_simulation`: the ICs are
    realized on one device and decomposed once into slab-resident shards
    (:func:`~nbody_torch.distributed.domain.domain_decompose`, shards
    round-robin over the visible cards), or with ``ic_realization=
    'domain'`` realized slab by slab
    (:func:`~nbody_torch.distributed.ic.lpt_ic_domain`; with ``base``
    the anchor's cosmology and power at the amplitude A_s / base.A_s, as
    :func:`realize_ics` takes them; an exchange overflow raises), then
    the domain runner
    (:func:`~nbody_torch.distributed.domain.run_cosmological_domain`) runs
    stretches of at most 32 steps (32 // n_sub with subcycles or rungs),
    each re-run from its start after a heal; P(k) at the output times
    comes from the sharded estimator (its realization correction from
    the domain draw where the ICs came from it), snapshots and checkpoints
    from :func:`~nbody_torch.distributed.domain.domain_gather`.  The
    run.log lines are the JAX driver's, plus the counts of force
    evaluations.

    With rungs the interior ticks ride frozen local column plans when the
    skin fits the column side (:func:`domain_frozen_knobs`), else the
    masked cell planes.  The heals follow the JAX driver's order: the
    plans' word (window x1.5 or capacity x2), their staleness, the target
    plane (rung capacity x2), the bucket and the exchange.  Staleness up
    to :func:`stale_tolerance` particles is noted in run.log and kept
    (``result.stale_max``); more grows the skin toward its ceiling, and at
    the ceiling the port heals ``column_skin`` to 0 and re-runs the
    segment on the masked cell planes, which have no drift budget (the
    JAX driver keeps such a segment with a warning).

    Adaptive steps run :func:`~nbody_torch.distributed.domain.
    run_cosmological_domain_adaptive` (with ``rungs`` or one rung, on the
    masked cell planes) in stretches toward each output time and a_end,
    each re-run from its start after a heal (the JAX driver's
    ``run_segment_adaptive``: the target capacity, the bucket and the
    exchange double), with the log lines of the single-device path."""
    from nbody_torch.diagnostics.layzer_irvine import (
        peculiar_energies_domain,
    )
    from nbody_torch.distributed.domain import (
        domain_decompose,
        domain_gather,
        domain_p3m_geometry,
        run_cosmological_domain,
        run_cosmological_domain_adaptive,
        slab_grid,
    )
    from nbody_torch.distributed.ic import lpt_ic_domain

    t0 = time.perf_counter()
    cosmo = config.cosmology()
    group = device_mesh(n_dev, device)
    split = "none" if config.solver == "pm" else config.force_split
    rungs = int(config.rungs) if config.rungs >= 2 else 0
    geom = domain_p3m_geometry(config.box, config.mesh_size, n_dev,
                               config.n_particles,
                               bucket_capacity=config.cell_capacity or None)
    a_grid = log_a_steps(config.a_begin, config.a_end, config.n_steps)
    last = len(a_grid) - 1
    out_idx = sorted({int(np.argmin(np.abs(a_grid - a)))
                      for a in config.output.snapshot_times
                      if config.a_begin < a <= config.a_end})
    out_idx = [i for i in out_idx if i > 0]

    workdir = workdir if workdir is not None else config.output.dir
    snapshots, powerspecs = [], []
    if workdir:
        config.save(os.path.join(workdir, "config.json"))
    log_path = os.path.join(workdir, "run.log") if workdir else None
    ckpt_path = (os.path.join(workdir, "autosave", CHECKPOINT_NAME)
                 if workdir else None)

    def log(msg: str) -> None:
        if log_path:
            with open(log_path, "a") as f:
                f.write(msg + "\n")
        else:
            print(f"[run] {msg}", flush=True)

    state, start_idx = None, 0
    if resume and ckpt_path and os.path.exists(ckpt_path):
        state, extra = load_checkpoint(ckpt_path, device=device, dtype=dtype)
        start_idx = int(extra["grid_index"])
    adaptive = config.time_stepping == "adaptive"
    tier = _domain_tier(config, n_dev, rungs=bool(rungs), adaptive=adaptive)
    xgrid = slab_grid(geom, tier)
    if (state is None and initial_state is None
            and config.ic_realization == "domain"):
        # slab-resident realization: about N / D on a shard throughout,
        # another sample of the ensemble than the single-device draw
        # the anchor's cosmology and power at the member's amplitude, as
        # realize_ics takes them (the JAX domain flow pairs the member's
        # own power with the ratio, counting it twice)
        anchor = check_base(config, base)
        cosmo_ic = anchor.cosmology()
        dstate, ov_ic = lpt_ic_domain(
            seed, GRFSpec(nmesh=config.n_side, box=config.box),
            _linear_power_fn(cosmo_ic, anchor.transfer), cosmo_ic,
            config.a_begin, group, order=config.lpt_order, ncell=xgrid,
            amplitude=config.A_s / anchor.A_s, dtype=dtype)
        if ov_ic:
            raise RuntimeError(
                f"slab IC exchange overflow ({ov_ic} particles)")
    else:
        if state is None:
            state = (initial_state.to(device=device, dtype=dtype)
                     if initial_state is not None
                     else realize_ics(config, seed, device=device,
                                      dtype=dtype, base=base))
        dstate = domain_decompose(state, group, config.box, ncell=xgrid)
        del state
    C = dstate[0].pos.shape[0]
    E = max(64, C // 8)

    seg_steps = stretch = max(2, SAMPLE_EVERY_STEPS // _n_sub_eff(config))
    bounds = set(out_idx) | {last}
    if checkpoint_every_steps:
        bounds |= set(range(checkpoint_every_steps, last,
                            checkpoint_every_steps))
    bounds |= set(range(start_idx + seg_steps, last, seg_steps))
    bounds = sorted(i for i in bounds if i > start_idx)

    log(f"nbody run: solver={config.solver} N={config.n_particles} "
        f"box={config.box:g} Mpc mesh={config.mesh_size} "
        f"a={config.a_begin:g}->{config.a_end:g} "
        + ("(adaptive stepping) " if adaptive
           else f"in {config.n_steps} steps ")
        + f"(seed={seed}, start_idx={start_idx})")
    ck, cw = domain_column_knobs(config, tier, geom)
    # the adaptive runner's interior ticks ride the masked cell planes
    skin, ck, fw = (domain_frozen_knobs(config, geom, ck) if not adaptive
                    else (0.0, ck, 0))
    cw = fw or cw
    log(f"Domain decomposition: {n_dev}x1x1 ({geom.ncell} chaining cells, "
        f"{C} slots/device, bucket capacity {geom.bucket_capacity}, "
        f"short-range tier {tier}"
        + (f", column capacity {ck}" if tier in ("columns", "supercell")
           else "")
        + (f", frozen rung plans (skin {skin:.3g}, column capacity {ck})"
           if skin > 0.0 else "") + ")")
    mem = _CAPACITY_MEMORY.get(_capacity_signature(config), {})
    rcap = config.rung_capacity or max(128, mem.get("rung_capacity", 0))
    skin0, stale_max = skin, 0
    evals = dict(total=0, repeated=0, frozen=0, masked=0, freezes=0,
                 repeated_frozen=0, repeated_masked=0, short=0, fused=0,
                 repeated_short=0, step_reads=0)
    subcycled = _subcycled(config)

    def run_segment(dst, lo, hi):
        nonlocal geom, E, rcap, ck, cw, skin, stale_max
        for _ in range(HEAL_ATTEMPTS):
            frozen = skin > 0.0
            res = run_cosmological_domain(
                dst, cosmo, a_grid[lo: hi + 1], group, box=config.box,
                nmesh=config.mesh_size, eps=config.eps,
                n_global=config.n_particles, geom=geom, split=split,
                deconvolve_p=config.deconvolve_p, interlace=config.interlace,
                grad_order=config.pm_gradient, subcycles=config.subcycles,
                softening=config.softening_kernel, exchange_capacity=E,
                rungs=rungs, eta_disp=config.step_eta_disp,
                eta_acc=config.step_eta_acc, target_capacity=rcap,
                shortrange=tier, col_capacity=ck or None,
                col_window=cw or None, rung_frozen=frozen,
                column_skin=skin)
            route = ("short" if subcycled else "frozen" if frozen
                     else "masked")
            evals["total"] += res.force_evals
            evals[route] += res.interior_evals
            evals["fused"] += res.fused_evals
            evals["freezes"] += res.plan_freezes
            lines = []
            if frozen:
                ck, cw, skin, lines, kept = heal_domain_frozen(
                    config, geom, ck, cw, skin, res.plan_overflow,
                    res.plan_stale)
                if kept:
                    log(_drift_note(kept))
                    stale_max = max(stale_max, kept)
            ov_b, ov_e = res.bucket_overflow, res.exchange_overflow
            ov_t = res.target_overflow or 0
            if not lines and ov_b == 0 and ov_e == 0 and ov_t == 0:
                if rungs:
                    for line in _rung_population_lines(a_grid, lo,
                                                       res.rung_hists):
                        log(line)
                    occ = res.target_occupancy
                    needed = -(-int(occ * 1.35) // 128) * 128
                    if needed > rcap:
                        log(f"pre-warming rung target capacity to {needed} "
                            f"(densest active bucket {occ})")
                        rcap = needed
                return res.state
            evals["repeated"] += res.force_evals
            evals[f"repeated_{route}"] += res.interior_evals
            # the channels' knobs are independent, so every channel that
            # dropped force heals before the one re-run (the JAX driver
            # re-runs after the plans' heal alone)
            if ov_t:
                rcap *= 2
                lines.append(f"rung target-plane overflow ({ov_t} "
                             f"particles) — doubling rung capacity to "
                             f"{rcap}, re-running segment")
            geom, ck, cw, E, more = heal_domain(config, tier, geom, ck, cw,
                                                E, ov_b, ov_e)
            lines += more
            for line in lines:
                log(line)
        raise RuntimeError("domain capacity retries exhausted")

    def run_stretch_adaptive(dst, a_hi):
        """One stretch of at most ``stretch`` adaptive steps toward
        ``a_hi`` (the JAX driver's ``run_segment_adaptive``), re-run from
        its start after a heal: the target capacity, the bucket and the
        exchange double."""
        nonlocal geom, E, rcap
        for _ in range(HEAL_ATTEMPTS):
            res = run_cosmological_domain_adaptive(
                dst, cosmo, a_hi, group, box=config.box,
                nmesh=config.mesh_size, eps=config.eps,
                n_global=config.n_particles, exchange_capacity=E, geom=geom,
                deconvolve_p=config.deconvolve_p, split=split,
                grad_order=config.pm_gradient, interlace=config.interlace,
                softening=config.softening_kernel, rungs=rungs or 1,
                dla_max=config.step_dla_max, eta_disp=config.step_eta_disp,
                eta_acc=config.step_eta_acc, target_capacity=rcap,
                max_steps=stretch)
            evals["total"] += res.force_evals
            evals["masked"] += res.interior_evals
            evals["step_reads"] += res.step_reads
            ov_b, ov_e, ov_t = (res.bucket_overflow, res.exchange_overflow,
                                res.target_overflow)
            if ov_b == 0 and ov_e == 0 and ov_t == 0:
                needed = -(-int(res.target_occupancy * 1.35) // 128) * 128
                if rungs and needed > rcap:
                    log(f"pre-warming rung target capacity to {needed} "
                        f"(densest active bucket {res.target_occupancy})")
                    rcap = needed
                return res
            evals["repeated"] += res.force_evals
            evals["repeated_masked"] += res.interior_evals
            lines = []
            if ov_t:
                rcap *= 2
                lines.append(f"rung target-plane overflow ({ov_t} "
                             f"particles) — doubling rung capacity to "
                             f"{rcap}, re-running segment")
            geom, _, _, E, more = heal_domain(config, tier, geom, 0, 0, E,
                                              ov_b, ov_e)
            for line in lines + more:
                log(line)
        raise RuntimeError("domain capacity retries exhausted")

    meta_of = lambda a: SnapshotMeta.from_cosmology(cosmo, config.box, a=a)  # noqa: E731
    energy_samples: list[tuple[float, float, float]] = []

    def sample_energy(dst) -> None:
        if not config.output.energy_log:
            return
        T, W = peculiar_energies_domain(dst, cosmo, config.box,
                                        config.mesh_size, group)
        energy_samples.append((float(dst[0].time), float(T), float(W)))

    def log_energy() -> None:
        if len(energy_samples) < 2:
            return
        a_s, T_s, W_s = (np.array(c) for c in zip(*energy_samples))
        res = layzer_irvine_residual(a_s, T_s, W_s)
        log(f"Energy budget: T = {T_s[-1]:.6e}  W = {W_s[-1]:.6e}  "
            f"Layzer-Irvine residual = {100.0 * res:.2f}%")

    def write_outputs(a_out: float) -> None:
        log_energy()
        tag = f"a={a_out:.2f}"
        if config.output.snapshot:
            spath = os.path.join(workdir, "snapshots", f"snapshot_{tag}.hdf5")
            write_snapshot(spath, domain_gather(dstate), meta_of(a_out))
            snapshots.append(spath)
            log(f"Snapshot written: {spath}")
        if config.output.powerspec:
            ppath = os.path.join(workdir, "powerspec", f"powerspec_{tag}")
            measure_powerspec_sharded(dstate, group, config, a_out,
                                      path=ppath, seed=seed)
            powerspecs.append(ppath)
            log(f"Power spectrum written (sharded): {ppath}")

    sample_energy(dstate)
    n_adaptive = 0
    out_a = sorted({float(a) for a in config.output.snapshot_times
                    if config.a_begin < a <= config.a_end})
    a_start = float(dstate[0].time)
    for a_hi in (sorted({a for a in out_a if a > a_start} | {config.a_end})
                 if adaptive else ()):
        t_seg = time.perf_counter()
        a_hi_t = float(torch.tensor(a_hi, dtype=dtype))
        while float(dstate[0].time) < a_hi_t:
            res = run_stretch_adaptive(dstate, a_hi)
            dstate, n_adaptive = res.state, n_adaptive + res.n_steps
            top = max((r for r, c in enumerate(res.rung_hist) if c),
                      default=0) + 1
            log(f"Time step {n_adaptive:4d}   a = "
                f"{float(dstate[0].time):.4f}   dln(a) = "
                f"{res.dla_last:.5f}   Rung population: matter: "
                + ", ".join(str(int(x)) for x in res.rung_hist[:top]))
        log(f"Reached a = {a_hi:.4f} ({time.perf_counter() - t_seg:.2f} s)")
        sample_energy(dstate)
        if a_hi in out_a and workdir:
            write_outputs(a_hi)
        if checkpoint_every_steps and ckpt_path and a_hi < config.a_end:
            save_checkpoint(ckpt_path, domain_gather(dstate), {
                "grid_index": -1, "seed": seed, "a": float(a_hi)})
    if adaptive:
        log(f"Total adaptive steps: {n_adaptive}")
    prev = last_ckpt = start_idx
    for idx in bounds if not adaptive else ():
        t_seg = time.perf_counter()
        dstate = run_segment(dstate, prev, idx)
        log(f"Time step {idx:4d}   a = {a_grid[idx]:.4f}   "
            f"({idx - prev} steps in {time.perf_counter() - t_seg:.2f} s)")
        sample_energy(dstate)
        if idx in out_idx and workdir:
            write_outputs(float(a_grid[idx]))
        if (checkpoint_every_steps and ckpt_path and idx < last
                and idx - last_ckpt >= checkpoint_every_steps):
            save_checkpoint(ckpt_path, domain_gather(dstate), {
                "grid_index": idx, "seed": seed, "a": float(a_grid[idx])})
            last_ckpt = idx
        prev = idx
    if evals["repeated"]:
        log(f"Capacity heals repeated {evals['repeated']} force evaluations")
    for route, what in (("masked", "masked interior"),
                        ("frozen", "frozen-plan interior"),
                        ("short", "short-range")):
        if evals[f"repeated_{route}"]:
            log(f"Capacity heals repeated {evals[f'repeated_{route}']} "
                f"{what} evaluations")
    log(f"Domain force evaluations: {evals['total']} on {n_dev} shards")
    if subcycled:
        log(f"Domain subcycled stepping ({config.subcycles} subcycles, "
            f"heals' repeats included): {evals['total']} far-field "
            f"({evals['fused']} of them fused with the last subcycle's "
            f"short force) and {evals['short']} short-range force "
            f"evaluations")
    if adaptive:
        log(f"Domain adaptive stepping: {evals['step_reads']} host reads of "
            f"the step and its rung histogram")
    if rungs:
        log(f"Domain rung stepping: {evals['total']} boundary, "
            f"{evals['frozen']} frozen-plan interior and {evals['masked']} "
            f"masked interior force evaluations, {evals['freezes']} plan "
            f"freezes"
            + (f", at most {stale_max} particles beyond skin/2 in a "
               f"segment" if stale_max else ""))
    learned = {f: v for f, v in (("column_capacity", ck),
                                 ("column_window", cw),
                                 ("rung_capacity", rcap if rungs else 0))
               if v and not getattr(config, f)}
    cfg_run = config.replace(**learned)
    _record_capacity_memory(config, cfg_run)
    if skin != skin0:
        # the staleness heals' skin (0: the masked cell planes)
        cfg_run = cfg_run.replace(column_skin=skin)
    final = domain_gather(dstate)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return SimulationResult(
        state=final, config=config, seed=seed, snapshots=snapshots,
        powerspecs=powerspecs, wall_s=time.perf_counter() - t0,
        config_run=cfg_run, energy_samples=energy_samples or None,
        stale_max=stale_max)
