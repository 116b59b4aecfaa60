"""Typed simulation configuration.

The same dataclasses, defaults and JSON as :mod:`nbody.driver.config`, so
a config file written by either package loads in both.  The torch port
runs the fixed-step P3M/PM slice of these options; ``run_simulation``
raises ``NotImplementedError`` for the rest.

One dataclass replaces the reference's four config mechanisms (SURVEY.md
§5.6): CONCEPT ``.param`` DSL files (`Different_Sizes/Giant.param`),
regex-surgery templating (`SnapVsPK/Ucertain.py:22-67`), plain-text
sidecars, and argparse constants.  The config serialises to JSON next to
every run's outputs, so a run directory is self-describing.

Field defaults mirror the reference's P3M NN pipeline setup
(`TheFeedingPipeline/NN.param`: 32^3 particles, 500 Mpc box via
BoxParams.txt, a_begin=0.02, P3M gravity) — its CONCEPT run takes 34 s for
142 steps on a desktop (SURVEY.md §6).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

from nbody_torch.core.cosmology import Cosmology

SOLVERS = ("pp", "pm", "p3m")


@dataclasses.dataclass(frozen=True)
class OutputConfig:
    """What to write, and where."""

    dir: str = "output"
    snapshot_times: Sequence[float] = (1.0,)  # scale factors a
    powerspec: bool = True
    powerspec_bins: int = 48
    snapshot: bool = True
    # -- measurement options (CONCEPT powerspec_options parity,
    #    reference `SnapVsPK/Uncertain.param:83-107`) ----------------------
    powerspec_binning: str = "geomspace"  # 'geomspace' (powerspec_bins
    # fixed log bins to the corner mode) | 'concept' (variable
    # bins-per-decade edges up to powerspec_k_max)
    bins_per_decade: Sequence[Sequence[float]] = ((4.0, 4.0), (100.0, 40.0))
    # (k / k_min, bins/decade) anchors, log10-interpolated — the
    # reference's {'4*k_min': 4, '100*k_min': 40}
    powerspec_k_max: str = "nyquist"  # 'nyquist' | 'corner' ('concept'
    # binning only)
    powerspec_interpolation: str = "cic"  # 'cic' | 'tsc' | 'pcs'
    # (B-spline assignment order for the measurement deposit; CONCEPT's
    # global default is PCS, the reference's SnapVsPK study switches to
    # CIC — `Uncertain.param:89`)
    powerspec_interlace: int = -1  # -1: follow the force's
    # SimulationConfig.interlace; 0/1: force off/on for the MEASUREMENT
    # deposit only (CONCEPT keeps these separate options)
    realization_correction: bool = False  # divide the realization's own
    # linear-spectrum scatter out of the corrected column (CONCEPT's
    # 'realization correction': True)
    energy_log: bool = True  # sample the Layzer-Irvine energy budget
    # (peculiar T, W and the conserved-functional residual) after every
    # integration segment and print it into run.log at output times —
    # a live view of the ~6% force/energy-functional floor documented in
    # RESULTS.md (the reference has no energy diagnostics at all,
    # SURVEY.md §5.5)

    def replace(self, **kw) -> "OutputConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    # -- cosmology (the parameters the reference's emulator varies) --------
    h: float = 0.67
    omega_b: float = 0.022
    omega_cdm: float = 0.12
    A_s: float = 2.1e-9
    n_s: float = 0.965

    # -- box / discretisation ----------------------------------------------
    box: float = 500.0  # Mpc
    n_side: int = 32  # particles per dimension (N = n_side^3)
    pm_grid: int = 0  # PM mesh per dim; 0 -> 2*n_side (CONCEPT's
    # 'gridsize': 2*_size, reference `Different_Sizes/Giant.param`)

    # -- solver -------------------------------------------------------------
    solver: str = "p3m"  # 'pp' | 'pm' | 'p3m' (the reference trichotomy,
    # `Different_Sizes/Giant.param:66-68`)
    softening_frac: float = 0.03  # eps = frac * (box / n_side)
    softening_kernel: str = "spline"  # 'spline' (cubic spline, exact
    # Newton beyond 2.8 eps — CONCEPT's default kernel; eps is the
    # Plummer-equivalent length) | 'plummer'
    deconvolve_p: int = 2  # sinc exponent divided out of delta_k: 2 =
    # deposit-only (the measured non-interlaced choice, see
    # nbody.forces.pm.pm_potential_k), 4 = CONCEPT's both-pass
    # 'deconvolve': (True, True) force option
    # (`Different_Sizes/Giant.param:53-58`), 0 = off
    interlace: bool = False
    cell_centered: bool = False  # half-cell grid offset for the PM
    # deposit/gather — CONCEPT's default discretization; False is its
    # explicit "vertex-diskretisering" (`Giant.param:62`), this
    # solver's native convention.  PM solver only; the P3M tiers'
    # short-range/mesh split is discretization-translation-invariant.
    pm_gradient: str = "fd4"  # mesh-force differentiation kernel:
    # 'fd4' (4-point k-space difference, Gadget-class default) | 'fd2' |
    # 'spectral' (exact ik — CONCEPT's 'differentiation': 'Fourier'
    # force option, reference `TheFeedingPipeline/NN.param:58`; its PM
    # study ran this)
    force_split: str = "spline"  # P3M split: 'spline' (production, fastest —
    # what bench.py measures) | 'gaussian' (classic Ewald-style split)
    cell_capacity: int = 0  # P3M cell-list bucket capacity; 0 = auto
    # (in-scan overflow tracking auto-doubles this and re-runs the
    # segment if a clustered state fills a bucket)
    column_capacity: int = 0  # column-tier bucket capacity (particles
    # per (x, y) chaining column); 0 = auto + self-heal, like
    # cell_capacity but for shortrange='columns'
    column_window: int = 0  # column-tier source z-window (slots per
    # 256-particle chunk x 9 neighbour columns); 0 = auto heuristic
    # (column_window()).  The driver pre-warms this from the measured
    # z-run demand of the current state (clustered blobs need windows
    # the capacity-scaled heuristic under-predicts — round-3 measured a
    # capacity-doubling ladder thrash without it) and doubles it on
    # overflow alongside the capacity.
    shortrange: str = "auto"  # P3M short-range tier: 'auto'
    # (supercell/columns beyond 64k particles) | 'supercell' (columns +
    # fused MXU CIC deposit and in-kernel PM readback — production when
    # the mesh tiles the chaining grid; single-device part='both' path,
    # other paths fall back to columns on the same geometry) |
    # 'columns' (z-sorted column kernel — at parity with cells on
    # uniform states, ~5x faster clustered) | 'cells' (ghost-padded
    # per-cell Pallas kernel) | 'allpairs' (dense)
    column_skin: float = -1.0  # drift budget (Mpc) for frozen column
    # plans: interior subcycle short evals reuse the sort/bucketing/
    # window tables while every particle stays within skin/2 of the
    # freeze positions (MD neighbour-list trick; refrozen on demand via
    # lax.cond).  -1 = auto (0.05 * r_cut, clamped to the xy slack);
    # 0 disables the reuse.  Single-device subcycled runs only.

    # -- parallelism ---------------------------------------------------------
    devices: int = 1  # device count for the run: 1 = single-device;
    # >1 = slab domain decomposition over a 1-D mesh of that many
    # devices (nbody.distributed.domain); 0 = all visible devices.
    # The role of CONCEPT's MPI launcher flag (`-n`,
    # reference `SnapVsPK/Ucertain.py:89`) — a config field instead of a
    # process topology, transparent to the rest of the run.
    ic_realization: str = "host"  # devices>1 only: "host" realizes the
    # ICs single-device and decomposes them (bitwise the same sample a
    # devices=1 run of this seed would integrate), "domain" realizes
    # slab-resident (~N/D per device end to end,
    # nbody.distributed.ic.lpt_ic_domain) — a DIFFERENT deterministic
    # sample of the same Gaussian ensemble (per-slab fold_in seeding).

    # -- time stepping -------------------------------------------------------
    a_begin: float = 0.02
    a_end: float = 1.0
    n_steps: int = 142  # CONCEPT's typical count for a=0.02->1 (SURVEY §6)
    subcycles: int = 1  # P3M: short-range KDK subcycles per global step
    # (CONCEPT-rung analogue: the far field steps on the global grid
    # while halo particles get 'subcycles'x finer short-range kicks;
    # costs (subcycles-1) extra short-range evals per step, no extra
    # mesh work)
    rungs: int = 0  # per-particle rung stepping (CONCEPT's scheme): 0 =
    # off; R >= 2 assigns each particle a rung from its displacement
    # demand each global step and short-range-kicks rung r every
    # 2^(R-1-r)-th of 2^(R-1) sub-ticks — interior ticks evaluate
    # forces ONLY for the active rungs (two-plane cell kernel), so the
    # ~95% rung-0 population stops paying for the halo particles'
    # fine kicks.  Overrides `subcycles` (the uniform-cadence tier).
    # run.log gains per-step "Rung population" lines.
    rung_active_capacity: int = 0  # compact active-row capacity of the
    # frozen-plan rung tier's interior kicks (0 = disabled, the
    # default: the compact slot-table readback + scatter-add kicks are
    # bit-exact but measured SLOWER at N=2^20 — TPU scatter-add beats
    # the full-N gather it replaces); truncation is loud (ov_t) and
    # the driver doubles it
    rung_capacity: int = 0  # bucket capacity of the active-target plane;
    # 0 = auto (128 — one full Pallas lane quantum; pre-warmed from the
    # densest active bucket each segment and self-healed on overflow
    # like cell_capacity)
    time_stepping: str = "fixed"  # 'fixed' (log-a grid of n_steps) |
    # 'adaptive' (the run chooses its own steps like CONCEPT's adaptive
    # integration — n_steps then caps the total; composes with `rungs`:
    # adaptive background step + per-particle rung subdivision, the full
    # CONCEPT integrator structure; run.log gains
    # "Rung population" lines)
    step_dla_max: float = 0.03  # adaptive: background Delta(ln a) cap
    # (~0.0276 reproduces CONCEPT's ~142 steps over a=0.02->1)
    step_eta_disp: float = 0.25  # adaptive: max per-step drift in units
    # of the PM cell size (displacement criterion)
    step_eta_acc: float = 0.1  # rungs: acceleration criterion
    # dt <= sqrt(2 eta_acc eps / |acc|) (the Gadget/CONCEPT rung rule;
    # halo particles subdivide by |g| long before |v| grows).  0.1
    # reproduces CONCEPT-like rung populations (~96% rung 0 at the 64^3
    # parity study's late times, vs ~89% at Gadget's 0.025) and was
    # validated on chip to keep the growth ratio within the parity
    # contract (scripts/exp_rung_etas.py sweep + rungs_summary.json)

    # -- initial conditions ---------------------------------------------------
    lpt_order: int = 1  # 1 (Zel'dovich) or 2 (2LPT)
    transfer: str = "eh"  # 'eh' | 'bbks' | path to a tabulated P(k)

    # -- output ---------------------------------------------------------------
    output: OutputConfig = dataclasses.field(default_factory=OutputConfig)

    def __post_init__(self):
        if self.solver not in SOLVERS:
            raise ValueError(f"solver must be one of {SOLVERS}, got {self.solver!r}")
        if self.lpt_order not in (1, 2):
            raise ValueError(f"lpt_order must be 1 or 2, got {self.lpt_order}")
        if self.pm_gradient not in ("spectral", "fd2", "fd4"):
            raise ValueError(
                f"pm_gradient must be 'spectral', 'fd2' or 'fd4', "
                f"got {self.pm_gradient!r}"
            )
        if self.time_stepping not in ("fixed", "adaptive"):
            raise ValueError(
                f"time_stepping must be 'fixed' or 'adaptive', "
                f"got {self.time_stepping!r}"
            )
        if self.ic_realization not in ("host", "domain"):
            raise ValueError(
                f"ic_realization must be 'host' or 'domain', "
                f"got {self.ic_realization!r}"
            )

    # -- derived -------------------------------------------------------------
    @property
    def n_particles(self) -> int:
        return self.n_side**3

    @property
    def eps(self) -> float:
        """Plummer softening length in Mpc."""
        return self.softening_frac * self.box / self.n_side

    @property
    def mesh_size(self) -> int:
        return self.pm_grid if self.pm_grid > 0 else 2 * self.n_side

    def cosmology(self) -> Cosmology:
        return Cosmology(
            h=self.h,
            omega_b=self.omega_b,
            omega_cdm=self.omega_cdm,
            A_s=self.A_s,
            n_s=self.n_s,
        )

    def power_fn(self):
        """Linear P(k, a=1) host callable (numpy k -> numpy P) for the IC
        realizer."""
        cosmo = self.cosmology()
        if self.transfer in ("eh", "bbks"):
            transfer = self.transfer
            return lambda k: cosmo.linear_power(k, a=1.0, transfer=transfer)
        from nbody_torch.core.cosmology import TabulatedPowerSpectrum

        return TabulatedPowerSpectrum.from_file(self.transfer)

    def replace(self, **kw) -> "SimulationConfig":
        return dataclasses.replace(self, **kw)

    # -- (de)serialisation -----------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["output"]["snapshot_times"] = list(self.output.snapshot_times)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SimulationConfig":
        d = dict(d)
        out = d.pop("output", {})
        if isinstance(out, dict):
            out.setdefault("snapshot_times", (1.0,))
            out["snapshot_times"] = tuple(out["snapshot_times"])
            if "bins_per_decade" in out:
                out["bins_per_decade"] = tuple(
                    tuple(p) for p in out["bins_per_decade"]
                )
            out = OutputConfig(**out)
        return cls(output=out, **d)

    def save(self, path) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path) -> "SimulationConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))
