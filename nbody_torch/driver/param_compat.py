"""CONCEPT ``.param`` file compatibility reader (counterpart of
:mod:`nbody.driver.param_compat`, on the port's config and its own copy of
the unit namespace).

The reference configures CONCEPT with executable Python-like param files
carrying units and computed tags (`Different_Sizes/Giant.param`,
`SnapVsPK/Uncertain.param`, `TheFeedingPipeline/NN.param` — component C30,
SURVEY.md §2/§5.6), and runs them through regex templating to inject
seeds/amplitudes (`Ucertain.py:22-67`, `NeuNetværk_test.py:100-119`).

:func:`load_concept_param` executes such a file in a sandboxed namespace
(unit symbols evaluate to magnitudes in this framework's Mpc/Gyr/1e10Msun
system; ``path`` is a stub; ``h`` becomes available as soon as ``H0`` is
assigned, like CONCEPT's lazy background) and maps the recognised fields
onto a :class:`~nbody_torch.driver.config.SimulationConfig`.
``defines`` plays the role of CONCEPT's ``-D`` command-line defines (the
reference's ``_size`` injection), and ``overrides`` the role of the regex
surgery.
"""

from __future__ import annotations

import ast
import math

from nbody_torch.core import units
from nbody_torch.driver.config import OutputConfig, SimulationConfig


class _PathStub:
    """Stands in for CONCEPT's `path` object inside f-strings."""

    def __getattr__(self, name: str) -> str:
        return f"<path.{name}>"


def _unit_namespace() -> dict:
    """Unit symbols with magnitudes in the cosmo unit system (Mpc, Gyr,
    1e10 Msun), so e.g. ``1000*Mpc`` -> 1000.0 and
    ``67.36*km/(s*Mpc)`` -> H0 in 1/Gyr."""
    kms = units.KMS_IN_MPC_PER_GYR  # km/s in Mpc/Gyr
    ns = {
        "Mpc": 1.0,
        "kpc": 1e-3,
        "Gpc": 1e3,
        "Gyr": 1.0,
        "Myr": 1e-3,
        "yr": 1e-9,
        "hr": 1.0 / (8766.0 * 1e6),  # Julian hours per Gyr
        "km": kms,  # so km/(s*Mpc) = H0 magnitude in 1/Gyr
        "s": 1.0,
        "m_sun": 1e-10,
        "Msun": 1e-10,
        "pi": math.pi,
        "path": _PathStub(),
        "cbrt": lambda x: x ** (1.0 / 3.0),
        "log": math.log,
        "log2": math.log2,
        "exp": math.exp,
        "sqrt": math.sqrt,
        "machine_ϵ": 2.220446049250313e-16,
        "machine_eps": 2.220446049250313e-16,
        "ထ": math.inf,  # CONCEPT's infinity glyph
        "inf": math.inf,
    }
    return ns


def parse_concept_param(path: str, defines: dict | None = None) -> dict:
    """Execute a CONCEPT param file, returning its resulting namespace.

    Statements are executed one at a time; after each, ``h`` is derived
    from ``H0`` if newly available (CONCEPT exposes h lazily, which the
    reference's files rely on: ``Ωb = 0.02237/h**2`` after
    ``H0 = 67.36*km/(s*Mpc)``).  Unknown names make only their own
    statement fail (skipped), matching how permissive the DSL is.
    """
    with open(path, encoding="utf-8") as f:
        src = f.read()
    ns = _unit_namespace()
    ns.update(defines or {})
    tree = ast.parse(src)
    kms = units.KMS_IN_MPC_PER_GYR
    failed = list(tree.body)
    # up to three passes: CONCEPT's DSL allows forward references (the
    # reference's files use `8*Mpc/h` in powerspec_options long before
    # the cosmology block defines H0, from which h derives)
    for _ in range(3):
        still = []
        for node in failed:
            stmt = ast.Module(body=[node], type_ignores=[])
            try:
                exec(compile(stmt, path, "exec"), ns)  # noqa: S102 — DSL
            except Exception:  # noqa: BLE001 — retry next pass
                still.append(node)
            if "H0" in ns and "h" not in ns:
                ns["h"] = ns["H0"] / (100.0 * kms)
        if not still:
            break
        failed = still
    return ns


def config_from_param_namespace(ns: dict) -> SimulationConfig:
    """Map a parsed CONCEPT namespace onto SimulationConfig."""
    cfg = SimulationConfig()
    kw = {}

    if "boxsize" in ns:
        kw["box"] = float(ns["boxsize"])
    ic = ns.get("initial_conditions")
    if isinstance(ic, dict) and "N" in ic:
        kw["n_side"] = max(2, round(float(ic["N"]) ** (1.0 / 3.0)))
    forces = ns.get("select_forces")
    if isinstance(forces, dict):
        grav = forces.get("matter", {})
        if isinstance(grav, dict) and grav.get("gravity") in ("pp", "pm", "p3m"):
            kw["solver"] = grav["gravity"]
    ro = ns.get("realization_options")
    if isinstance(ro, dict) and ro.get("LPT") in (1, 2):
        kw["lpt_order"] = int(ro["LPT"])
    if "a_begin" in ns:
        kw["a_begin"] = float(ns["a_begin"])
    prim = ns.get("primordial_spectrum")
    if isinstance(prim, dict):
        if "A_s" in prim:
            kw["A_s"] = float(prim["A_s"])
        if "n_s" in prim:
            kw["n_s"] = float(prim["n_s"])
    h = ns.get("h")
    if h:
        kw["h"] = float(h)
        for glyph, field in (("Ωb", "omega_b"), ("Ωcdm", "omega_cdm")):
            if glyph in ns:
                kw[field] = float(ns[glyph]) * float(h) ** 2

    # potential grid size: take the 'global' entry when it is a plain
    # number (the reference writes it as a one-element set literal)
    po = ns.get("potential_options")
    if isinstance(po, dict):
        g = po.get("gridsize")
        if isinstance(g, dict):
            g = g.get("global")
        if isinstance(g, (set, frozenset)) and len(g) == 1:
            g = next(iter(g))
        if isinstance(g, (int, float)):
            kw["pm_grid"] = int(g)
        inter = po.get("interlace")
        if isinstance(inter, dict):
            grav = inter.get("gravity", {})
            inter = grav.get(kw.get("solver", "pm")) or grav.get("pm") or grav.get("p3m")
        if isinstance(inter, tuple):
            kw["interlace"] = bool(inter[0])
        # 'deconvolve': {'gravity': {'pm': (True, True)}} — CONCEPT's
        # (upstream deposit, downstream interpolation) deconvolution
        # pair (`Different_Sizes/Giant.param:53-58`,
        # `TheFeedingPipeline/NN.param:67-71`): each True contributes a
        # sinc^2 divided out of delta_k (deconvolve_p = 2 per pass)
        dec = po.get("deconvolve")
        if isinstance(dec, dict):
            grav = dec.get("gravity", {})
            dec = (
                grav.get(kw.get("solver", "pm")) or grav.get("pm")
                or grav.get("p3m")
            )
        if isinstance(dec, tuple):
            kw["deconvolve_p"] = 2 * sum(bool(x) for x in dec)
        # 'differentiation': {'all': {'gravity': {'p3m': 'Fourier'}}}
        # (reference `TheFeedingPipeline/NN.param:55-60`) — CONCEPT's
        # 'Fourier' is the exact-ik kernel ('spectral' here); an integer
        # order N maps to the 2N-point finite difference
        diff = po.get("differentiation")
        while isinstance(diff, dict):
            diff = (
                diff.get("all") or diff.get("default")
                or diff.get("gravity")
                or diff.get(kw.get("solver", "pm"))
                or diff.get("pm") or diff.get("p3m")
            )
        if isinstance(diff, str) and diff.lower() == "fourier":
            kw["pm_gradient"] = "spectral"
        elif isinstance(diff, (int, float)) and int(diff) in (1, 2):
            kw["pm_gradient"] = f"fd{2 * int(diff)}"

    # grid discretization: CONCEPT's cell_centered (True = grid values
    # at cell centers, its default; the reference's PM study sets False,
    # "vertex-diskretisering" — this framework's native convention,
    # `Different_Sizes/Giant.param:62`)
    cc = ns.get("cell_centered")
    if isinstance(cc, bool):
        kw["cell_centered"] = cc

    # softening kernel (CONCEPT: 'softening_kernel' = {'matter': ...} or
    # a plain string; its global default is 'spline', as is ours)
    sk = ns.get("softening_kernel")
    if isinstance(sk, dict):
        sk = sk.get("matter") or sk.get("default")
    if sk in ("spline", "plummer"):
        kw["softening_kernel"] = sk

    out_kw = {}
    ot = ns.get("output_times")
    if isinstance(ot, dict) and isinstance(ot.get("snapshot"), (list, tuple)):
        out_kw["snapshot_times"] = tuple(float(a) for a in ot["snapshot"])
        kw["a_end"] = max(out_kw["snapshot_times"])

    # powerspec_options (the reference's measurement block,
    # `SnapVsPK/Uncertain.param:83-107`)
    pso = ns.get("powerspec_options")
    if isinstance(pso, dict):

        def _default(key):
            v = pso.get(key)
            if isinstance(v, dict):
                return v.get("default")
            return v

        interp = _default("interpolation")
        if isinstance(interp, str) and interp.lower() in ("cic", "tsc", "pcs"):
            out_kw["powerspec_interpolation"] = interp.lower()
        il = _default("interlace")
        if isinstance(il, bool):
            out_kw["powerspec_interlace"] = int(il)
        rc = _default("realization correction")
        if isinstance(rc, bool):
            out_kw["realization_correction"] = rc
        kmax = _default("k_max")
        if kmax in ("nyquist", "corner"):
            out_kw["powerspec_k_max"] = kmax
            out_kw.setdefault("powerspec_binning", "concept")
        bpd = _default("bins per decade")
        if isinstance(bpd, dict) and bpd:
            # keys are expressions like '  4*k_min' -> anchor multiple
            anchors = []
            for key, val in bpd.items():
                try:
                    mult = float(str(key).replace("*k_min", "").strip())
                except ValueError:
                    continue
                anchors.append((mult, float(val)))
            if anchors:
                out_kw["bins_per_decade"] = tuple(sorted(anchors))
                out_kw.setdefault("powerspec_binning", "concept")

    if out_kw:
        kw["output"] = OutputConfig(**out_kw)
    return cfg.replace(**kw)


def load_concept_param(
    path: str, defines: dict | None = None, overrides: dict | None = None
) -> SimulationConfig:
    """CONCEPT ``.param`` file -> SimulationConfig.

    ``defines`` are pre-set names (the reference's ``_size`` injection);
    ``overrides`` are final SimulationConfig field replacements (the role
    of the reference's regex-templated override blocks).
    """
    ns = parse_concept_param(path, defines=defines)
    cfg = config_from_param_namespace(ns)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
