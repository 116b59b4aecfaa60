"""Solver/resolution/LPT comparison studies + runtime parsing.

Rebuilds the reference's quantitative accuracy machinery:
  - `parse_runtime` (`PPPMP3M/pppmp3mplotter.py:24-58`, component C12):
    "2 days, 23:27:37" / "4:18 min" / "12.1 s" -> seconds.
  - relative P(k) error vs linear theory masked to k <= k_Nyquist with a
    per-solver mean (`pppmp3mplotter.py:145-161`).
  - PP/PM/P3M comparison figure (`:163-176`), 1LPT-vs-2LPT comparison
    (`1LPTvs2LPT/1vs2tlptplotter.py:160-204`), and the grid-size
    convergence study (`Different_Sizes/Plotter.py:207-291`).

Counterpart of :mod:`nbody.analysis.compare`: the studies run the port's
``run_simulation`` and ``measure_powerspec`` in-process (on the card
unless ``device`` says otherwise) instead of scraping pre-existing
CONCEPT output directories; matplotlib is imported inside the figure
functions.
"""

from __future__ import annotations

import re
import time

import numpy as np


# --------------------------------------------------------------------------
# C12: runtime parsing
# --------------------------------------------------------------------------


_DAY_PREFIX = re.compile(r"^(\d+)\s*days?\s*,?\s*")


def parse_runtime(text: str) -> float:
    """Convert a human runtime string to seconds.

    Accepts the three formats that appear in the reference's hard-coded
    solver runtime table (role of `pppmp3mplotter.py:24-58`):
    ``"2 days, 23:27:37"``, ``"4:18 min"``, ``"12.1 s"``.  Design here is
    positional: strip an optional day prefix, then weight the remaining
    colon-separated fields from the right (s, min, h) — with a ``min``
    suffix shifting the weights up one slot.
    """
    t = text.strip().lower()
    total = 0.0
    day = _DAY_PREFIX.match(t)
    if day:
        total += 86400.0 * int(day.group(1))
        t = t[day.end():]
    if t.endswith("min"):
        # "4:18 min" means 4 min 18 s; bare "7 min" means 7 minutes
        fields = [float(x) for x in t[:-3].strip().split(":") if x.strip()]
        return total + 60.0 * fields[0] + (fields[1] if len(fields) > 1 else 0.0)
    if t.endswith("s") and ":" not in t:
        return total + float(t[:-1])
    fields = [float(x) for x in t.split(":") if x.strip()]
    if not fields and not day:
        raise ValueError(f"unparseable runtime: {text!r}")
    for w, v in zip((1.0, 60.0, 3600.0), reversed(fields)):
        total += w * v
    return total


# --------------------------------------------------------------------------
# Accuracy metrics
# --------------------------------------------------------------------------


def nyquist_k(nmesh: int, box: float) -> float:
    """k_Ny = pi * N / L — the validity boundary every reference figure
    marks (`CiC/3D startbetingelser1.py:321-348`)."""
    return np.pi * nmesh / box


def relative_error(k, P, k_theory, P_theory, k_max=None):
    """|P - P_th| / P_th on P's k-grid, theory interpolated, masked to
    k <= k_max (`pppmp3mplotter.py:152-158`).  Returns (k_masked, rel)."""
    k = np.asarray(k, dtype=np.float64)
    P = np.asarray(P, dtype=np.float64)
    mask = np.ones_like(k, dtype=bool) if k_max is None else k <= k_max
    Pi = np.interp(k[mask], np.asarray(k_theory), np.asarray(P_theory))
    return k[mask], np.abs(P[mask] - Pi) / Pi


def mean_relative_error(k, P, k_theory, P_theory, k_max=None) -> float:
    """The reference's per-solver scalar accuracy (`:158-161`)."""
    _, rel = relative_error(k, P, k_theory, P_theory, k_max)
    return float(rel.mean()) if rel.size else float("nan")


def signed_deviation_percent(k, P, k_theory, P_theory, k_max=None):
    """SIGNED per-bin deviation 100 * (P - P_th) / P_th, theory
    interpolated onto P's k-grid, masked to k <= k_max — the quantity
    the reference's per-solver error histograms plot
    (`pppmp3mplotter.py:181-212`).  Returns (k_masked, dev_percent)."""
    k = np.asarray(k, dtype=np.float64)
    P = np.asarray(P, dtype=np.float64)
    mask = np.ones_like(k, dtype=bool) if k_max is None else k <= k_max
    Pi = np.interp(k[mask], np.asarray(k_theory), np.asarray(P_theory))
    return k[mask], 100.0 * (P[mask] - Pi) / Pi


# --------------------------------------------------------------------------
# Comparison studies
# --------------------------------------------------------------------------


def _run_and_measure(config, seed, workdir, device="cuda", dtype=None):
    from nbody_torch.driver.simulate import measure_powerspec, run_simulation

    t0 = time.perf_counter()
    res = run_simulation(
        config.replace(output=config.output.replace(snapshot=False, powerspec=False)),
        seed=seed,
        workdir=workdir or "",
        device=device,
        dtype=dtype,
    )
    wall = time.perf_counter() - t0
    k, modes, P, Pc, Pl = measure_powerspec(
        res.state.pos, config, a=config.a_end, seed=seed
    )
    return {"k": k, "P": Pc, "P_raw": P, "P_linear": Pl, "modes": modes, "wall_s": wall}


def compare_solver_spectra(
    config, solvers=("pp", "pm", "p3m"), seed: int = 0,
    fig_path: str | None = None, hist_fig_path: str | None = None,
    *, device="cuda", dtype=None,
) -> dict:
    """Run the same realization through each solver; return per-solver
    spectra + mean relative error vs linear theory + runtimes — the
    PP/PM/P3M accuracy-vs-cost study (`pppmp3mplotter.py`).

    The reference's version of this took 2d23h (PP), 4:18min (P3M) and
    12.1s (PM) on a desktop for N=64^3 (SURVEY.md §6).
    ``hist_fig_path`` additionally writes the reference's per-solver
    signed %-deviation histogram figure (its "Figur 3").
    """
    k_ny = nyquist_k(config.mesh_size, config.box)
    out = {}
    for solver in solvers:
        r = _run_and_measure(config.replace(solver=solver), seed, None,
                             device, dtype)
        r["mean_rel_err"] = mean_relative_error(
            r["k"], r["P"], r["k"], r["P_linear"], k_max=k_ny
        )
        r["k_dev"], r["signed_dev_percent"] = signed_deviation_percent(
            r["k"], r["P"], r["k"], r["P_linear"], k_max=k_ny
        )
        out[solver] = r
    if fig_path:
        _solver_figure(out, config, k_ny, fig_path)
    if hist_fig_path:
        deviation_histogram_figure(out, config, hist_fig_path)
    return out


def deviation_histogram_figure(results, config, fig_path):
    """Per-solver signed %-deviation bar histograms, shared axes — the
    reference's `pppmp3mplotter.py:181-212` "fejl-histogrammer" figure
    (one narrow log-spaced bar per k-bin, zero line, solver titles)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(results)
    fig, axs = plt.subplots(
        1, max(len(names), 1), figsize=(4 * max(len(names), 1), 6),
        sharey=True, sharex=True, squeeze=False,
    )
    colors = ["tab:blue", "tab:orange", "tab:green", "tab:red"]
    for ax, name, col in zip(axs[0], names, colors):
        r = results[name]
        kv = np.asarray(r["k_dev"])
        dev = np.asarray(r["signed_dev_percent"])
        if kv.size > 1:
            width = np.diff(np.log10(kv)).min() * 0.2
        else:
            width = 0.01
        ax.bar(kv, dev, width=width, color=col, alpha=0.7, align="center")
        ax.axhline(0, color="k", lw=0.8)
        ax.set_xscale("log")
        ax.set_xlabel(r"$k$ [Mpc$^{-1}$]")
        ax.set_title(name)
        ax.grid(ls=":", alpha=0.7)
    axs[0][0].set_ylabel("Relative deviation [%]")
    fig.suptitle("Deviation from linear power spectrum")
    fig.tight_layout()
    fig.savefig(fig_path, dpi=120)
    plt.close(fig)
    return fig_path


def _solver_figure(results, config, k_ny, fig_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    markers = {"pp": "o", "pm": "s", "p3m": "^"}
    ref = next(iter(results.values()))
    ax1.loglog(ref["k"], ref["P_linear"], "k-", lw=1.5, label="linear theory")
    for name, r in results.items():
        ax1.scatter(r["k"], r["P"], s=12, marker=markers.get(name, "x"),
                    label=f"{name} (err {r['mean_rel_err']:.2%})")
        ax2.bar(name, r["wall_s"])
    ax1.axvline(k_ny, ls="--", color="grey", label="Nyquist")
    ax1.set(xlabel=r"$k$ [Mpc$^{-1}$]", ylabel=r"$P(k)$ [Mpc$^3$]",
            title=f"$N={config.n_side}^3$, $L={config.box:g}$ Mpc")
    ax1.legend()
    ax2.set(ylabel="wall time [s]", title="cost")
    fig.tight_layout()
    fig.savefig(fig_path, dpi=120)
    plt.close(fig)


def lpt_comparison(
    config, seed: int = 0, fig_path: str | None = None, *, device="cuda",
    dtype=None,
) -> dict:
    """1LPT vs 2LPT initial spectra + evolved spectra — the
    `1LPTvs2LPT/1vs2tlptplotter.py` study."""
    out = {}
    for order in (1, 2):
        r = _run_and_measure(config.replace(lpt_order=order), seed, None,
                             device, dtype)
        out[f"{order}lpt"] = r
    if fig_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        ref = out["1lpt"]
        ax.loglog(ref["k"], ref["P_linear"], "k-", lw=1.5, label="linear")
        for name, r in out.items():
            ax.scatter(r["k"], r["P"], s=12, label=name)
        ax.axvline(nyquist_k(config.mesh_size, config.box), ls="--", color="grey")
        ax.set(xlabel=r"$k$ [Mpc$^{-1}$]", ylabel=r"$P(k)$ [Mpc$^3$]")
        ax.legend()
        fig.tight_layout()
        fig.savefig(fig_path, dpi=120)
        plt.close(fig)
    return out


def resolution_study(
    config, n_sides=(16, 32, 64), seed: int = 0, fig_path: str | None = None,
    *, device="cuda", dtype=None,
) -> dict:
    """P(k) across particle/grid resolutions at fixed box — the
    `Different_Sizes` scaling study (`Plotter.py:207-291`)."""
    out = {}
    for n in n_sides:
        r = _run_and_measure(config.replace(n_side=n, pm_grid=0), seed, None,
                             device, dtype)
        r["k_ny"] = nyquist_k(2 * n, config.box)
        out[n] = r
    if fig_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        ref = out[max(n_sides)]
        ax.loglog(ref["k"], ref["P_linear"], "k-", lw=1.5, label="linear")
        for n, r in out.items():
            ax.scatter(r["k"], r["P"], s=10, label=f"$N={n}^3$")
        ax.set(xlabel=r"$k$ [Mpc$^{-1}$]", ylabel=r"$P(k)$ [Mpc$^3$]")
        ax.legend()
        fig.tight_layout()
        fig.savefig(fig_path, dpi=120)
        plt.close(fig)
    return out


def ensemble_scatter(
    ensemble_root, config=None, fig_path: str | None = None
):
    """Realization scatter of P(k) across an ensemble's run dirs.

    The purpose of the reference's `SnapVsPK/Ucertain.py` study: many runs
    differing only in random seeds quantify the sample variance band of
    the measured spectrum.  Reads each member's final powerspec file and
    returns (k, mean P, std P, n_members); optionally plots the band
    against the linear spectrum.
    """
    import os

    from nbody_torch.io.powerspec import read_powerspec

    spectra = []
    k_ref = None
    for d in sorted(os.listdir(ensemble_root)):
        psdir = os.path.join(ensemble_root, d, "powerspec")
        if not os.path.isdir(psdir):
            continue
        files = sorted(os.listdir(psdir))
        if not files:
            continue
        t = read_powerspec(os.path.join(psdir, files[-1]))
        good = t.modes > 0
        if k_ref is None:
            k_ref = t.k[good]
        P = t.P_corrected if t.P_corrected is not None else t.P
        spectra.append(np.interp(k_ref, t.k[good], P[good]))
    if not spectra:
        raise ValueError(f"no powerspec files under {ensemble_root}")
    S = np.vstack(spectra)
    mean, std = S.mean(0), S.std(0)

    if fig_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        ax.fill_between(k_ref, mean - std, mean + std, alpha=0.3,
                        label=f"±1σ over {len(S)} runs")
        ax.loglog(k_ref, mean, lw=1.5, label="ensemble mean")
        if config is not None:
            cosmo = config.cosmology()
            Pl = np.asarray(cosmo.linear_power(k_ref, a=config.a_end))
            ax.loglog(k_ref, Pl, "k--", lw=1, label="linear theory")
        ax.set(xlabel=r"$k$ [Mpc$^{-1}$]", ylabel=r"$P(k)$ [Mpc$^3$]",
               title="realization scatter")
        ax.legend()
        fig.tight_layout()
        fig.savefig(fig_path, dpi=120)
        plt.close(fig)
    return k_ref, mean, std, len(S)
