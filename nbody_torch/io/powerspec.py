"""CONCEPT-compatible power-spectrum text files.

The same reader and writer as :mod:`nbody.io.powerspec` (host numpy, no
JAX), so files written by either package read back in both.

Format (from the reference's `PPPMP3M/PP/powerspec/powerspec_a=1.00:1-11`,
parsed by `pppmp3mplotter.py:123-135` usecols (0,2,3,4) and
`SnapVsPK/Power_compare.py:625-633` usecols (0,2,3); SURVEY.md §2.4):

  # comment header (job line, component list, grid size, σ₈ values)
  columns: k [Mpc⁻¹]   modes   P [Mpc³]   [P_corrected [Mpc³]]   [P_linear [Mpc³]]

Readers here tolerate both 3- and 5-column variants and non-ASCII header
glyphs (the reference decodes with ``errors='ignore'``; we read utf-8).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class PowerSpecTable:
    """One measured spectrum: k in 1/Mpc, modes per bin, P columns in Mpc^3."""

    k: np.ndarray
    modes: np.ndarray
    P: np.ndarray
    P_corrected: np.ndarray | None = None
    P_linear: np.ndarray | None = None
    sigma8: float | None = None
    sigma8_corrected: float | None = None
    sigma8_linear: float | None = None
    a: float | None = None


def write_powerspec(
    path,
    k,
    modes,
    P,
    P_corrected=None,
    P_linear=None,
    *,
    a: float = 1.0,
    gridsize: int | None = None,
    sigma8: float | None = None,
    sigma8_corrected: float | None = None,
    sigma8_linear: float | None = None,
    component: str = "matter",
) -> None:
    """Write a spectrum in the CONCEPT text layout (3 or 5 columns)."""
    k = np.asarray(k, dtype=np.float64)
    modes = np.asarray(modes)
    cols = [k, modes, np.asarray(P, dtype=np.float64)]
    names = ["component 0", ]
    if P_corrected is not None:
        cols.append(np.asarray(P_corrected, dtype=np.float64))
        names.append("(corrected)")
    if P_linear is not None:
        cols.append(np.asarray(P_linear, dtype=np.float64))
        names.append("(linear)")

    def s8(v):
        return f"σ₈ = {v:.2e}" if v is not None else " " * 13

    lines = [
        f"# Power spectrum from nbody-tpu at a = {a:g}",
        "#",
        "# Components:",
        f"#   0: {component}"
        + (f"  (upstream grid size {gridsize})" if gridsize else ""),
        "#",
    ]
    if gridsize:
        lines.append(f"#{'grid size ' + str(gridsize):>37}")
    sig_vals = [sigma8, sigma8_corrected, sigma8_linear][: len(names)]
    lines.append("#" + "".join(f"{n:>15}" for n in names).rjust(15 * len(names) + 19))
    lines.append(
        "#"
        + "".join(f"{s8(v):>15}" for v in sig_vals).rjust(15 * len(names) + 19)
    )
    header = " k [Mpc⁻¹]   modes" + "".join("       P [Mpc³]" for _ in names)
    lines.append("#" + header)
    body = []
    for i in range(len(k)):
        row = f"{k[i]:.7e} {int(modes[i]):6d}"
        for c in cols[2:]:
            row += f"  {c[i]:.7e}"
        body.append(row)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines + body) + "\n")


def read_powerspec(path) -> PowerSpecTable:
    """Read a CONCEPT (or this framework's) powerspec text file.

    Accepts 3-, 4- or 5-column layouts; σ₈ values and the scale factor are
    scraped from the header when present (the reference hard-codes column
    indices instead — `pppmp3mplotter.py:123-135`).
    """
    sig = []
    a = None
    rows = []
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            if line.lstrip().startswith("#"):
                if "8 =" in line or "₈ =" in line:
                    for tok in line.replace("=", " = ").split("="):
                        tok = tok.strip().split()
                        if tok:
                            try:
                                sig.append(float(tok[0]))
                            except ValueError:
                                pass
                if " a = " in line:
                    try:
                        a = float(line.split(" a = ")[1].split(",")[0].split()[0])
                    except (ValueError, IndexError):
                        pass
                continue
            try:
                rows.append([float(x) for x in line.split()])
            except ValueError:
                continue
    data = np.asarray(rows, dtype=np.float64)
    if data.size == 0:
        raise ValueError(f"no data rows in {path}")
    ncol = data.shape[1]
    return PowerSpecTable(
        k=data[:, 0],
        modes=data[:, 1].astype(np.int64),
        P=data[:, 2],
        P_corrected=data[:, 3] if ncol >= 4 else None,
        P_linear=data[:, 4] if ncol >= 5 else None,
        sigma8=sig[0] if len(sig) >= 1 else None,
        sigma8_corrected=sig[1] if len(sig) >= 2 else None,
        sigma8_linear=sig[2] if len(sig) >= 3 else None,
        a=a,
    )
