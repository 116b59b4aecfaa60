"""Plain-text sidecar files: the cross-stage contract of the reference.

Counterpart of :mod:`nbody.io.sidecars`, byte for byte the same files
(the reference writes them in
`TheFeedingPipeline/Cosmo data create (new).py` and `NeuNetværk_test.py`
and reads them in `Cosmo NN5.py`):

  BoxParams.txt     : one row  ``z  L  N``            (tab-separated)
  MaxMinParams.txt  : one row  ``A_s_min A_s_max n_s_min n_s_max
                                 omega_min omega_max N_samples``
  *Params.txt       : TSV, header ``A_s \t n_s \t omega_cdm`` then one row
                      per sample (labels for the emulator)
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class BoxParams:
    z: float
    L: float
    N: int


@dataclasses.dataclass(frozen=True)
class MaxMinParams:
    A_s_min: float
    A_s_max: float
    n_s_min: float
    n_s_max: float
    omega_cdm_min: float
    omega_cdm_max: float
    n_samples: int

    def maxima(self) -> np.ndarray:
        """(A_s_max, n_s_max, omega_cdm_max): the emulator's label
        normalisers."""
        return np.array([self.A_s_max, self.n_s_max, self.omega_cdm_max])


def _mkdir_for(path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def write_box_params(path, bp: BoxParams) -> None:
    _mkdir_for(path)
    with open(path, "w") as f:
        f.write(f"{bp.z:g}\t{bp.L:g}\t{bp.N:d}\n")


def read_box_params(path) -> BoxParams:
    row = np.loadtxt(path, ndmin=1)
    return BoxParams(z=float(row[0]), L=float(row[1]), N=int(row[2]))


def write_maxmin_params(path, mm: MaxMinParams) -> None:
    _mkdir_for(path)
    with open(path, "w") as f:
        f.write(
            f"{mm.A_s_min:g}\t{mm.A_s_max:g}\t{mm.n_s_min:g}\t{mm.n_s_max:g}"
            f"\t{mm.omega_cdm_min:g}\t{mm.omega_cdm_max:g}\t{mm.n_samples:d}\n"
        )


def read_maxmin_params(path) -> MaxMinParams:
    row = np.loadtxt(path, ndmin=1)
    return MaxMinParams(
        A_s_min=float(row[0]), A_s_max=float(row[1]),
        n_s_min=float(row[2]), n_s_max=float(row[3]),
        omega_cdm_min=float(row[4]), omega_cdm_max=float(row[5]),
        n_samples=int(row[6]),
    )


PARAM_COLUMNS = ("A_s", "n_s", "omega_cdm")


def write_param_table(path, labels) -> None:
    """Write a Training/Val/TestParams.txt label table from ``labels``,
    an (M, 3) array of (A_s, n_s, omega_cdm) rows."""
    labels = np.atleast_2d(np.asarray(labels, dtype=np.float64))
    if labels.shape[1] != 3:
        raise ValueError(f"expected (M,3) labels, got {labels.shape}")
    _mkdir_for(path)
    with open(path, "w") as f:
        f.write(" \t ".join(PARAM_COLUMNS) + " \n")
        for row in labels:
            f.write(" \t ".join(repr(float(v)) for v in row) + " \n")


def read_param_table(path) -> np.ndarray:
    """(M, 3) labels from a *Params.txt file (header row skipped)."""
    return np.atleast_2d(np.loadtxt(path, skiprows=1, ndmin=2))
