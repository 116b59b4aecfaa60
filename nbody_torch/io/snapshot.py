"""CONCEPT-compatible HDF5 snapshots.

The layout of :mod:`nbody.io.snapshot`:

  root attrs : H0 [Gyr^-1], a, boxsize [Mpc],
               'unit length'='Mpc', 'unit mass'='10**(10)*m_sun',
               'unit time'='Gyr', Ωb, Ωcdm
  group      : components/matter  (attrs N, mass, species='matter')
  datasets   : components/matter/pos (N,3) float64
               components/matter/mom (N,3) float64   (mom = mass * vel)

Writes are synchronous.  h5py is imported inside the functions, so the
package imports without it; a snapshot call without h5py raises
``ImportError``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from nbody_torch.core.types import ParticleState


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "h5py is required for CONCEPT snapshot I/O; run with "
            "output.snapshot=False where it is not installed"
        ) from e
    return h5py


@dataclasses.dataclass(frozen=True)
class SnapshotMeta:
    """Root + component attributes of a CONCEPT snapshot."""

    a: float = 1.0
    boxsize: float = 0.0  # Mpc
    H0: float = 0.0  # Gyr^-1
    Omega_b: float = 0.0
    Omega_cdm: float = 0.0
    species: str = "matter"
    unit_length: str = "Mpc"
    unit_mass: str = "10**(10)*m_sun"
    unit_time: str = "Gyr"

    @classmethod
    def from_cosmology(cls, cosmo, boxsize: float, a: float = 1.0):
        return cls(a=a, boxsize=boxsize, H0=cosmo.H0, Omega_b=cosmo.Omega_b,
                   Omega_cdm=cosmo.Omega_cdm)


def write_snapshot(path, state: ParticleState, meta: SnapshotMeta) -> None:
    """Write a ParticleState as a CONCEPT-layout HDF5 snapshot."""
    h5py = _h5py()
    pos = state.pos.detach().cpu().double().numpy()
    mass_np = state.mass.detach().cpu().double().numpy()
    mom = mass_np[:, None] * state.vel.detach().cpu().double().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        f.attrs["H0"] = float(meta.H0)
        f.attrs["a"] = float(meta.a)
        f.attrs["boxsize"] = float(meta.boxsize)
        f.attrs["unit length"] = meta.unit_length
        f.attrs["unit mass"] = meta.unit_mass
        f.attrs["unit time"] = meta.unit_time
        f.attrs["Ωb"] = float(meta.Omega_b)
        f.attrs["Ωcdm"] = float(meta.Omega_cdm)
        grp = f.create_group(f"components/{meta.species}")
        grp.attrs["N"] = np.int64(state.n)
        grp.attrs["mass"] = float(mass_np.mean())
        grp.attrs["species"] = meta.species
        grp.create_dataset("pos", data=pos)
        grp.create_dataset("mom", data=mom)


def read_snapshot(path, species: str = "matter", *, device=None,
                  dtype=torch.float32):
    """Read a CONCEPT snapshot -> (ParticleState, SnapshotMeta), with
    velocities mom / mass (canonical a^2 dx/dt per unit mass)."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        grp = f[f"components/{species}"]
        pos = grp["pos"][...]
        mom = grp["mom"][...]
        mass = float(grp.attrs["mass"])
        meta = SnapshotMeta(
            a=float(f.attrs.get("a", 1.0)),
            boxsize=float(f.attrs.get("boxsize", 0.0)),
            H0=float(f.attrs.get("H0", 0.0)),
            Omega_b=float(f.attrs.get("Ωb", 0.0)),
            Omega_cdm=float(f.attrs.get("Ωcdm", 0.0)),
            species=species,
        )
    state = ParticleState.create(pos, mom / mass,
                                 np.full(pos.shape[0], mass), meta.a,
                                 device=device, dtype=dtype)
    return state, meta


def find_hdf5_files(root) -> list:
    """The ``*.hdf5`` / ``*.h5`` files under ``root``, sorted (the
    reference's ``find_all_hdf5``)."""
    hits = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            if name.endswith(".hdf5") or name.endswith(".h5"):
                hits.append(os.path.join(dirpath, name))
    return sorted(hits)
