"""Unit systems.

The cosmological unit system matches the reference's CONCEPT snapshot
attributes (``unit length='Mpc'``, ``unit mass='10**(10)*m_sun'``,
``unit time='Gyr'`` — see reference snapshot schema, SURVEY.md §2.4, read at
reference `SnapVsPK/Power_compare.py:71-77`), so snapshots written by this
framework are drop-in compatible with the reference's readers.
"""

from __future__ import annotations

import dataclasses
import math

# --- SI anchors ----------------------------------------------------------
G_SI = 6.67430e-11            # m^3 kg^-1 s^-2 (CODATA 2018)
MPC_M = 3.0856775814913673e22  # IAU 2015 parsec * 1e6
KPC_M = MPC_M * 1e-3
GYR_S = 3.15576e16            # Julian Gyr
YR_S = 3.15576e7              # Julian year
AU_M = 1.495978707e11         # IAU 2012 definition
MSUN_KG = 1.98847e30          # IAU nominal solar mass
C_KMS = 299792.458            # speed of light, km/s

# 1 km/s expressed in Mpc/Gyr
KMS_IN_MPC_PER_GYR = 1.0e3 * GYR_S / MPC_M  # ~1.02271e-3

# H0 = 100 h km/s/Mpc in Gyr^-1 is 100*h*KMS_IN_MPC_PER_GYR
H100_GYR = 100.0 * KMS_IN_MPC_PER_GYR  # ~0.1022712 Gyr^-1


@dataclasses.dataclass(frozen=True)
class UnitSystem:
    """A (length, time, mass) unit system with its gravitational constant.

    ``G`` is precomputed as a plain Python float.
    """

    name: str
    length_m: float
    time_s: float
    mass_kg: float
    G: float = dataclasses.field(default=0.0)

    def __post_init__(self):
        if self.G == 0.0:
            g = G_SI * self.mass_kg * self.time_s**2 / self.length_m**3
            object.__setattr__(self, "G", g)

    @property
    def velocity_kms(self) -> float:
        """One velocity unit expressed in km/s."""
        return self.length_m / self.time_s / 1.0e3


#: Cosmological units: Mpc / Gyr / 1e10 Msun (CONCEPT snapshot convention).
COSMO = UnitSystem("cosmo[Mpc,Gyr,1e10Msun]", MPC_M, GYR_S, 1.0e10 * MSUN_KG)

#: Solar-system units: AU / yr / Msun.  G is close to 4 pi^2.
SOLAR = UnitSystem("solar[AU,yr,Msun]", AU_M, YR_S, MSUN_KG)

#: Galactic units: kpc / Gyr / Msun.
GALACTIC = UnitSystem("galactic[kpc,Gyr,Msun]", KPC_M, GYR_S, MSUN_KG)

#: Henon / N-body units: G = M = 1, E = -1/4 (dimensionless).
HENON = UnitSystem("henon[G=1]", 1.0, 1.0, 1.0, G=1.0)


def hubble_gyr(h: float) -> float:
    """H0 in Gyr^-1 for a dimensionless little-h."""
    return H100_GYR * h


def _selfcheck() -> None:
    # G in cosmo units ~ 4.4988e-5 Mpc^3 Gyr^-2 (1e10 Msun)^-1
    assert abs(COSMO.G / 4.4988e-5 - 1) < 1e-3, COSMO.G
    # G in solar units ~ 4 pi^2 AU^3 yr^-2 Msun^-1 (Kepler's third law)
    assert abs(SOLAR.G / (4 * math.pi**2) - 1) < 1e-3, SOLAR.G


_selfcheck()
