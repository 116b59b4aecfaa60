"""Background cosmology, growth factors and linear matter power spectra.

Counterpart of :mod:`nbody.core.cosmology`, host-side and float64: every
method takes and returns numpy arrays (or Python floats).  Device code
evaluates these once per run or per step on the host and moves the
result.  The classy adapter is not ported.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from nbody_torch.core import units

# Primordial pivot scale used by CLASS/Planck, in 1/Mpc.
K_PIVOT = 0.05


@dataclasses.dataclass(frozen=True)
class Cosmology:
    """Flat LCDM background + primordial power-law spectrum.

    Stores the physical densities omega_b = Omega_b h^2 and
    omega_cdm = Omega_cdm h^2, like the JAX package.
    """

    h: float = 0.67
    omega_b: float = 0.022
    omega_cdm: float = 0.12
    A_s: float = 2.1e-9
    n_s: float = 0.965
    T_cmb: float = 2.7255

    @property
    def Omega_b(self) -> float:
        return self.omega_b / self.h**2

    @property
    def Omega_cdm(self) -> float:
        return self.omega_cdm / self.h**2

    @property
    def Omega_m(self) -> float:
        return self.Omega_b + self.Omega_cdm

    @property
    def Omega_L(self) -> float:
        return 1.0 - self.Omega_m

    @property
    def H0(self) -> float:
        """H0 in Gyr^-1 (cosmo unit system)."""
        return units.hubble_gyr(self.h)

    # -- background --------------------------------------------------------
    def E(self, a):
        """Dimensionless Hubble rate H(a)/H0 (flat, matter + Lambda)."""
        a = np.asarray(a, dtype=np.float64)
        return np.sqrt(self.Omega_m / a**3 + self.Omega_L)

    def H(self, a):
        """H(a) in Gyr^-1."""
        return self.H0 * self.E(a)

    # -- growth ------------------------------------------------------------
    @functools.cached_property
    def _growth_table(self):
        """(ln a, D, f, D0) on a log-a grid; D(1) = 1, f = dlnD/dlna.

        D(a) = (5 Omega_m / 2) E(a) int_0^a da' / (a' E(a'))^3, with the
        matter-dominated contribution below a_min added analytically."""
        lna = np.linspace(np.log(1e-4), np.log(2.0), 1024)
        a = np.exp(lna)
        E = np.sqrt(self.Omega_m / a**3 + self.Omega_L)
        w = 1.0 / (a * E) ** 3 * a
        integral = np.concatenate(
            [[0.0], np.cumsum(0.5 * (w[1:] + w[:-1]) * np.diff(lna))]
        )
        integral += 0.4 * a[0] ** 2.5 / self.Omega_m**1.5
        D_md = 2.5 * self.Omega_m * E * integral
        D0 = float(np.interp(0.0, lna, D_md))
        D = D_md / D0
        f = np.gradient(np.log(D), lna)
        return lna, D, f, D0

    def growth_D(self, a):
        """Linear growth factor D(a), normalised so D(1)=1."""
        lna_t, D_t, _, _ = self._growth_table
        return np.interp(np.log(np.asarray(a, dtype=np.float64)), lna_t, D_t)

    def growth_f(self, a):
        """Logarithmic growth rate f = dlnD/dlna."""
        lna_t, _, f_t, _ = self._growth_table
        return np.interp(np.log(np.asarray(a, dtype=np.float64)), lna_t, f_t)

    @property
    def growth_suppression(self) -> float:
        """g0 = D_md(1) (~0.78 for Planck LCDM)."""
        return self._growth_table[3]

    def growth_D2(self, a):
        """Second-order growth factor, D2 ~ -3/7 D^2 Omega_m(a)^{-1/143}."""
        D = self.growth_D(a)
        a = np.asarray(a, dtype=np.float64)
        Om_a = self.Omega_m / a**3 / self.E(a) ** 2
        return -3.0 / 7.0 * D**2 * Om_a ** (-1.0 / 143.0)

    # -- transfer functions --------------------------------------------------
    def transfer_eh(self, k):
        """Eisenstein & Hu (1998) zero-baryon-wiggle transfer function
        (k in 1/Mpc)."""
        k = np.asarray(k, dtype=np.float64)
        h = self.h
        om = self.Omega_m * h**2
        ob = self.Omega_b * h**2
        theta = self.T_cmb / 2.7
        fb = self.Omega_b / self.Omega_m
        s = 44.5 * np.log(9.83 / om) / np.sqrt(1.0 + 10.0 * ob**0.75)
        alpha = (
            1.0
            - 0.328 * np.log(431.0 * om) * fb
            + 0.38 * np.log(22.3 * om) * fb**2
        )
        gamma_eff = self.Omega_m * h * (
            alpha + (1.0 - alpha) / (1.0 + (0.43 * k * s) ** 4)
        )
        q = k * theta**2 / (gamma_eff * h)
        L0 = np.log(2.0 * np.e + 1.8 * q)
        C0 = 14.2 + 731.0 / (1.0 + 62.5 * q)
        return L0 / (L0 + C0 * q**2)

    def transfer_bbks(self, k):
        """BBKS (1986) transfer function with the Sugiyama (1995) shape."""
        k = np.asarray(k, dtype=np.float64)
        h = self.h
        gamma = self.Omega_m * h * np.exp(
            -self.Omega_b * (1.0 + np.sqrt(2.0 * h) / self.Omega_m)
        )
        q = np.maximum(k / (gamma * h), 1e-12)
        return (
            np.log(1.0 + 2.34 * q)
            / (2.34 * q)
            * (1.0 + 3.89 * q + (16.1 * q) ** 2 + (5.46 * q) ** 3
               + (6.71 * q) ** 4) ** -0.25
        )

    # -- linear power spectrum ----------------------------------------------
    def linear_power(self, k, a=1.0, transfer: str = "eh"):
        """Linear matter power spectrum P(k, a) in Mpc^3 (k in 1/Mpc),
        from A_s through the Poisson relation (see the JAX package)."""
        k = np.asarray(k, dtype=np.float64)
        T = self.transfer_eh(k) if transfer == "eh" else self.transfer_bbks(k)
        D_md = self.growth_D(a) * self.growth_suppression
        c_over_H0 = units.C_KMS / (100.0 * self.h)
        bracket = 0.4 * (k * c_over_H0) ** 2 * T * D_md / self.Omega_m
        prim = (
            2.0 * np.pi**2 / np.maximum(k, 1e-30) ** 3 * self.A_s
            * (k / K_PIVOT) ** (self.n_s - 1.0)
        )
        return prim * bracket**2

    def sigma_R(self, R, a=1.0, transfer: str = "eh"):
        """RMS of delta smoothed with a top-hat of radius R Mpc."""
        lnk = np.linspace(np.log(1e-5), np.log(1e3), 2048)
        k = np.exp(lnk)
        P = self.linear_power(k, a=a, transfer=transfer)
        x = k * R
        W = 3.0 * (np.sin(x) - x * np.cos(x)) / x**3
        return float(np.sqrt(np.trapezoid(k**3 * P * W**2 / (2.0 * np.pi**2), lnk)))

    def sigma8(self, a=1.0, transfer: str = "eh"):
        """sigma_8: top-hat radius 8 Mpc/h."""
        return self.sigma_R(8.0 / self.h, a=a, transfer=transfer)


@dataclasses.dataclass(frozen=True, eq=False)
class TabulatedPowerSpectrum:
    """Linear P(k) from a table, interpolated in log-log (host numpy)."""

    logk: np.ndarray  # ascending log k [1/Mpc]
    logP: np.ndarray  # log P [Mpc^3]

    @classmethod
    def from_arrays(cls, k, P, extrapolate: bool = True) -> "TabulatedPowerSpectrum":
        """``extrapolate=True`` extends the table three decades past each
        end along the boundary log-log slopes."""
        k = np.asarray(k, dtype=np.float64)
        P = np.asarray(P, dtype=np.float64)
        good = (k > 0) & (P > 0)
        k, P = k[good], P[good]
        order = np.argsort(k)
        logk, logP = np.log(k[order]), np.log(P[order])
        if extrapolate and logk.size >= 2:
            s_lo = (logP[1] - logP[0]) / (logk[1] - logk[0])
            s_hi = (logP[-1] - logP[-2]) / (logk[-1] - logk[-2])
            span = 3.0 * np.log(10.0)
            logk = np.concatenate([[logk[0] - span], logk, [logk[-1] + span]])
            logP = np.concatenate(
                [[logP[0] - s_lo * span], logP, [logP[-1] + s_hi * span]]
            )
        return cls(logk=logk, logP=logP)

    @classmethod
    def from_file(cls, path, h: float = 1.0, in_h_units: bool = False):
        """A two-column (k, P) text file, or a CONCEPT powerspec file whose
        ``P_linear`` column supplies the spectrum.  ``in_h_units=True``
        converts k in h/Mpc and P in (Mpc/h)^3 to Mpc units."""
        with open(path, encoding="utf-8", errors="ignore") as f:
            head = f.read(400)
        if "Power spectrum from" in head:
            return cls.from_powerspec(path)
        data = np.loadtxt(path, comments="#")
        k, P = data[:, 0], data[:, 1]
        if in_h_units:
            k = k * h
            P = P / h**3
        return cls.from_arrays(k, P)

    @classmethod
    def from_powerspec(cls, path) -> "TabulatedPowerSpectrum":
        from nbody_torch.io.powerspec import read_powerspec

        tab = read_powerspec(path)
        if tab.P_linear is None:
            raise ValueError(f"{path} has no linear-P column")
        return cls.from_arrays(tab.k, tab.P_linear)

    def __call__(self, k):
        k = np.asarray(k, dtype=np.float64)
        return np.exp(np.interp(np.log(np.maximum(k, 1e-30)), self.logk, self.logP))
