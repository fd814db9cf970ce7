"""Spherical mass models (host-side NumPy/SciPy; a copy of
`SphericalModelTable` (with `from_density`), `hernquist_model` and
`add_disk_to_model` from exp_tpu/basis/model.py).

`SphericalModelTable` is the background profile a basis or an IC generator
needs: rho(r), M(r), Phi(r), in the reference's 4-column file format

    ! comment lines ...
    <numr>
    r  rho  M(r)  Phi(r)

Units: G = 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.interpolate import CubicSpline


@dataclass
class SphericalModelTable:
    """Tabulated spherical profile with spline interpolation.

    Attributes:
      r:   radii, strictly increasing (numr,)
      rho: density at r
      mass: enclosed mass M(r)
      pot: potential Phi(r)  (negative, G=1)
    """

    r: np.ndarray
    rho: np.ndarray
    mass: np.ndarray
    pot: np.ndarray
    comment: str = ""

    def __post_init__(self):
        self.r = np.asarray(self.r, dtype=np.float64)
        self.rho = np.asarray(self.rho, dtype=np.float64)
        self.mass = np.asarray(self.mass, dtype=np.float64)
        self.pot = np.asarray(self.pot, dtype=np.float64)
        # interpolate in log r where possible for dynamic range
        self._logr = self.r[0] > 0.0
        x = np.log(self.r) if self._logr else self.r
        self._x = x
        self._rho_sp = CubicSpline(x, self.rho)
        self._mass_sp = CubicSpline(x, self.mass)
        self._pot_sp = CubicSpline(x, self.pot)

    @classmethod
    def from_file(cls, path) -> "SphericalModelTable":
        comments = []
        rows = []
        n = None
        with open(path) as f:
            for line in f:
                s = line.strip()
                if not s:
                    continue
                if s.startswith(("!", "#")):
                    comments.append(s)
                    continue
                parts = s.split()
                if n is None and len(parts) == 1:
                    n = int(parts[0])
                    continue
                rows.append([float(p) for p in parts[:4]])
        a = np.array(rows)
        if n is not None:
            a = a[:n]
        return cls(a[:, 0], a[:, 1], a[:, 2], a[:, 3],
                   comment="\n".join(comments))

    def to_file(self, path):
        with open(path, "w") as f:
            if self.comment:
                for line in self.comment.splitlines():
                    f.write(line if line.startswith(("!", "#"))
                            else "! " + line)
                    f.write("\n")
            f.write(f"{len(self.r):10d}\n")
            for r, d, m, p in zip(self.r, self.rho, self.mass, self.pot):
                f.write(f"  {r: .12e}  {d: .12e}  {m: .12e}  {p: .12e}\n")

    def _xof(self, r):
        r = np.asarray(r, dtype=np.float64)
        rc = np.clip(r, self.r[0], self.r[-1])
        return np.log(rc) if self._logr else rc

    def get_density(self, r):
        r = np.asarray(r, dtype=np.float64)
        out = self._rho_sp(self._xof(r))
        return np.where(r > self.r[-1], 0.0, np.maximum(out, 0.0))

    def get_mass(self, r):
        r = np.asarray(r, dtype=np.float64)
        out = self._mass_sp(self._xof(r))
        return np.where(r > self.r[-1], self.mass[-1], out)

    def get_pot(self, r):
        r = np.asarray(r, dtype=np.float64)
        inside = self._pot_sp(self._xof(r))
        # Keplerian continuation outside the table
        outside = -self.mass[-1] / np.maximum(r, self.r[-1])
        return np.where(r > self.r[-1], outside, inside)

    def get_dpot(self, r):
        """dPhi/dr = M(r)/r^2 (exact for spherical symmetry, G=1)."""
        r = np.asarray(r, dtype=np.float64)
        rs = np.maximum(r, self.r[0])
        return self.get_mass(rs) / rs**2

    @property
    def rmin(self):
        return float(self.r[0])

    @property
    def rmax(self):
        return float(self.r[-1])

    @property
    def total_mass(self):
        return float(self.mass[-1])

    @classmethod
    def from_density(cls, rho_fn, rmin: float, rmax: float, numr: int = 2000,
                     comment: str = "") -> "SphericalModelTable":
        """Build a table from a density callable by integrating M and Phi.

        Uses fine log-spaced quadrature of
          M(r)   = 4 pi \\int_0^r rho s^2 ds
          Phi(r) = -M(r)/r - 4 pi \\int_r^inf rho s ds
        """
        # fine integration grid, extended inward of rmin for the cusp/core
        r_lo = rmin * 1e-3
        rf = np.geomspace(r_lo, rmax, 20001)
        rhof = np.asarray(rho_fn(rf), dtype=np.float64)
        integrand_m = 4.0 * np.pi * rhof * rf**2
        # cumulative trapezoid for M(r)
        dm = 0.5 * (integrand_m[1:] + integrand_m[:-1]) * np.diff(rf)
        Mf = np.concatenate([[0.0], np.cumsum(dm)])
        integrand_p = 4.0 * np.pi * rhof * rf
        dp = 0.5 * (integrand_p[1:] + integrand_p[:-1]) * np.diff(rf)
        Pout = np.concatenate([[0.0], np.cumsum(dp)])   # \int_{r_lo}^r rho s ds
        Phif = -Mf / rf - (Pout[-1] - Pout)

        r = np.geomspace(rmin, rmax, numr)
        rho = np.interp(r, rf, rhof)
        M = np.interp(r, rf, Mf)
        Phi = np.interp(r, rf, Phif)
        return cls(r, rho, M, Phi, comment=comment)


def hernquist_model(a: float = 1.0, M: float = 1.0, rmin: float = 1e-4,
                    rmax: float = 100.0, numr: int = 2000
                    ) -> SphericalModelTable:
    """Hernquist (1990) profile: rho = M a / (2 pi r (r+a)^3)."""
    r = np.geomspace(rmin, rmax, numr)
    rho = M * a / (2.0 * np.pi * r * (r + a) ** 3)
    mass = M * r**2 / (r + a) ** 2
    pot = -M / (r + a)
    return SphericalModelTable(r, rho, mass, pot,
                               comment=f"! Hernquist a={a} M={M}")


def add_disk_to_model(halo: SphericalModelTable, Mdisk: float,
                      acyl: float) -> SphericalModelTable:
    """Composite halo+disk model for IC generation (utils/ICs/AddDisk.cc,
    the DiskHalo path): the exponential disk's spherically averaged
    enclosed mass M_d(r) = Mdisk (1 - (1 + r/a) e^{-r/a}) added to the
    halo's mass and potential, the halo density kept as the tracer
    profile.  Eddington inversion of the result gives the halo DF in the
    total potential."""
    r = halo.r
    Md = Mdisk * (1.0 - (1.0 + r / acyl) * np.exp(-r / acyl))
    # spherical-shell potential of the disk mass profile:
    # Phi_d = -Md(r)/r - int_r^inf (dMd/ds)/s ds
    dMd = np.gradient(Md, r)
    integ = dMd / r
    tail = np.concatenate([
        np.cumsum((0.5 * (integ[1:] + integ[:-1]) * np.diff(r))[::-1])[::-1],
        [0.0]])
    pot_d = -Md / r - tail
    return SphericalModelTable(r, halo.rho, halo.mass + Md,
                               halo.pot + pot_d,
                               comment=(halo.comment
                                        + f" + disk M={Mdisk} a={acyl}"))
