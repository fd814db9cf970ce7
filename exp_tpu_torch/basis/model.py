"""Spherical mass models (host-side NumPy/SciPy; a jax-free copy of
exp_tpu/basis/model.py: `SphericalModelTable`, the model built from a
particle snapshot, the analytic Hernquist, Plummer, King and truncated
power-law models, and the halo + disk and halo + sphere composites).

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


def model_from_particles(x, mass, numr: int = 800, rmin: float = None,
                         rmax: float = None,
                         smooth: int = 3) -> SphericalModelTable:
    """Spherical model from a particle snapshot by radial binning — the
    adaptive-basis path (reference Sphere::make_model_bin, Sphere.cc:203-354):
    log-spaced shells, boxcar-smoothed density, exact cumulative mass, and
    the potential from the two-integral quadrature in from_density.
    """
    x = np.asarray(x, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    live = mass > 0
    r = np.linalg.norm(x[live], axis=1)
    mass = mass[live]
    if rmin is None:
        rmin = max(np.percentile(r, 0.01), 1e-6)
    if rmax is None:
        rmax = np.percentile(r, 99.9)
    edges = np.geomspace(rmin, rmax, numr + 1)
    # drop out-of-range particles: clipping them into the edge bins
    # inflates exactly the cusp/truncation densities
    inb = (r >= rmin) & (r < rmax)
    idx = np.digitize(r[inb], edges) - 1
    msh = np.bincount(np.clip(idx, 0, numr - 1), weights=mass[inb],
                      minlength=numr)
    vol = 4.0 * np.pi / 3.0 * np.diff(edges ** 3)
    rho = msh / vol
    if smooth > 1:                       # boxcar in log space
        # edge-padded so the boundary bins average only REAL samples —
        # mode="same" zero padding would bias the cusp/truncation bins
        # toward log(rho)=0
        k = np.ones(smooth) / smooth
        lg = np.log(np.maximum(rho, rho[rho > 0].min() * 1e-3))
        half = smooth // 2
        lg_pad = np.pad(lg, half, mode="edge")
        rho = np.exp(np.convolve(lg_pad, k, mode="same")[half:half + numr])
    rc = np.sqrt(edges[:-1] * edges[1:])
    good = rho > 0
    rho_i = np.interp(np.log(rc), np.log(rc[good]), np.log(rho[good]))
    rho_fn = lambda rr: np.exp(np.interp(np.log(np.maximum(rr, rc[0])),
                                         np.log(rc), rho_i))
    m = SphericalModelTable.from_density(rho_fn, rmin, rmax, numr,
                                         comment="! binned from particles")
    # normalize to the actual bound mass inside rmax
    s = mass[r <= rmax].sum() / m.total_mass
    return SphericalModelTable(m.r, m.rho * s, m.mass * s, m.pot * s,
                               comment=m.comment)


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


def plummer_model(a: float = 1.0, M: float = 1.0, rmin: float = 1e-4,
                  rmax: float = 100.0, numr: int = 2000) -> SphericalModelTable:
    r = np.geomspace(rmin, rmax, numr)
    rho = 3.0 * M / (4.0 * np.pi * a**3) * (1.0 + (r / a) ** 2) ** -2.5
    mass = M * r**3 / (r**2 + a**2) ** 1.5
    pot = -M / np.sqrt(r**2 + a**2)
    return SphericalModelTable(r, rho, mass, pot,
                               comment=f"! Plummer a={a} M={M}")


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


def add_sphere_to_model(halo: SphericalModelTable,
                        other: SphericalModelTable,
                        mass_scale: float = 1.0,
                        include_density: bool = False
                        ) -> SphericalModelTable:
    """Composite of two spherical models (utils/ICs/AddSpheres.cc: halo +
    bulge): add the scaled second model's enclosed mass and potential to
    the halo's table so the halo DF (Eddington inversion of the result)
    responds to the embedded sphere.

    include_density=False keeps the halo density as the tracer profile
    (sample the halo in the TOTAL potential — the gensph `--addsphere`
    path); True also adds the scaled density (a full composite model)."""
    r = halo.r
    Mtot_o = float(other.mass[-1]) * mass_scale
    Mo = mass_scale * np.interp(r, other.r, other.mass,
                                left=0.0, right=float(other.mass[-1]))
    pot_o = mass_scale * np.where(
        r <= other.r[-1],
        np.interp(r, other.r, other.pot),
        -float(other.mass[-1]) / np.maximum(r, 1e-30))
    rho = halo.rho.copy()
    if include_density:
        rho = rho + mass_scale * np.interp(r, other.r, other.rho,
                                           left=float(other.rho[0]),
                                           right=0.0)
    return SphericalModelTable(r, rho, halo.mass + Mo, halo.pot + pot_o,
                               comment=(halo.comment
                                        + f" + sphere M={Mtot_o:.4g}"))


def king_model(W0: float = 5.0, M: float = 1.0, rt: float = 1.0,
               numr: int = 2000) -> SphericalModelTable:
    """King (1966) lowered-isothermal model (reference include/king.H).

    Solves the dimensionless King equation for concentration parameter
    W0 = psi(0)/sigma^2, then rescales to total mass M and tidal radius
    rt (G = 1).  rho(W) = e^W erf(sqrt(W)) - sqrt(4W/pi)(1 + 2W/3).
    """
    from scipy.special import erf
    from scipy.integrate import solve_ivp

    def rho_w(W):
        W = np.maximum(W, 0.0)
        return (np.exp(W) * erf(np.sqrt(W))
                - np.sqrt(4.0 * W / np.pi) * (1.0 + 2.0 * W / 3.0))

    rho0 = rho_w(W0)

    # y = [W, dW/dr]; d/dr(r^2 W') = -9 r^2 rho(W)/rho0 (king units:
    # r in core radii r_c, sigma = 1)
    def rhs(r, y):
        W, dW = y
        if r < 1e-12:
            return [dW, -3.0 * rho_w(W) / rho0]
        return [dW, -9.0 * rho_w(W) / rho0 - 2.0 * dW / r]

    def hit_edge(r, y):
        return y[0]
    hit_edge.terminal = True
    hit_edge.direction = -1

    sol = solve_ivp(rhs, [1e-8, 1e4], [W0, 0.0], events=hit_edge,
                    max_step=0.05, rtol=1e-10, atol=1e-12)
    rt_king = sol.t_events[0][0]          # tidal radius in king units
    r_k = np.geomspace(rt_king * 1e-4, rt_king * 0.999999, numr)
    W = np.interp(r_k, sol.t, sol.y[0])
    rho_k = rho_w(W) / rho0
    integ = 4.0 * np.pi * rho_k * r_k ** 2
    dm = 0.5 * (integ[1:] + integ[:-1]) * np.diff(r_k)
    Mk = np.concatenate([[0.0], np.cumsum(dm)])
    # rescale: r -> r * rt/rt_king, total mass -> M.  Mk was integrated
    # from this same rho_k, so rho_phys = rho_k * s_m / s_r^3 keeps
    # M(r) = 4 pi int rho r^2 dr exact under the rescaling.
    s_r = rt / rt_king
    s_m = M / Mk[-1]
    r = r_k * s_r
    mass = Mk * s_m
    rho = rho_k * s_m / s_r ** 3
    # potential: Phi = -M(r)/r - 4 pi int_r^rt rho s ds  (G = 1)
    integ_p = 4.0 * np.pi * rho * r
    dp = 0.5 * (integ_p[1:] + integ_p[:-1]) * np.diff(r)
    Pout = np.concatenate([[0.0], np.cumsum(dp)])
    pot = -mass / r - (Pout[-1] - Pout)
    return SphericalModelTable(r, rho, mass, pot,
                               comment=f"! King W0={W0} M={M} rt={rt}")


def truncated_powerlaw_model(alpha: float = 1.0, beta: float = 3.0,
                             rcore: float = 0.015, rtrunc: float = 15.0,
                             wtrunc: float = 4.0, rmin: float = 3e-5,
                             rmax: float = 30.0, numr: int = 2000,
                             M: float = 1.0) -> SphericalModelTable:
    """Cored alpha/beta double-power-law with error-function truncation.

    The profile family of the reference CI halo model (header of
    tests/Halo/SLGridSph.model: alpha=1 beta=3 rcore rtrunc wtrunc):
      rho ~ (r + rcore)^-alpha * (r + rs)^-(beta-alpha) * erfc-taper(rtrunc)
    normalized to total mass M.
    """
    from scipy.special import erfc

    def rho_raw(r):
        core = (r + rcore) ** -alpha
        outer = (1.0 + r) ** (alpha - beta)
        taper = 0.5 * erfc((np.log(r / rtrunc)) * wtrunc)
        return core * outer * taper

    m = SphericalModelTable.from_density(rho_raw, rmin, rmax, numr)
    s = M / m.total_mass
    return SphericalModelTable(m.r, m.rho * s, m.mass * s, m.pot * s,
                               comment=(f"! alpha={alpha} beta={beta} "
                                        f"rcore={rcore} rtrunc={rtrunc}"))
