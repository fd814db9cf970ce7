"""Spherical orbit machinery (the reference's SphericalOrbit,
exputil/orbit.cc, orbit_trans.cc): peri/apo, radial and azimuthal
frequencies, actions, the angle-variable grid and the resonance potential
transform pot_trans for orbits in a spherical model — used by resonance
analysis and the biorth_wake tools.  find_orb inverts (peri, apo) ->
(E, kappa) (exputil/FindOrb.cc, with scipy minimization replacing the
simulated-annealing driver).

A host-side NumPy copy of exp_tpu/analysis/orbit.py (the port imports
nothing of exp_tpu).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import brentq


class SphericalOrbit:
    """Orbit (E, J) in a SphericalModelTable potential (G = 1)."""

    def __init__(self, model, E: float, kappa: float = None, J: float = None,
                 nquad: int = 64):
        """kappa = J / J_circ(E) in (0, 1]; or give J directly."""
        self.model = model
        self.E = float(E)
        self._nquad = nquad
        if J is None:
            if kappa is None:
                raise ValueError("need kappa or J")
            J = float(kappa) * self.jcirc(E)
        self.J = float(J)
        self._turning_points()
        self._frequencies()

    # -- circular-orbit helpers ------------------------------------------

    def rcirc(self, E: float) -> float:
        """Radius of the circular orbit with energy E:
        E = Phi(r) + r Phi'(r)/2."""
        m = self.model

        def f(r):
            return m.get_pot(r) + 0.5 * r * m.get_dpot(r) - E

        return brentq(f, m.rmin * 1.0001, m.rmax * 0.9999, xtol=1e-12)

    def jcirc(self, E: float) -> float:
        rc = self.rcirc(E)
        return rc * np.sqrt(rc * float(self.model.get_dpot(rc)))

    # -- turning points ----------------------------------------------------

    def _veff2(self, r):
        return 2.0 * (self.E - self.model.get_pot(r)) - (self.J / r) ** 2

    def _turning_points(self):
        m = self.model
        rc = self.rcirc(self.E)

        def f(r):
            return self._veff2(r)

        lo = m.rmin * 1.0001
        hi = m.rmax * 0.9999
        # circular limit (kappa -> 1): veff2(rc) is a roundoff residual of
        # either sign; brentq would fail (or give peri == apo and 1/0
        # frequencies) — handle it explicitly via the epicyclic limit
        if f(rc) <= 1e-10 * (self.J / rc) ** 2:
            self.peri = self.apo = rc
            return
        self.peri = brentq(f, lo, rc) if f(lo) < 0 else lo
        self.apo = brentq(f, rc, hi) if f(hi) < 0 else hi

    # -- frequencies / actions ---------------------------------------------

    def _frequencies(self):
        """Radial period and apsidal angle by Gauss–Chebyshev quadrature
        with the sqrt turning-point singularities absorbed."""
        m = self.model
        if self.apo - self.peri <= 1e-8 * max(self.peri, 1e-30):
            # epicyclic (near-circular) limit: omega_r = kappa from the
            # potential curvature, omega_phi from the circular speed
            r0 = 0.5 * (self.apo + self.peri)
            dp = float(m.get_dpot(r0))
            h = 1e-4 * r0
            d2p = (float(m.get_dpot(r0 + h))
                   - float(m.get_dpot(r0 - h))) / (2.0 * h)
            kap = np.sqrt(max(d2p + 3.0 * dp / r0, 1e-30))
            self.omega_r = kap
            self.Tr = 2.0 * np.pi / kap
            self.omega_phi = self.J / r0 ** 2
            self.dphi = np.pi * self.omega_phi / kap
            self.Jr = 0.0
            return
        n = self._nquad
        # r = (apo+peri)/2 + (apo-peri)/2 * sin(theta): removes both roots
        th, w = np.polynomial.chebyshev.chebgauss(n)
        a = 0.5 * (self.apo - self.peri)
        b = 0.5 * (self.apo + self.peri)
        r = b + a * th                         # th in (-1, 1)
        v2 = np.maximum(self._veff2(r), 1e-30)
        vr = np.sqrt(v2)
        # dr = a dth;  chebgauss weight includes 1/sqrt(1-th^2):
        # Tr = 2 int dr/vr = 2 a int dth/vr = 2 a sum w sqrt(1-th^2)/vr
        s = np.sqrt(1.0 - th * th)
        self.Tr = 2.0 * a * np.sum(w * s / vr)
        # apsidal angle: dphi = J dr / (r^2 vr)
        self.dphi = self.J * a * np.sum(w * s / (r * r * vr))
        self.omega_r = 2.0 * np.pi / self.Tr
        self.omega_phi = 2.0 * self.dphi / self.Tr
        # radial action: Jr = (1/pi) int vr dr
        self.Jr = a * np.sum(w * s * vr) / np.pi

    def actions(self):
        """(J_r, J_phi=J)."""
        return self.Jr, self.J

    def frequencies(self):
        """(Omega_r, Omega_phi)."""
        return self.omega_r, self.omega_phi

    def resonance(self, l1: int, l2: int) -> float:
        """Resonance combination l1*Omega_r + l2*Omega_phi."""
        return l1 * self.omega_r + l2 * self.omega_phi

    # -- angle variables (compute_angles, orbit_trans.cc:362-520) ----------

    def _radial_speed_reg(self, t):
        """sqrt radicand on the sin-substituted radius r = b + a sin(t),
        with the finite turning-point limits substituted near t = -/+ pi/2
        (the fw1 endpoint regularization, orbit_trans.cc:395-427).

        Returns (r, integrand am*cos(t)/vr)."""
        a = 0.5 * (self.apo - self.peri)
        b = 0.5 * (self.apo + self.peri)
        r = b + a * np.sin(t)
        v2 = self._veff2(r)
        m = self.model
        # limits: integrand -> sqrt(a / |J^2/rt^3 - Phi'(rt)|) at turning rt
        lim_p = np.sqrt(a / max(abs(self.J ** 2 / self.peri ** 3
                                    - float(m.get_dpot(self.peri))), 1e-30))
        lim_a = np.sqrt(a / max(abs(float(m.get_dpot(self.apo))
                                    - self.J ** 2 / self.apo ** 3), 1e-30))
        near = (v2 < 1e-8) | (np.abs(np.abs(t) - 0.5 * np.pi) < 1e-3)
        core = a * np.cos(t) / np.sqrt(np.maximum(v2, 1e-30))
        return r, np.where(near, np.where(t < 0, lim_p, lim_a), core)

    def _angmom_integrand_reg(self, s):
        """Same regularization for the 1/r = sp + sm sin(s) substitution
        (the ff integrand, orbit_trans.cc:432-466)."""
        sp = 0.5 * (1.0 / self.peri + 1.0 / self.apo)
        sm = 0.5 * (1.0 / self.peri - 1.0 / self.apo)
        u = sp + sm * np.sin(s)
        r = 1.0 / u
        v2 = 2.0 * (self.E - np.asarray(self.model.get_pot(r))) \
            - (self.J * u) ** 2
        m = self.model
        lim_a = np.sqrt(sm / max(abs(float(m.get_dpot(self.apo))
                                     - self.J ** 2 / self.apo ** 3),
                                 1e-30)) / self.apo
        lim_p = np.sqrt(sm / max(abs(self.J ** 2 / self.peri ** 3
                                     - float(m.get_dpot(self.peri))),
                                 1e-30)) / self.peri
        near = (v2 < 1e-8) | (np.abs(np.abs(s) - 0.5 * np.pi) < 1e-3)
        core = sm * np.cos(s) / np.sqrt(np.maximum(v2, 1e-30))
        return np.where(near, np.where(s < 0, lim_a, lim_p), core)

    def compute_angles(self, recs: int = 128, nsub: int = 8):
        """Tabulate the angle grid over the peri->apo branch: for each
        node t_i in [-pi/2, pi/2],

          w1    = Omega_r * int_{-pi/2}^{t} dt'/vr-form   (radial angle)
          dw1dt = Omega_r * fw1(t)
          f     = Omega_phi * (t-integral) + J * (s-integral)
                  (azimuthal angle offset w2 - phi)
          r     = b + a sin(t)

        (compute_angles, orbit_trans.cc:362-520; per-interval composite
        Gauss-Legendre with `nsub` points replaces the Romberg rombe2)."""
        a = 0.5 * (self.apo - self.peri)
        b = 0.5 * (self.apo + self.peri)
        t = np.linspace(-0.5 * np.pi, 0.5 * np.pi, recs)
        r = b + a * np.sin(t)
        sp = 0.5 * (1.0 / self.peri + 1.0 / self.apo)
        sm = 0.5 * (1.0 / self.peri - 1.0 / self.apo)
        arg = np.clip((1.0 / r - sp) / sm, -1.0, 1.0)
        s = np.arcsin(arg)

        xg, wg = np.polynomial.legendre.leggauss(nsub)
        acc1 = np.zeros(recs)
        acc2 = np.zeros(recs)
        for i in range(1, recs):
            mid, half = 0.5 * (t[i] + t[i - 1]), 0.5 * (t[i] - t[i - 1])
            _, f1 = self._radial_speed_reg(mid + half * xg)
            acc1[i] = acc1[i - 1] + half * np.dot(wg, f1)
            mid, half = 0.5 * (s[i] + s[i - 1]), 0.5 * (s[i] - s[i - 1])
            f2 = self._angmom_integrand_reg(mid + half * xg)
            acc2[i] = acc2[i - 1] + half * np.dot(wg, f2)

        _, fw1 = self._radial_speed_reg(t)
        self.angle_grid = {
            "t": t,
            "w1": self.omega_r * acc1,
            "dw1dt": self.omega_r * fw1,
            "f": self.omega_phi * acc1 + self.J * acc2,
            "r": r,
        }
        return self.angle_grid

    def _grid(self):
        if not hasattr(self, "angle_grid"):
            self.compute_angles()
        return self.angle_grid

    def get_angle(self, name: str, time: float):
        """Angle-variable quantities at w1 = Omega_r * time: one of
        'w1', 'w2', 't', 'dw1dt', 'f', 'r', 'phi' (get_angle,
        orbit.cc:179-270; branch reflection for w1 in (pi, 2 pi))."""
        g = self._grid()
        w1 = self.omega_r * time
        w2 = self.omega_phi * time
        if name == "w1":
            return w1
        if name == "w2":
            return w2
        w1m = np.mod(w1, 2.0 * np.pi)
        branch = w1m > np.pi
        w1f = np.where(branch, 2.0 * np.pi - w1m, w1m)
        val = {
            "t": np.interp(w1f, g["w1"], g["t"]),
            "dw1dt": np.interp(w1f, g["w1"], g["dw1dt"]),
            "f": np.interp(w1f, g["w1"], g["f"]),
            "r": np.interp(w1f, g["w1"], g["r"]),
            "phi": np.interp(w1f, g["w1"], g["f"]),
        }[name]
        if name == "t":
            return np.where(branch, np.pi - val, val)
        if name in ("f",):
            return np.where(branch, -val, val)
        if name == "phi":
            return w2 - np.where(branch, -val, val)
        return val

    def get_w1(self, r: float, vr: float) -> float:
        """Radial angle in [0, 2 pi] for radius r on the branch selected by
        sign(vr) (get_w1, orbit.cc:277-299)."""
        g = self._grid()
        if r < self.peri or r > self.apo:
            return float("inf")
        ang = float(np.interp(r, g["r"], g["w1"]))
        return 2.0 * np.pi - ang if vr < 0.0 else ang

    # -- resonance potential transform (pot_trans, orbit_trans.cc:761) -----

    def pot_trans(self, l1: int, l2: int, func, eps_circ: float = 1e-3):
        """W_{l1 l2}[V] = (1/pi) int_0^pi cos(l1 w1 + l2 f) V(r(w1)) dw1 —
        the angle transform of a potential function along the orbit (the
        coupling coefficient in linear response theory).

        `func`: scalar callable V(r), or a vectorized callable returning
        shape (..., K) for K basis channels at once (the Eigen::VectorXd
        overload).  Near-circular orbits (kappa -> 1) collapse to
        V(r_circ) for l1 == 0, else 0 (orbit_trans.cc:777-790)."""
        kappa = self.J / self.jcirc(self.E)
        if kappa > 1.0 - eps_circ:
            rc = self.rcirc(self.E)
            v = np.asarray(func(rc), float)
            return v if l1 == 0 else np.zeros_like(v)
        g = self._grid()
        xg, wg = np.polynomial.legendre.leggauss(max(64, len(g["t"]) // 2))
        t = 0.5 * np.pi * xg                                # [-pi/2, pi/2]
        w1 = np.interp(t, g["t"], g["w1"])
        f = np.interp(t, g["t"], g["f"])
        dw1dt = np.interp(t, g["t"], g["dw1dt"])
        r = np.interp(t, g["t"], g["r"])
        cosv = np.cos(l1 * w1 + l2 * f)
        vals = np.asarray(func(r), float)
        wts = 0.5 * np.pi * wg * dw1dt * cosv
        if vals.ndim == 1:
            return float(np.dot(wts, vals) / np.pi)
        return np.tensordot(wts, vals, axes=(0, 0)) / np.pi


def find_orb(model, peri: float, apo: float, kmin: float = 0.005,
             kmax: float = 0.995):
    """Invert (peri, apo) -> SphericalOrbit by least squares on (E, kappa)
    (FindOrb::Anneal, exputil/FindOrb.cc:67-115; scipy replaces SimAnn).

    Returns dict with energy/kappa/peri/apo/radial_period/azimuthal_period.
    """
    from scipy.optimize import minimize

    Emin = float(model.get_pot(model.rmin))
    Emax = float(model.get_pot(model.rmax))

    def mapvars(x):
        ee = Emin + (Emax - Emin) * (np.arctan(x[0]) / np.pi + 0.5)
        kk = kmin + (kmax - kmin) * (np.arctan(x[1]) / np.pi + 0.5)
        return ee, kk

    def cost(x):
        ee, kk = mapvars(x)
        try:
            orb = SphericalOrbit(model, ee, kappa=kk)
        except Exception:
            return 1e30
        return (orb.apo - apo) ** 2 + (orb.peri - peri) ** 2

    best = None
    for x0 in ([0.0, 0.0], [1.0, -1.0], [-1.0, 1.0]):
        res = minimize(cost, x0, method="Nelder-Mead",
                       options={"xatol": 1e-12, "fatol": 1e-24,
                                "maxiter": 2000})
        if best is None or res.fun < best.fun:
            best = res
    ee, kk = mapvars(best.x)
    orb = SphericalOrbit(model, ee, kappa=kk)
    return {
        "energy": ee, "kappa": kk, "value": best.fun,
        "peri": orb.peri, "apo": orb.apo,
        "radial_period": 2.0 * np.pi / orb.omega_r,
        "azimuthal_period": 2.0 * np.pi / orb.omega_phi,
        "orbit": orb,
    }
