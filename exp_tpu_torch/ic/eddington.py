"""Eddington inversion + phase-space sampling (host, NumPy; a copy of
exp_tpu/ic/eddington.py).

Generates an equilibrium isotropic (or Osipkov-Merritt) N-body realization
of a spherical model: the reference's distribution function + gen_point
(exputil/massmodel_dist.cc, exputil/realize_model.cc).  With relative
potential psi(r) = -Phi(r) >= 0 shifted so psi(rmax) = 0, and relative
energy eps = psi - v^2/2, the isotropic DF is

    f(eps) = 1/(sqrt(8) pi^2) [ int_0^eps d2rho/dpsi2 dpsi / sqrt(eps - psi)
                                + (drho/dpsi)|_{psi=0} / sqrt(eps) ]

Sampling: r from the inverse mass CDF, speed by rejection from
p(v) ~ v^2 f(psi(r) - v^2/2), isotropic angles.  The same seed gives the
same sample as the JAX package's copy.
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass
from scipy.interpolate import CubicSpline

from exp_tpu_torch.basis.model import SphericalModelTable


@dataclass
class EddingtonDF:
    """Isotropic (ra=None) or Osipkov–Merritt anisotropic DF.

    OM (the reference's anisotropic gen_point variants, massmodel.H:112-240):
    f = f(Q), Q = eps - L^2/(2 ra^2); the inversion is the Eddington formula
    applied to the augmented density rho_Q = rho (1 + r^2/ra^2)."""

    model: SphericalModelTable
    num_e: int = 400
    num_t: int = 200
    ra: float | None = None

    def __post_init__(self):
        m = self.model
        r = m.r
        phi_max = m.pot[-1]                  # potential at rmax (least bound)
        psi = phi_max - m.pot                # relative potential, >= 0, decreasing in r
        # ensure strictly decreasing psi for the parametric inversion
        self._psi_of_r = CubicSpline(np.log(r), psi)
        rho_eff = m.rho if self.ra is None else \
            m.rho * (1.0 + (r / self.ra) ** 2)
        # rho as a function of psi (psi decreasing with r -> reverse arrays)
        order = np.argsort(psi)
        psi_s, rho_s = psi[order], rho_eff[order]
        # dedupe any equal psi values at the outer edge
        keep = np.concatenate([[True], np.diff(psi_s) > 0])
        self._rho_of_psi = CubicSpline(psi_s[keep], rho_s[keep])
        self._psi_max = float(psi[0])

        # Tabulate f(eps) on a grid concentrated toward eps -> 0 and psi_max
        eps = np.linspace(0.0, self._psi_max, self.num_e + 1)[1:]
        drho = self._rho_of_psi.derivative(1)
        d2rho = self._rho_of_psi.derivative(2)
        # Gauss-Legendre nodes on t in [0, sqrt(eps)]
        tq, wq = np.polynomial.legendre.leggauss(self.num_t)
        f = np.empty_like(eps)
        for i, e in enumerate(eps):
            tmax = np.sqrt(e)
            t = 0.5 * tmax * (tq + 1.0)
            w = 0.5 * tmax * wq
            # int_0^eps d2rho/dpsi^2 /sqrt(eps-psi) dpsi = 2 int_0^sqrt(eps) d2rho(e-t^2) dt
            val = 2.0 * np.sum(w * d2rho(e - t * t))
            val += drho(0.0) / np.sqrt(e)
            f[i] = val / (np.sqrt(8.0) * np.pi**2)
        # guard: clip small negative wiggles from spline noise
        self._f_eps = np.maximum(f, 0.0)
        self._eps = eps
        self._f_sp = CubicSpline(eps, self._f_eps)

    def f(self, eps):
        eps = np.asarray(eps)
        e0 = self._eps[0]
        out = self._f_sp(np.clip(eps, e0, None))
        # below the first grid point fall linearly to f(0) = 0 (holding
        # f(e0) over-populated near-escape speeds at large radii)
        out = np.where(eps >= e0, out, self._f_eps[0] * (eps / e0))
        return np.maximum(np.where(eps > 0, out, 0.0), 0.0)

    def psi(self, r):
        """Relative potential psi(r) (>=0, psi(rmax)=0)."""
        m = self.model
        r = np.clip(np.asarray(r, dtype=np.float64), m.r[0], m.r[-1])
        return np.maximum(self._psi_of_r(np.log(r)), 0.0)


def sample_spherical_model(model: SphericalModelTable, n: int,
                           seed: int = 0, zero_com: bool = True,
                           ra: float | None = None,
                           tracer_only: bool = False):
    """Draw an equilibrium realization: returns (x, v, mass) arrays.

    Equal-mass particles totaling model.total_mass (the gensph convention).
    ra: Osipkov–Merritt anisotropy radius (isotropic if None).
    tracer_only: sample positions/masses from the model's DENSITY profile
    instead of its mass column — for composite models (add_disk_to_model)
    whose mass/potential include another component's contribution while
    rho is the tracer being realized.
    """
    rng = np.random.default_rng(seed)
    df = EddingtonDF(model, ra=ra)
    m = model

    if tracer_only:
        integ = 4.0 * np.pi * m.rho * m.r ** 2
        dm = 0.5 * (integ[1:] + integ[:-1]) * np.diff(m.r)
        Mcum = np.concatenate([[0.0], np.cumsum(dm)])
        mtot = Mcum[-1]
        Mr = Mcum / mtot
    else:
        mtot = m.total_mass
        Mr = m.mass / m.total_mass
    # make strictly increasing for interp
    keep = np.concatenate([[True], np.diff(Mr) > 0])
    inv_r = CubicSpline(Mr[keep], np.log(m.r[keep]))
    u = rng.uniform(Mr[keep][0], Mr[keep][-1], size=n)
    r = np.exp(inv_r(u))

    psi_r = df.psi(r)
    vmax = np.sqrt(2.0 * psi_r)

    def isotropic(k):
        ct = rng.uniform(-1.0, 1.0, k)
        st = np.sqrt(1.0 - ct**2)
        ph = rng.uniform(0.0, 2.0 * np.pi, k)
        return np.stack([st * np.cos(ph), st * np.sin(ph), ct], axis=-1)

    if ra is None:
        # rejection sample speed: p(v) ~ v^2 f(psi - v^2/2)
        v = np.empty(n)
        # envelope from a dense speed grid: a coarse grid undershoots
        # the true max of v^2 f (measured 1.24x at small radii on the
        # default Hernquist model), silently biasing the sampled DF.
        # Computed ONCE per particle, in chunks (the (n, 256) f64
        # broadcast was ~50 GB at 10M particles)
        env = np.empty(n)
        chunk = 262_144
        vg01 = np.linspace(0.0, 1.0, 256)[None, :]
        for i in range(0, n, chunk):
            vm_c = vmax[i:i + chunk]
            vg = vg01 * vm_c[:, None]
            pg = vg**2 * df.f(psi_r[i:i + chunk, None] - 0.5 * vg**2)
            env[i:i + chunk] = 1.3 * pg.max(axis=1) + 1e-300
        todo = np.arange(n)
        while todo.size:
            pr = psi_r[todo]
            vm = vmax[todo]
            vt = rng.uniform(0.0, 1.0, todo.size) * vm
            y = rng.uniform(0.0, 1.0, todo.size) * env[todo]
            p = vt**2 * df.f(pr - 0.5 * vt**2)
            ok = y <= p
            v[todo[ok]] = vt[ok]
            todo = todo[~ok]
        x = r[:, None] * isotropic(n)
        vv = v[:, None] * isotropic(n)
    else:
        # OM: p(vr, vt) ~ vt f(psi - (vr^2+vt^2)/2 - r^2 vt^2/(2 ra^2))
        vr = np.empty(n)
        vt_ = np.empty(n)
        todo = np.arange(n)
        while todo.size:
            pr = psi_r[todo]
            vm = vmax[todo]
            rr = r[todo]
            fac = 1.0 + (rr / ra) ** 2
            # coarse envelope over the (vr, vt) quarter disk
            g = np.linspace(0, 1, 48)
            VG, TG = np.meshgrid(g, g, indexing="ij")
            q = (pr[:, None, None]
                 - 0.5 * (VG[None] ** 2 + TG[None] ** 2 * fac[:, None, None])
                 * vm[:, None, None] ** 2)
            pg = TG[None] * vm[:, None, None] * df.f(q)
            env = 1.4 * pg.reshape(len(rr), -1).max(axis=1) + 1e-300
            a1 = rng.uniform(-1, 1, todo.size) * vm
            a2 = rng.uniform(0, 1, todo.size) * vm
            Q = pr - 0.5 * (a1 ** 2 + a2 ** 2 * fac)
            p = a2 * df.f(Q)
            y = rng.uniform(0, 1, todo.size) * env
            ok = (y <= p) & (Q > 0)
            vr[todo[ok]] = a1[ok]
            vt_[todo[ok]] = a2[ok]
            todo = todo[~ok]
        x = r[:, None] * isotropic(n)
        rhat = x / np.linalg.norm(x, axis=1, keepdims=True)
        # random tangential direction
        tmp = isotropic(n)
        that = tmp - (tmp * rhat).sum(1, keepdims=True) * rhat
        that /= np.maximum(np.linalg.norm(that, axis=1, keepdims=True),
                           1e-12)
        vv = vr[:, None] * rhat + vt_[:, None] * that
    mass = np.full(n, mtot / n)

    if zero_com:
        x -= np.average(x, axis=0, weights=mass)
        vv -= np.average(vv, axis=0, weights=mass)

    return x, vv, mass
