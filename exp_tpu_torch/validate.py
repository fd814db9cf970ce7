"""Reference-equations comparator (f64, NumPy; a host copy of
exp_tpu/validate.py, the same equations and operations).

An independent plain-NumPy f64 implementation of the reference's
spherical-basis step equations (src/SphericalBasis.cc:429-599 coefficient
loop, :1476-1700 force loop; Condon–Shortley P_lm via the legendre_R
recurrence, table evaluation = linear interpolation in the mapped
coordinate, KDK leapfrog per src/step.cc:272-322), written without
PyTorch, so any disagreement with the port's SphereSL step isolates a
transcription defect or a kernel's error.  It stands in for a CPU build of
reference EXP, which needs MPI, Eigen3, FFTW and the HDF5 / yaml-cpp
development headers at compile time.

`ReferenceSphereStep` reads the port's host tables (basis/slgrid.py
`SphSLTables`).  Used by tests/test_torch_validate.py (the port's f64
gather step against it: 1e-12 on a step's coefficients, < 1e-6 relative
coefficient drift at 25 steps and < 1e-9 over 300) and by chip_smoke.py's
phase VR1 on the card.
"""

from __future__ import annotations

import math

import numpy as np


def legendre_lm_np(lmax, x):
    """Unnormalized Condon–Shortley P_lm(x), shape (N, lmax+1, lmax+1)
    (the reference's legendre_R recurrence, exputil)."""
    n = x.shape[0]
    p = np.zeros((n, lmax + 1, lmax + 1))
    p[:, 0, 0] = 1.0
    somx2 = np.sqrt(np.maximum((1 - x) * (1 + x), 0.0))
    pll = np.ones(n)
    fact = 1.0
    for m in range(1, lmax + 1):
        pll = pll * (-fact) * somx2
        p[:, m, m] = pll
        fact += 2.0
    for m in range(lmax):
        pl2 = p[:, m, m]
        pl1 = x * (2 * m + 1) * pl2
        p[:, m + 1, m] = pl1
        for l in range(m + 2, lmax + 1):
            pl = (x * (2 * l - 1) * pl1 - (l + m - 1) * pl2) / (l - m)
            p[:, l, m] = pl
            pl2, pl1 = pl1, pl
    return p


def dlegendre_lm_np(lmax, x):
    """P_lm and dP_lm/dx, x = cos(theta) (the reference's dlegendre_R,
    src/Basis.cc:81-115: (x^2-1) dP/dx = l x P_lm - (l+m) P_{l-1,m})."""
    eps = 1e-12
    xc = np.clip(x, -1 + eps, 1 - eps)
    P = legendre_lm_np(lmax, xc)
    dP = np.zeros_like(P)
    inv = 1.0 / (xc * xc - 1.0)
    for l in range(1, lmax + 1):
        for m in range(l + 1):
            if l == m:
                dfac = l * xc * P[:, l, m]
            else:
                dfac = l * xc * P[:, l, m] - (l + m) * P[:, l - 1, m]
            dP[:, l, m] = inv * dfac
    return P, dP


def real_ylm_norm_np(lmax):
    fac = np.zeros((lmax + 1, lmax + 1))
    for l in range(lmax + 1):
        for m in range(l + 1):
            v = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            fac[l, m] = v * (math.sqrt(2) if m else 1.0)
    return fac


class ReferenceSphereStep:
    """f64 comparator for the SphereSL KDK step, from SphSLTables."""

    def __init__(self, tables, scale=1.0):
        self.pot = np.asarray(tables.pot_table, np.float64)   # (numr, L+1, n)
        self.xmin = float(tables.xmin)
        self.dxi = float(tables.dxi)
        self.numr = int(tables.numr)
        self.lmax = int(tables.lmax)
        self.nmax = int(tables.nmax)
        self.rmin = float(tables.rmin)
        self.rmax = float(tables.rmax)
        self.cmap = int(tables.cmap)
        self.rmap = float(tables.rmap)
        self.scale = float(scale)
        self.fac = real_ylm_norm_np(self.lmax)

    # mapped coordinate (ops/coords.py conventions: cmap 0 identity,
    # 1 algebraic, 2 log — transcribed independently in NumPy)
    def _xi(self, r):
        if self.cmap == 1:
            rr = r / self.rmap
            return (rr - 1.0) / (rr + 1.0)
        if self.cmap == 2:
            return np.log(r)
        return r

    def _dxi_dr(self, xi):
        if self.cmap == 1:
            return 0.5 * (1.0 - xi) ** 2 / self.rmap
        if self.cmap == 2:
            return np.exp(-xi)
        return np.ones_like(xi)

    def _table(self, rs, deriv=False):
        xi = self._xi(rs)
        t = np.clip((xi - self.xmin) / self.dxi, 0.0, self.numr - 1.0)
        idx = np.minimum(t.astype(np.int64), self.numr - 2)
        w = (t - idx)[:, None, None]
        potd = self.pot[idx] * (1 - w) + self.pot[idx + 1] * w
        if not deriv:
            return potd, None
        dpot = (self.pot[idx + 1] - self.pot[idx]) / self.dxi \
            * self._dxi_dr(xi)[:, None, None]
        return potd, dpot

    def coefficients(self, x, mass):
        """-4 pi sum_i m_i fac P_lm trig pot_ln (SphericalBasis.cc:429-599)."""
        r = np.sqrt((x * x).sum(-1)) + 1e-16
        costh = x[:, 2] / r
        phi = np.arctan2(x[:, 1], x[:, 0])
        rs = r / self.scale
        w = np.where((rs >= self.rmin) & (rs <= self.rmax), mass, 0.0)
        P = legendre_lm_np(self.lmax, costh)
        mg = np.arange(self.lmax + 1)
        cosm = np.cos(phi[:, None] * mg)
        sinm = np.sin(phi[:, None] * mg)
        potd, _ = self._table(np.clip(rs, self.rmin, self.rmax))
        wyc = self.fac[None] * P * cosm[:, None, :] * w[:, None, None]
        wys = self.fac[None] * P * sinm[:, None, :] * w[:, None, None]
        cc = np.einsum("ilm,iln->lmn", wyc, potd)
        cs = np.einsum("ilm,iln->lmn", wys, potd)
        return -4.0 * math.pi * np.stack([cc, cs])

    def acceleration(self, coef, x):
        """Force assembly (SphericalBasis.cc:1476-1700 + the vacuum
        multipole continuation beyond rmax)."""
        lmax = self.lmax
        r = np.sqrt((x * x).sum(-1)) + 1e-16
        costh = x[:, 2] / r
        phi = np.arctan2(x[:, 1], x[:, 0])
        outside = r > self.rmax * self.scale
        r_eval = np.minimum(r, self.rmax * self.scale)
        rs = r_eval / self.scale

        P, dP = dlegendre_lm_np(lmax, costh)
        mg = np.arange(lmax + 1)
        cosm = np.cos(phi[:, None] * mg)
        sinm = np.sin(phi[:, None] * mg)
        potd, dpot = self._table(rs, deriv=True)

        cc, ss = coef[0], coef[1]
        pc = np.einsum("lmn,iln->ilm", cc, potd)
        ps = np.einsum("lmn,iln->ilm", ss, potd)
        dpc = np.einsum("lmn,iln->ilm", cc, dpot)
        dps = np.einsum("lmn,iln->ilm", ss, dpot)

        lv = np.arange(lmax + 1, dtype=np.float64)
        att = np.power((self.rmax * self.scale / r)[:, None], lv + 1.0)
        att = np.where(outside[:, None], att, 1.0)
        pc = pc * att[:, :, None]
        ps = ps * att[:, :, None]
        dfac_out = -(lv + 1.0)[None, :, None] \
            / (r / self.scale)[:, None, None]
        dpc = np.where(outside[:, None, None], pc * dfac_out,
                       dpc * att[:, :, None])
        dps = np.where(outside[:, None, None], ps * dfac_out,
                       dps * att[:, :, None])

        facL = self.fac[None] * P
        facD = self.fac[None] * dP
        cb = cosm[:, None, :]
        sb = sinm[:, None, :]
        potl = (facL * (pc * cb + ps * sb)).sum((1, 2))
        potr = (facL * (dpc * cb + dps * sb)).sum((1, 2))
        pott = (facD * (pc * cb + ps * sb)).sum((1, 2))
        potp = (facL * (ps * cb - pc * sb) * mg[None, None, :]).sum((1, 2))

        s = self.scale
        potr = potr / (s * s)
        potl = potl / s
        pott = pott / s
        potp = potp / s

        xx, yy, zz = x[:, 0], x[:, 1], x[:, 2]
        r3 = r ** 3
        rho2 = xx ** 2 + yy ** 2
        ax = -(potr * xx / r - pott * xx * zz / r3)
        ay = -(potr * yy / r - pott * yy * zz / r3)
        az = -(potr * zz / r + pott * rho2 / r3)
        safe = rho2 > 1e-16
        ax = ax + np.where(safe, potp * yy / rho2, 0.0)
        ay = ay - np.where(safe, potp * xx / rho2, 0.0)
        return np.stack([ax, ay, az], -1), potl

    def run(self, x, v, mass, dt, nsteps, record_every=1):
        """KDK integration (src/step.cc:272-322); returns the coefficient
        trajectory [(step, coef)] and the final (x, v)."""
        x = np.array(x, np.float64)
        v = np.array(v, np.float64)
        mass = np.asarray(mass, np.float64)
        coef = self.coefficients(x, mass)
        acc, _ = self.acceleration(coef, x)
        traj = []
        for k in range(1, nsteps + 1):
            v = v + acc * (0.5 * dt)
            x = x + v * dt
            coef = self.coefficients(x, mass)
            acc, _ = self.acceleration(coef, x)
            v = v + acc * (0.5 * dt)
            if k % record_every == 0:
                traj.append((k, coef.copy()))
        return traj, (x, v)
