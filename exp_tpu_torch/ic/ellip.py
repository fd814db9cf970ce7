"""Monopole mass/potential of a homogeneous triaxial ellipsoid (host,
NumPy; a copy of exp_tpu/ic/ellip.py).

The reference's EllipForce (utils/ICs/EllipForce.cc, linked into gensph
for the EBAR option, gensph.cc:360-530): tabulate M(<r), the ellipsoid
mass inside the sphere of radius r, by Gauss-Legendre quadrature over an
octant, then the monopole potential Phi(r) = -M/r - int_r^rmax (dM/ds)/s
ds.  gensph folds this into the halo model (mass and potential only, the
halo density stays the tracer) so the Eddington DF responds to an
embedded bar.
"""

from __future__ import annotations

import numpy as np


class EllipForce:
    """Spherically-averaged mass/potential table of a constant-density
    ellipsoid with semi-axes (a, b, c) and total mass `mass`."""

    def __init__(self, a, b, c, mass, num=100, numr=200):
        self.a, self.b, self.c, self.mass = a, b, c, mass
        # Gauss-Legendre on [0, 1] (exputil LegeQuad convention)
        u, w = np.polynomial.legendre.leggauss(num)
        u, w = 0.5 * (u + 1.0), 0.5 * w
        self.r = np.linspace(0.0, a, numr)
        mfac = mass / (4.0 * np.pi / 3.0 * a * b * c)
        m = np.zeros(numr)
        for v in range(1, numr):
            xfac = min(self.r[v], a)
            x = xfac * u                                    # (num,)
            yfac = np.sqrt(np.maximum(xfac ** 2 - x ** 2, 0.0))
            y = yfac[:, None] * u[None, :]                  # (num, num)
            zfac = np.sqrt(np.maximum(
                xfac ** 2 - x[:, None] ** 2 - y ** 2, 0.0))
            z = zfac[..., None] * u                         # (num,num,num)
            inside = (x[:, None, None] ** 2 / a ** 2
                      + y[..., None] ** 2 / b ** 2
                      + z ** 2 / c ** 2) < 1.0
            wts = (w[:, None, None] * w[None, :, None] * w[None, None, :]
                   * xfac * yfac[:, None, None] * zfac[..., None])
            m[v] = 8.0 * np.sum(wts * inside) * mfac
        # the indicator-function quadrature wiggles ~1% near r=a; M(<r)
        # is physically monotone and bounded by the total mass
        self.m = m = np.minimum(np.maximum.accumulate(m), mass)
        # external-potential integrand (dM/dr)/r, trapezoid accumulation
        w1 = np.zeros(numr)
        w1[1:] = np.gradient(m, self.r)[1:] / self.r[1:]
        w2 = np.concatenate([[0.0], np.cumsum(
            0.5 * (w1[1:] + w1[:-1]) * np.diff(self.r))])
        self.p = np.where(self.r > 0,
                          -m / np.where(self.r > 0, self.r, 1.0)
                          - (w2[-1] - w2),
                          -w2[-1])

    def get_mass(self, r):
        r = np.asarray(r, np.float64)
        return np.interp(r, self.r, self.m, right=float(self.m[-1]))

    def get_pot(self, r):
        r = np.asarray(r, np.float64)
        return np.where(r <= self.a,
                        np.interp(r, self.r, self.p),
                        -float(self.m[-1]) / np.maximum(r, 1e-30))


def ellip_monopole_mass(ellip: EllipForce, r, rbar, smooth=0.0):
    """Bar mass profile on radii r, optionally Gaussian-smoothed with the
    reference's erf blend (gensph.cc:439-447: raw ellipsoid mass inside
    0.1 RBAR, convolved profile outside, clamped flat past
    RBAR + 30 sigma)."""
    MS = ellip.get_mass(r)
    if smooth <= 0.0:
        return MS
    # dense grid convolution of M(x) with a unit Gaussian
    xmax = float(r[-1])
    nx = 4096
    x = np.linspace(0.0, xmax + 30.0 * smooth, nx)
    dx = x[1] - x[0]
    Mx = ellip.get_mass(x)
    half = int(np.ceil(5.0 * smooth / dx))
    k = np.exp(-0.5 * (np.arange(-half, half + 1) * dx / smooth) ** 2)
    k /= k.sum()
    Ms = np.convolve(np.pad(Mx, half, mode="edge"), k, mode="valid")
    sm = np.interp(r, x, Ms)
    from scipy.special import erf

    fac = 0.5 * (1.0 + erf((r - 0.1 * rbar) / (0.025 * rbar)))
    out = (1.0 - fac) * MS + fac * sm
    # flat (total bar mass) beyond the smoothing support
    out = np.where(r > rbar + 30.0 * smooth, float(ellip.m[-1]), out)
    return out


def add_ellip_to_model(halo, ellip: EllipForce, rbar=None, smooth=0.0):
    """Composite halo + ellipsoidal-bar model (gensph.cc:478-505): add
    the bar's monopole mass to the halo mass, recompute the potential
    from the total mass, keep the halo density as the tracer profile."""
    from exp_tpu_torch.basis.model import SphericalModelTable

    r = halo.r
    MS = ellip_monopole_mass(ellip, r, rbar or ellip.a, smooth=smooth)
    m2 = halo.mass + MS
    dm = np.gradient(m2, r)
    integ = dm / np.maximum(r, 1e-30)
    t2 = np.concatenate([[0.0], np.cumsum(
        0.5 * (integ[1:] + integ[:-1]) * np.diff(r))])
    p2 = np.where(r > 0, -m2 / np.maximum(r, 1e-30) - (t2[-1] - t2),
                  -(t2[-1] - t2))
    return SphericalModelTable(r, halo.rho, m2, p2,
                               comment=(halo.comment
                                        + f" + ellip bar M={ellip.mass}"))
