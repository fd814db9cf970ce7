"""Analytic spherical-Bessel radial basis (port of exp_tpu/basis/bessel.py;
the reference's `bessel` force, src/Bessel.H/.cc over exputil
bessel/sbessz).

Basis pair on r in [0, rmax] (G=1):
    pot_ln(r)  = c_ln j_l(k_ln r),       k_ln = alpha_ln / rmax
    dens_ln(r) = -k_ln^2 pot_ln(r)       (since lap_l j_l(kr) = -k^2 j_l)
with alpha_ln the n-th positive zero of j_l (Dirichlet at rmax) and c_ln
chosen so int pot dens r^2 dr = -1, i.e. c_ln^2 int j_l^2 r^2 dr = 1/k^2;
the closed form int_0^R j_l(kr)^2 r^2 dr = R^3/2 j_{l+1}(alpha)^2 gives
    c_ln = sqrt(2 / R^3) / (k_ln |j_{l+1}(alpha_ln)|).

The tables are built on the host in NumPy f64; the force is the port's
SphereSL over them, on the identity radial map (cmap 0).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import brentq
from scipy.special import spherical_jn

from exp_tpu_torch import resolve_device


def sph_bessel_zeros(l: int, n: int) -> np.ndarray:
    """First n positive zeros of j_l (the reference's exputil sbessz)."""
    # scan with asymptotic spacing ~pi; zeros of j_l start after ~l
    zeros = []
    a = max(1e-6, l * 0.5)
    step = 0.5
    x0 = a
    f0 = spherical_jn(l, x0)
    x = x0
    while len(zeros) < n:
        x += step
        f1 = spherical_jn(l, x)
        if f0 * f1 < 0:
            zeros.append(brentq(lambda t: spherical_jn(l, t), x - step, x,
                                xtol=1e-14))
        f0 = f1
    return np.array(zeros)


def build_bessel_tables(lmax: int, nmax: int, rmax: float, numr: int = 2000,
                        rmin: float = 0.0):
    """(pot, dens) tables (numr, lmax+1, nmax) on a uniform r grid (cmap=0)."""
    r = np.linspace(rmin, rmax, numr)
    pot = np.zeros((numr, lmax + 1, nmax))
    dens = np.zeros_like(pot)
    for l in range(lmax + 1):
        alphas = sph_bessel_zeros(l, nmax)
        k = alphas / rmax
        c = np.sqrt(2.0 / rmax**3) / (k * np.abs(spherical_jn(l + 1, alphas)))
        for n in range(nmax):
            pot[:, l, n] = c[n] * spherical_jn(l, k[n] * r)
            dens[:, l, n] = -k[n] ** 2 * pot[:, l, n]
    return pot, dens, r


def make_bessel_force(lmax: int, nmax: int, rmax: float, numr: int = 2000,
                      dtype=torch.float32, backend: str = "gather",
                      device=None):
    """SphereSL force over the analytic Bessel tables on `device` (None:
    CUDA, raising when there is none)."""
    from exp_tpu_torch.basis.slgrid import SLGridSph
    from exp_tpu_torch.forces.spherical import SphereSL, spline_radial_tables
    from exp_tpu_torch.ops.special import real_ylm_norm

    device = resolve_device(device)
    pot, dens, r = build_bessel_tables(lmax, nmax, rmax, numr)
    grid = SLGridSph.from_raw(pot, dens, rmin=0.0, rmax=rmax, cmap=0,
                              rmap=1.0, dtype=dtype, device=device)
    nc = min(512, numr)
    xi_c = np.linspace(0.0, rmax, nc)
    tabc = np.empty((nc, (lmax + 1) * nmax))
    flat = pot.reshape(numr, -1)
    for kk in range(flat.shape[1]):
        tabc[:, kk] = np.interp(xi_c, r, flat[:, kk])
    ncs = min(256, numr)
    tabc_s, tabd_s = (np.ascontiguousarray(a) for a in
                      spline_radial_tables(flat, r, ncs))
    f32 = dict(dtype=torch.float32, device=device)
    return SphereSL(grid=grid, fac=real_ylm_norm(lmax, dtype, device),
                    tabc=torch.as_tensor(tabc, dtype=dtype, device=device),
                    lmax=lmax, nmax=nmax, scale=1.0, backend=backend,
                    numr_c=nc, tabc_s=torch.as_tensor(tabc_s, **f32),
                    tabd_s=torch.as_tensor(tabd_s, **f32), numr_cs=ncs)
