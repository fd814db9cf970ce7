"""Analytic biorthogonal sphere bases: Clutton-Brock and Hernquist (port
of exp_tpu/basis/analytic.py).

The closed-form basis sets of the reference's biorth library
(include/biorth.H:157 CBSphere, :197 HQSphere; exputil/biorth.cc):

* Clutton-Brock (1973): Phi_nl ~ r^l (1+r^2)^{-(l+1/2)} C_n^{(l+1)}(xi),
  xi = (r^2-1)/(r^2+1); the lowest member is the Plummer potential.
* Hernquist-Ostriker (1992): Phi_nl ~ r^l (1+r)^{-(2l+1)} C_n^{(2l+3/2)}(xi),
  xi = (r-1)/(r+1); the lowest member is the Hernquist potential.

C_n^(a) are Gegenbauer (ultraspherical) polynomials.  The density partners
come from the exact radial Poisson operator (spline derivatives of the
analytic potentials on a fine grid) and each (l, n) pair is rescaled so
that int Phi_j D_k dV = -delta_jk, with an exact discrete-biorthogonality
correction on the grids the runtime reads.  The tables are built on the
host in NumPy f64; the force is the port's SphereSL over them, on the
algebraic radial map (cmap 1), so `backend: pallas` runs K1 and K2.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.interpolate import CubicSpline
from scipy.special import eval_gegenbauer

from exp_tpu_torch import resolve_device


def _pair_tables(phi_fn, lmax, nmax, rmin, rmax, numr):
    """Common machinery: tabulate phi_fn(l, n, r), build density partners
    via the radial Poisson operator, normalize to int Phi_j D_k dV = -1."""
    from exp_tpu_torch.basis.flatdisk import _trapz_w

    # fine grid for derivatives, log-spaced
    rf = np.geomspace(rmin, rmax, 8 * numr)
    r = np.geomspace(rmin, rmax, numr)
    w = _trapz_w(rf)
    pot = np.zeros((numr, lmax + 1, nmax))
    dens = np.zeros_like(pot)
    for l in range(lmax + 1):
        U = np.zeros((len(rf), nmax))
        D = np.zeros_like(U)
        for n in range(nmax):
            u = phi_fn(l, n, rf)
            sp = CubicSpline(np.log(rf), u)
            lr = np.log(rf)
            du = sp(lr, 1) / rf                       # dPhi/dr
            d2u = (sp(lr, 2) - sp(lr, 1)) / rf ** 2   # d2Phi/dr2
            # nabla^2 Phi restricted to the (l) harmonic (= 4 pi rho)
            U[:, n] = u
            D[:, n] = d2u + 2.0 * du / rf - l * (l + 1) * u / rf ** 2
        # symmetric normalization, then an exact discrete-biorthogonality
        # correction of the density block: the analytic pair is only
        # biorthogonal on [0, inf) — finite-domain truncation leaves
        # O(1e-2) off-diagonals for slowly-decaying members, which the
        # linear correction removes without touching the potentials
        B = np.einsum("rn,rm,r->nm", U, D, rf ** 2 * w)
        s = 1.0 / np.sqrt(np.abs(np.diag(B)))
        U *= s[None, :]
        D *= s[None, :]
        Uc = np.stack([np.interp(r, rf, U[:, n]) for n in range(nmax)], -1)
        Dc = np.stack([np.interp(r, rf, D[:, n]) for n in range(nmax)], -1)
        # apply the correction on the OUTPUT grid so the tables the runtime
        # sees are exactly discretely biorthogonal
        wc = _trapz_w(r)
        Bc = np.einsum("rn,rm,r->nm", Uc, Dc, r ** 2 * wc)
        Dc = Dc @ (-np.linalg.inv(Bc))
        pot[:, l, :] = Uc
        dens[:, l, :] = Dc
    return pot, dens, r


def cb_phi(l, n, r):
    """Clutton-Brock potential member (unnormalized)."""
    xi = (r * r - 1.0) / (r * r + 1.0)
    return (r ** l) * (1.0 + r * r) ** (-(l + 0.5)) \
        * eval_gegenbauer(n, l + 1.0, xi)


def hq_phi(l, n, r):
    """Hernquist-Ostriker potential member (unnormalized)."""
    xi = (r - 1.0) / (r + 1.0)
    return (r ** l) * (1.0 + r) ** (-(2 * l + 1)) \
        * eval_gegenbauer(n, 2 * l + 1.5, xi)


def build_cb_tables(lmax, nmax, rmin=1e-3, rmax=50.0, numr=2000):
    return _pair_tables(cb_phi, lmax, nmax, rmin, rmax, numr)


def build_hq_tables(lmax, nmax, rmin=1e-3, rmax=50.0, numr=2000):
    return _pair_tables(hq_phi, lmax, nmax, rmin, rmax, numr)


def make_analytic_force(kind: str, lmax: int, nmax: int, rmin=1e-3,
                        rmax=50.0, numr: int = 2000, scale: float = 1.0,
                        dtype=torch.float32, backend: str = "matmul",
                        device=None):
    """SphereSL force over the CB ('CBsphere') or Hernquist-Ostriker
    ('hernq') analytic basis on `device` (None: CUDA, raising when there
    is none).  `scale` rescales the basis unit length (r -> r/scale)."""
    from exp_tpu_torch.basis.slgrid import SLGridSph
    from exp_tpu_torch.forces.spherical import SphereSL, spline_radial_tables
    from exp_tpu_torch.ops import coords
    from exp_tpu_torch.ops.special import real_ylm_norm

    device = resolve_device(device)
    build = {"CBsphere": build_cb_tables, "hernq": build_hq_tables}[kind]
    pot, dens, r = build(lmax, nmax, rmin=rmin, rmax=rmax, numr=numr)
    # resample onto the mapped coordinate so from_raw's uniform-xi lookup
    # is exact (r grid is log-spaced, the runtime grid is uniform in xi)
    cmap, rmap = 1, 1.0
    xi = np.linspace(coords.r_to_xi(rmin, cmap, rmap),
                     coords.r_to_xi(rmax, cmap, rmap), numr)
    rx = np.asarray(coords.xi_to_r(xi, cmap, rmap))
    potx = np.zeros_like(pot)
    densx = np.zeros_like(dens)
    for l in range(lmax + 1):
        for n in range(nmax):
            potx[:, l, n] = np.interp(rx, r, pot[:, l, n])
            densx[:, l, n] = np.interp(rx, r, dens[:, l, n])
    # re-apply the exact discrete-biorthogonality correction ON THIS grid:
    # the resample would otherwise re-introduce interpolation-level
    # off-diagonals in the tables the runtime uses
    rp = 1.0 / np.asarray(coords.dxi_dr(xi, cmap, rmap))
    wxi = np.full(numr, xi[1] - xi[0])
    wxi[0] *= 0.5
    wxi[-1] *= 0.5
    meas = rx ** 2 * rp * wxi
    for l in range(lmax + 1):
        B = np.einsum("rn,rm,r->nm", potx[:, l], densx[:, l], meas)
        densx[:, l] = densx[:, l] @ (-np.linalg.inv(B))
    grid = SLGridSph.from_raw(potx, densx, rmin=rmin, rmax=rmax, cmap=cmap,
                              rmap=rmap, dtype=dtype, device=device)
    nc = min(512, numr)
    xic = np.linspace(xi[0], xi[-1], nc)
    tabc = np.empty((nc, (lmax + 1) * nmax))
    flat = potx.reshape(numr, -1)
    for kk in range(flat.shape[1]):
        tabc[:, kk] = np.interp(xic, xi, flat[:, kk])
    ncs = min(256, numr)
    tabc_s, tabd_s = (np.ascontiguousarray(a) for a in
                      spline_radial_tables(flat, xi, ncs))
    f32 = dict(dtype=torch.float32, device=device)
    return SphereSL(grid=grid, fac=real_ylm_norm(lmax, dtype, device),
                    tabc=torch.as_tensor(tabc, dtype=dtype, device=device),
                    lmax=lmax, nmax=nmax, scale=scale, backend=backend,
                    numr_c=nc, tabc_s=torch.as_tensor(tabc_s, **f32),
                    tabd_s=torch.as_tensor(tabd_s, **f32), numr_cs=ncs)
