"""Razor-thin 2D polar disk bases (flatdisk family), host build (a jax-free
copy of exp_tpu/basis/flatdisk.py: `surface_density_model` and
`build_flatdisk_tables`).

* Target surface-density models: kuzmin, exponential, mestel (tapered),
  zang (double-tapered), the reference's EmpCyl2d model functors.
* Radial basis per azimuthal m: seed surface densities
  sigma_k(R) = Sigma(R) P_k(x(R)) (Legendre polynomials in the mapped
  radial coordinate, weighted by the target), made biorthonormal by
  Cholesky-orthogonalising the interaction (energy) matrix.
* Potentials from surface densities via Hankel transforms:
      sigma~_m(k) = int J_m(kR) sigma(R) R dR
      Phi_m(R,z)  = -2 pi int J_m(kR) e^{-k|z|} sigma~_m(k) dk
  tabulated with dPhi/dR, dPhi/dz on the same mapped (x(R), asinh z) grids
  as the 3D cylinder basis, so CylinderForce serves them unchanged.

Conventions: real azimuthal basis with sqrt(2) for m>0; biorthogonality
int Phi_mn [4 pi sigma_mn' delta(z)] dV = -delta; coefficients
b = -4 pi sum_i m_i Phi(x_i).  The `dens` table stores 4 pi sigma(R)
(z-independent), so CylinderForce.density() returns SURFACE density.

Differences from the JAX module: no multi-process cache wait (one process
builds); `h5py` is imported only by the cache reader and writer.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
from scipy.special import jv, jvp

from exp_tpu_torch.basis.empcyl import EmpCylTables
from exp_tpu_torch.ops import coords


def _trapz_w(x):
    """Trapezoid quadrature weights."""
    w = np.empty_like(x)
    w[1:-1] = 0.5 * (x[2:] - x[:-2])
    w[0] = 0.5 * (x[1] - x[0])
    w[-1] = 0.5 * (x[-1] - x[-2])
    return w


def surface_density_model(name: str, a: float = 1.0, M: float = 1.0,
                          **kw):
    """Returns Sigma(R) callable normalized to total mass M."""
    name = name.lower()
    if "kuzmin" in name:
        def S(R):
            return M * a / (2.0 * np.pi * (R ** 2 + a ** 2) ** 1.5)
    elif "mestel" in name or "zang" in name:
        # finite Mestel: Sigma ~ 1/R with inner/outer tapers; Zang adds a
        # double taper
        ri = kw.get("rinner", 0.1 * a)
        ro = kw.get("router", 10.0 * a)
        ni = kw.get("nu", 4.0)
        no = kw.get("mu", 4.0)

        def S_raw(R):
            R = np.maximum(R, 1e-12)
            ti = R ** ni / (ri ** ni + R ** ni)
            to = ro ** no / (ro ** no + R ** no)
            return ti * to / (2.0 * np.pi * R)

        Rq = np.geomspace(1e-4 * a, 100 * a, 4000)
        mtot = np.trapezoid(2 * np.pi * Rq * S_raw(Rq), Rq)

        def S(R):
            return M * S_raw(R) / mtot
    else:   # exponential (default)
        def S(R):
            return M / (2.0 * np.pi * a * a) * np.exp(-R / a)
    return S


def build_flatdisk_tables(
        mmax: int = 6, nmax: int = 10,
        model: str = "expon", acyl: float = 1.0, Mtot: float = 1.0,
        rcylmin: float = 1e-3, rcylmax: float = 20.0,
        numx: int = 256, numy: int = 128, knots: int = 400,
        numk: int = 256, hcyl: float | None = None,
        cachename: str | None = None, verbose: bool = False,
        **model_kw) -> EmpCylTables:
    """Build (or load) razor-thin disk basis tables packed as EmpCylTables.

    hcyl only sets the vertical grid mapping scale (default acyl/10)."""
    if hcyl is None:
        hcyl = 0.1 * acyl
    params = dict(mmax=mmax, nmax=nmax, model=model, acyl=acyl, Mtot=Mtot,
                  rcylmin=rcylmin, rcylmax=rcylmax, numx=numx, numy=numy,
                  knots=knots, numk=numk, hcyl=hcyl, version=1, **model_kw)
    key = hashlib.sha256(json.dumps(params, sort_keys=True).encode()
                         ).hexdigest()[:16]
    if cachename is not None:
        try:
            t = EmpCylTables.read_cache(cachename)
            if t.key == key:
                return t
        except (OSError, KeyError, ValueError):
            pass

    Sigma = surface_density_model(model, a=acyl, M=Mtot, **model_kw)
    rmin = rcylmin * acyl
    rmax_grid = rcylmax * acyl

    # radial quadrature (log-spaced, trapezoid)
    Rq = np.geomspace(rmin * 0.1, rmax_grid, knots)
    wR = _trapz_w(Rq)
    Sq = Sigma(Rq)

    # k grid for Hankel transforms
    kq = np.linspace(1e-3 / acyl, 25.0 / acyl, numk)
    wk = _trapz_w(kq)

    # output grids (same mapping conventions as empcyl)
    xmin = float(coords.r_to_xi(rmin, 1, acyl))
    xmax = float(coords.r_to_xi(rmax_grid, 1, acyl))
    xg = np.linspace(xmin, xmax, numx)
    Rg = np.asarray(coords.xi_to_r(xg, 1, acyl))
    ymax = float(np.arcsinh(rmax_grid / hcyl))
    yg = np.linspace(-ymax, ymax, numy)
    zg = hcyl * np.sinh(yg)

    pot_out = np.zeros((numx, numy, mmax + 1, nmax))
    rfo_out = np.zeros_like(pot_out)
    zfo_out = np.zeros_like(pot_out)
    den_out = np.zeros_like(pot_out)

    # Legendre seeds in the mapped coordinate over [rmin, rmax]
    xq = np.asarray(coords.r_to_xi(np.clip(Rq, rmin, rmax_grid), 1, acyl))
    xq_n = 2 * (xq - xmin) / (xmax - xmin) - 1

    for m in range(mmax + 1):
        sq2 = np.sqrt(2.0) if m > 0 else 1.0
        # seeds: sigma_k = Sigma * P_k(x), times an (R/a)^m taper near the
        # center so sigma ~ R^m (regularity of m-harmonics)
        taper = (Rq / (Rq + 0.05 * acyl)) ** m
        seeds = np.stack([Sq * taper * np.polynomial.legendre.legval(
            xq_n, [0] * k_ + [1]) for k_ in range(nmax)], axis=0)  # (n, knots)

        # Hankel forward: sig~(k) = int J_m(kR) sigma R dR
        Jk = jv(m, kq[:, None] * Rq[None, :])                  # (numk, knots)
        st = np.einsum("kq,nq->nk", Jk * (Rq * wR)[None, :], seeds)

        # potentials at quadrature radii (z=0) for the energy matrix
        phi0 = -2.0 * np.pi * np.einsum("kq,nk,k->nq", Jk, st, wk)

        # energy matrix E_jk = -c_m int Phi_j [4 pi sigma_k] R dR, with
        # c_m = 8 pi^2 for the target int Phi_j D_k dV = -delta
        E = -8.0 * np.pi ** 2 * np.einsum("jq,kq,q->jk", phi0, seeds, Rq * wR)
        E = 0.5 * (E + E.T)
        # Cholesky biorthonormalization (keeps seed order/conditioning)
        L = np.linalg.cholesky(E + 1e-12 * np.trace(E) / nmax * np.eye(nmax))
        C = np.linalg.inv(L).T                                  # E -> I
        st_b = C.T @ st                                         # (n, numk)

        # tabulate on the grid
        JR = jv(m, kq[:, None] * Rg[None, :])                   # (numk, numx)
        dJR = jvp(m, kq[:, None] * Rg[None, :]) * kq[:, None]
        ez = np.exp(-kq[:, None] * np.abs(zg)[None, :])         # (numk, numy)
        sgnz = np.sign(zg)[None, :]

        # Phi(R,z) = -2pi sum_k J_m(kR) e^{-k|z|} st(k) wk
        pot_out[:, :, m, :] = -2 * np.pi * np.einsum(
            "kx,ky,nk,k->xyn", JR, ez, st_b, wk) * sq2
        rfo_out[:, :, m, :] = -2 * np.pi * np.einsum(
            "kx,ky,nk,k->xyn", dJR, ez, st_b, wk) * sq2
        zfo_out[:, :, m, :] = 2 * np.pi * np.einsum(
            "kx,ky,nk,k->xyn", JR, ez * kq[:, None] * sgnz, st_b, wk) * sq2
        # surface density on the grid (4 pi sigma, z-independent)
        xg_n = 2 * (np.asarray(coords.r_to_xi(
            np.clip(Rg, rmin, rmax_grid), 1, acyl)) - xmin) / (xmax - xmin) - 1
        taper_g = (Rg / (Rg + 0.05 * acyl)) ** m
        Sg = Sigma(Rg)
        seed_g = np.stack([Sg * taper_g * np.polynomial.legendre.legval(
            xg_n, [0] * k_ + [1]) for k_ in range(nmax)], axis=0)
        dens_g = (C.T @ seed_g)                                 # (n, numx)
        den_out[:, :, m, :] = (4.0 * np.pi * dens_g.T[:, None, :]
                               * np.ones((1, numy, 1))) * sq2
        if verbose:
            print(f"[flatdisk] m={m} done")

    t = EmpCylTables(
        mmax=mmax, nmax=nmax, numx=numx, numy=numy, acyl=acyl, hcyl=hcyl,
        rcylmin=rcylmin, rcylmax=rcylmax,
        xmin=xmin, xmax=xmax, dx=float(xg[1] - xg[0]),
        ymin=-ymax, ymax=ymax, dy=float(yg[1] - yg[0]),
        pot=pot_out, rforce=rfo_out, zforce=zfo_out, dens=den_out,
        even_count=np.full(mmax + 1, nmax), key=key)
    if cachename is not None:
        t.write_cache(cachename)
    return t
