"""Slab basis: periodic in (x, y), conditioned vertical functions in z
(jax-free copy of exp_tpu/basis/slab.py).

The capability of the reference's SlabSL force (src/SlabSL.cc,
SLGridSlab in exputil/SLGridMP2.cc:2760-2833): gravitational field of a
plane-parallel slab on the unit box [0,1]^2 x [-zmax, zmax],

    Phi(x) = sum_{kx,ky,n} a_{k n} e^{2 pi i (kx x + ky y)} phi^k_n(z)

Construction (replaces the sledge slab solve with Green's functions): for
each horizontal wavenumber kappa = 2 pi |k| and vertical seed densities
d_j(z) = rho0(z) P_j(z/zmax) (the slab profile times Legendre polynomials),
the exact potential partner solves (d2/dz2 - kappa^2) phi = d with decaying
boundary conditions, i.e.

    phi(z) = -1/(2 kappa) int e^{-kappa |z - z'|} d(z') dz'     (kappa > 0)
    phi(z) =  1/2 int |z - z'| d(z') dz'                        (kappa = 0)

The pairs are then biorthonormalized against int phi_j [4 pi d_k] dz = -delta
(leading function = the slab profile).  Default profile: isothermal
sech^2(z/h) (the reference's slab model).

The arithmetic is the JAX package's, operation by operation, so the same
arguments give the same tables.  The HDF5 cache imports h5py only inside its
functions.  In a world of several ranks rank 0 builds (or reads its cache)
and broadcasts the tables, where the JAX package's other processes wait
for its cache file.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np


@dataclass
class SlabTables:
    """Vertical function tables per (kx, ky, n).

    phi/dphi/dens: (numz, nmaxx + 1, nmaxy + 1, nmax) on a uniform z grid.
    The tables depend only on |k|, so only non-negative kx, ky are stored;
    sgn (nmaxx + 1, nmaxy + 1, nmax) holds the per-function pairing signs."""

    nmaxx: int
    nmaxy: int
    nmax: int
    numz: int
    zmax: float
    h: float
    phi: np.ndarray
    dphi: np.ndarray
    dens: np.ndarray
    zgrid: np.ndarray
    sgn: np.ndarray = None
    key: str = ""

    def write_cache(self, path):
        import os

        import h5py

        # atomic publish: a reader never sees a half-written file
        tmp = f"{path}.tmp.{os.getpid()}"
        with h5py.File(tmp, "w") as f:
            f.attrs["type"] = "SlabSL"
            f.attrs["version"] = 1
            for k in ("nmaxx", "nmaxy", "nmax", "numz"):
                f.attrs[k] = getattr(self, k)
            for k in ("zmax", "h"):
                f.attrs[k] = getattr(self, k)
            f.attrs["key"] = self.key
            for k in ("phi", "dphi", "dens", "zgrid", "sgn"):
                f.create_dataset(k, data=getattr(self, k))
        os.replace(tmp, path)

    @classmethod
    def read_cache(cls, path):
        import h5py

        with h5py.File(path, "r") as f:
            if f.attrs.get("type") != "SlabSL":
                raise ValueError("not a SlabSL cache")
            kw = {k: int(f.attrs[k]) for k in ("nmaxx", "nmaxy", "nmax",
                                               "numz")}
            kw.update({k: float(f.attrs[k]) for k in ("zmax", "h")})
            kw["key"] = str(f.attrs["key"])
            for k in ("phi", "dphi", "dens", "zgrid", "sgn"):
                kw[k] = f[k][...]
        return cls(**kw)


def slab_density(type: str, h: float):
    """Background vertical density rho0(z) (unit surface density) of the
    reference's SlabModel family (SLGridMP2.cc:1841-1925): 'iso'
    (isothermal sech^2), 'const' (uniform within |z| < h), 'para'
    (parabolic within |z| < h)."""
    t = type.lower()
    if "para" in t:
        return lambda z: np.where(np.abs(z) < h,
                                  3.0 * (1.0 - (z / h) ** 2) / (4.0 * h),
                                  0.0)
    if "const" in t:
        return lambda z: np.where(np.abs(z) < h, 1.0 / (2.0 * h), 0.0)
    return lambda z: (1.0 / (2.0 * h)) / np.cosh(z / h) ** 2


def _cached(cachename, key):
    """The tables in `cachename` when its key matches, else None."""
    if cachename is None:
        return None
    try:
        t = SlabTables.read_cache(cachename)
    except (OSError, KeyError, ValueError):
        return None
    return t if t.key == key else None


def _key(params):
    return hashlib.sha256(json.dumps(params, sort_keys=True).encode()
                          ).hexdigest()[:16]


def build_slab_tables(nmaxx: int = 4, nmaxy: int = 4, nmax: int = 6,
                      zmax: float = 0.1, h: float = 0.01, numz: int = 401,
                      knots: int = 800, type: str = "iso",
                      method: str = "greens",
                      cachename: str | None = None, world=None) -> SlabTables:
    """Vertical basis tables.

    method='greens' (default): Green's-function pairs from conditioned
    seed densities (exact Poisson partners).
    method='sl': the reference's Sturm-Liouville construction
    (SLGridSlab, SLGridMP2.cc:1952-2070): for each kappa solve
    phi'' - kappa^2 phi = -lambda rhobar(z) phi with decaying Robin BCs
    phi' -+ kappa phi = 0 at +-zmax, rhobar = 4 pi rho0, as a dense
    symmetric finite-difference generalized eigenproblem.
    type: background model 'iso' | 'const' | 'para' (both methods).
    `world`: a World of several ranks builds on rank 0 only.
    """
    if world is not None and world.size > 1:
        # rank 0 builds (or reads its cache) and broadcasts; the others
        # never build (SLGridMP2.cc:280-382)
        kw = {k: v for k, v in locals().items() if k != "world"}
        from exp_tpu_torch.parallel.distributed import primary_build

        return primary_build(world, lambda: build_slab_tables(**kw))
    if method == "sl":
        return _build_slab_tables_sl(nmaxx=nmaxx, nmaxy=nmaxy, nmax=nmax,
                                     zmax=zmax, h=h, numz=numz,
                                     type=type, cachename=cachename)
    key = _key(dict(nmaxx=nmaxx, nmaxy=nmaxy, nmax=nmax, zmax=zmax, h=h,
                    numz=numz, knots=knots, type=type, version=1))
    t = _cached(cachename, key)
    if t is not None:
        return t

    # quadrature grid in z and the profile (unit surface density)
    zq = np.linspace(-zmax, zmax, knots)
    wq = np.full(knots, zq[1] - zq[0])
    wq[0] *= 0.5
    wq[-1] *= 0.5
    rho0 = slab_density(type, h)(zq)

    # seeds: rho0 * P_j(u) with u = tanh(z/(2h)), the mapped coordinate
    # that resolves the profile scale
    uq = np.tanh(zq / (2.0 * h)) / np.tanh(zmax / (2.0 * h))
    seeds = np.stack([rho0 * np.polynomial.legendre.legval(
        uq, [0] * j + [1]) for j in range(nmax)], axis=0)  # (n, knots)

    zg = np.linspace(-zmax, zmax, numz)

    phi_t = np.zeros((numz, nmaxx + 1, nmaxy + 1, nmax))
    dphi_t = np.zeros_like(phi_t)
    dens_t = np.zeros_like(phi_t)
    sgn_t = np.ones((nmaxx + 1, nmaxy + 1, nmax))

    done = {}                       # per distinct kappa (tables depend on |k|)
    for ix in range(nmaxx + 1):
        for iy in range(nmaxy + 1):
            kap2 = (2 * np.pi) ** 2 * (ix * ix + iy * iy)
            kap = float(np.sqrt(kap2))
            if kap not in done:
                D = np.abs(zq[:, None] - zq[None, :])
                if kap > 0:
                    G = -np.exp(-kap * D) / (2.0 * kap)
                else:
                    G = 0.5 * D
                phi_q = (G * wq[None, :]) @ seeds.T * 4.0 * np.pi  # (knots, n)
                # E_jk = -int phi_j [4 pi d_k] dz
                E = -np.einsum("qj,kq,q->jk", phi_q, 4.0 * np.pi * seeds, wq)
                E = 0.5 * (E + E.T)
                # eigen-normalization with per-function pairing signs (the
                # kappa = 0 block is indefinite): E = V L V^T,
                # C = V |L|^{-1/2}, s_n = sign(lambda_n)
                lam, V = np.linalg.eigh(E)
                order = np.argsort(-np.abs(lam))
                lam, V = lam[order], V[:, order]
                sg = np.sign(lam)
                C = V / np.sqrt(np.abs(lam))[None, :]
                seeds_b = C.T @ seeds                   # (n, knots)
                # tabulate on zg via the Green's integral
                Dg = zg[:, None] - zq[None, :]
                A = np.abs(Dg)
                if kap > 0:
                    Gg = -np.exp(-kap * A) / (2.0 * kap)
                    dGg = np.sign(Dg) * np.exp(-kap * A) / 2.0
                else:
                    Gg = 0.5 * A
                    dGg = 0.5 * np.sign(Dg)
                pg = 4.0 * np.pi * (Gg * wq[None, :]) @ seeds_b.T
                dpg = 4.0 * np.pi * (dGg * wq[None, :]) @ seeds_b.T
                dg = 4.0 * np.pi * np.stack([np.interp(zg, zq, s)
                                             for s in seeds_b], axis=1)
                done[kap] = (pg, dpg, dg, sg)
            pg, dpg, dg, sg = done[kap]
            phi_t[:, ix, iy, :] = pg
            dphi_t[:, ix, iy, :] = dpg
            dens_t[:, ix, iy, :] = dg
            sgn_t[ix, iy, :] = sg

    t = SlabTables(nmaxx=nmaxx, nmaxy=nmaxy, nmax=nmax, numz=numz,
                   zmax=zmax, h=h, phi=phi_t, dphi=dphi_t, dens=dens_t,
                   zgrid=zg, sgn=sgn_t, key=key)
    if cachename is not None:
        t.write_cache(cachename)
    return t


def _build_slab_tables_sl(nmaxx, nmaxy, nmax, zmax, h, numz, type,
                          cachename=None, nsolve=1601):
    """Sturm-Liouville slab construction (see build_slab_tables).

    Finite-volume discretization of -phi'' + kappa^2 phi = lambda rhobar phi
    on [-zmax, zmax] with the Robin rows absorbed symmetrically, solved as
    eigh(B, A); A-orthonormal eigenvectors satisfy int phi_n (4 pi d_m) dz =
    -delta_nm for d_m = -lambda_m rhobar phi_m / (4 pi)."""
    from scipy.linalg import eigh

    key = _key(dict(nmaxx=nmaxx, nmaxy=nmaxy, nmax=nmax, zmax=zmax, h=h,
                    numz=numz, nsolve=nsolve, type=type, method="sl",
                    version=1))
    t = _cached(cachename, key)
    if t is not None:
        return t

    zq = np.linspace(-zmax, zmax, nsolve)
    dz = zq[1] - zq[0]
    rhobar = 4.0 * np.pi * slab_density(type, h)(zq)
    w = np.full(nsolve, dz)
    w[0] = w[-1] = 0.5 * dz

    zg = np.linspace(-zmax, zmax, numz)
    phi_t = np.zeros((numz, nmaxx + 1, nmaxy + 1, nmax))
    dphi_t = np.zeros_like(phi_t)
    dens_t = np.zeros_like(phi_t)
    sgn_t = np.ones((nmaxx + 1, nmaxy + 1, nmax))

    done = {}
    for ix in range(nmaxx + 1):
        for iy in range(nmaxy + 1):
            kap = 2.0 * np.pi * np.sqrt(float(ix * ix + iy * iy))
            if kap not in done:
                main = np.full(nsolve, 2.0 / dz) + kap**2 * w
                main[0] = 1.0 / dz + kap + kap**2 * w[0]
                main[-1] = 1.0 / dz + kap + kap**2 * w[-1]
                A = (np.diag(main)
                     + np.diag(np.full(nsolve - 1, -1.0 / dz), 1)
                     + np.diag(np.full(nsolve - 1, -1.0 / dz), -1))
                B = np.diag(rhobar * w)
                if kap == 0.0:
                    # kappa = 0: Dirichlet phi(+-zmax) = 0 (the reference's
                    # poffset convention, SLGridMP2.cc:1972)
                    A = A[1:-1, 1:-1]
                    B = B[1:-1, 1:-1]
                mu, V = eigh(B, A)
                order = np.argsort(-mu)[:nmax]
                mu_n = mu[order]
                lam = 1.0 / np.maximum(mu_n, 1e-300)
                phi_q = V[:, order]                     # (nsolve, nmax)
                if kap == 0.0:                          # restore the
                    phi_q = np.pad(phi_q, ((1, 1), (0, 0)))  # edge zeros
                dens_q = -(lam[None, :] * rhobar[:, None] * phi_q
                           / (4.0 * np.pi))
                dphi_q = np.gradient(phi_q, dz, axis=0, edge_order=2)
                pg = np.stack([np.interp(zg, zq, phi_q[:, n])
                               for n in range(nmax)], axis=1)
                dpg = np.stack([np.interp(zg, zq, dphi_q[:, n])
                                for n in range(nmax)], axis=1)
                dg = 4.0 * np.pi * np.stack(
                    [np.interp(zg, zq, dens_q[:, n])
                     for n in range(nmax)], axis=1)
                done[kap] = (pg, dpg, dg)
            pg, dpg, dg = done[kap]
            phi_t[:, ix, iy, :] = pg
            dphi_t[:, ix, iy, :] = dpg
            dens_t[:, ix, iy, :] = dg

    t = SlabTables(nmaxx=nmaxx, nmaxy=nmaxy, nmax=nmax, numz=numz,
                   zmax=zmax, h=h, phi=phi_t, dphi=dphi_t, dens=dens_t,
                   zgrid=zg, sgn=sgn_t, key=key)
    if cachename is not None:
        t.write_cache(cachename)
    return t
