"""Empirical-orthogonal-function (EOF) cylindrical disk basis, host build (a
jax-free copy of exp_tpu/basis/empcyl.py).

Builds a biorthogonal 3D disk basis Phi^m_mu(R, z) e^{i m phi} conditioned
on a target disk density, as linear combinations of a large "fiducial"
spherical Sturm-Liouville basis (the reference's EmpCylSL construction,
exputil/EmpCylSL.cc; Weinberg 1999 EOF conditioning):

  1. Spherically average the disk density -> auxiliary spherical model;
     build SL tables with (lmaxfid, nmaxfid).
  2. Per azimuthal m and per z-parity block (l-m even/odd): accumulate the
     density-weighted Gram matrix M_jk = int rho_d Phi_j Phi_k dV over the
     fiducial members j=(l,n) with that m, and solve the symmetric
     eigenproblem.
  3. Keep the top eigenvectors (nmax total, ncylodd of them odd),
     re-orthonormalised in f64.
  4. Tabulate U (potential), dU/dR, dU/dz (chain rule through the spherical
     tables) and the density partner D on a mapped (x(R), y(z)) grid: x
     algebraic in R (rmap=acyl), y = asinh(z/h).

Conventions: real azimuthal basis Phi^{c,m}_mu = U^m_mu(R,z) cos(m phi),
Phi^{s,m}_mu = ... sin(...), with sqrt(2) for m>0 folded into U; density
partner D = 4 pi rho; biorthogonality int Phi D dV = -delta; coefficients
b = -4 pi sum_i m_i Phi(x_i).

Differences from the JAX module: in a world of several ranks rank 0 builds
(or reads its cache) and broadcasts the tables, where exp_tpu's other
processes wait for its cache file; and `h5py` is imported only by the cache
reader and writer, so a machine without it builds fresh.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from exp_tpu_torch.basis.model import SphericalModelTable
from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
from exp_tpu_torch.ops import coords


def exp_disk_density(acyl: float, hcyl: float, sech2: bool = True):
    """rho(R, z) = exp(-R/a) sech^2(z/h') / (4 pi a^2 h'), h' = h (sech2)
    -- normalized to unit total mass (the reference's expcond target)."""

    def rho(R, z):
        if sech2:
            s = 1.0 / np.cosh(z / hcyl)
            vert = s * s / (2.0 * hcyl)
        else:
            vert = np.exp(-np.abs(z) / hcyl) / (2.0 * hcyl)
        return np.exp(-R / acyl) / (2.0 * np.pi * acyl * acyl) * vert

    return rho


@dataclass
class EmpCylTables:
    """Host-side EOF disk-basis tables.

    Tables have grid axes LEADING: (numx, numy, mmax+1, nmax) -- pot (U),
    rforce (dU/dR), zforce (dU/dz), dens (4 pi rho partner).
    """

    mmax: int
    nmax: int
    numx: int
    numy: int
    acyl: float
    hcyl: float
    rcylmin: float      # in units of acyl
    rcylmax: float
    xmin: float
    xmax: float
    dx: float
    ymin: float
    ymax: float
    dy: float
    pot: np.ndarray
    rforce: np.ndarray
    zforce: np.ndarray
    dens: np.ndarray
    even_count: np.ndarray   # (mmax+1,) number of even functions per m
    key: str = ""

    # mapped coordinates: x algebraic in R (cmap1 w/ rmap=acyl), y=asinh(z/h)
    def x_of_R(self, R):
        return coords.r_to_xi(np.maximum(R, 0.0) + 1e-30, 1, self.acyl)

    def y_of_z(self, z):
        return np.arcsinh(np.asarray(z) / self.hcyl)

    def z_of_y(self, y):
        return self.hcyl * np.sinh(y)

    def R_of_x(self, x):
        return coords.xi_to_r(x, 1, self.acyl)

    def write_cache(self, path):
        import h5py

        # atomic publish: a reader never sees a half-written file
        tmp = f"{path}.tmp.{os.getpid()}"
        with h5py.File(tmp, "w") as f:
            f.attrs["type"] = "EmpCyl"
            f.attrs["version"] = 2
            for k in ("mmax", "nmax", "numx", "numy"):
                f.attrs[k] = getattr(self, k)
            for k in ("acyl", "hcyl", "rcylmin", "rcylmax", "xmin", "xmax",
                      "dx", "ymin", "ymax", "dy"):
                f.attrs[k] = getattr(self, k)
            f.attrs["key"] = self.key
            for k in ("pot", "rforce", "zforce", "dens", "even_count"):
                f.create_dataset(k, data=getattr(self, k))
        os.replace(tmp, path)

    @classmethod
    def read_cache(cls, path):
        import h5py

        with h5py.File(path, "r") as f:
            if f.attrs.get("type") != "EmpCyl" or f.attrs.get("version") != 2:
                raise ValueError(f"not an EmpCyl v2 cache: {path}")
            kw = {k: int(f.attrs[k]) for k in ("mmax", "nmax", "numx", "numy")}
            kw.update({k: float(f.attrs[k]) for k in
                       ("acyl", "hcyl", "rcylmin", "rcylmax", "xmin", "xmax",
                        "dx", "ymin", "ymax", "dy")})
            kw["key"] = str(f.attrs["key"])
            for k in ("pot", "rforce", "zforce", "dens", "even_count"):
                kw[k] = f[k][...]
        return cls(**kw)


def disk_density_from_particles(x, mass, nR: int = 48, nz: int = 24,
                                Rmax: float = None, zmax: float = None,
                                smooth: int = 0):
    """Axisymmetric rho(R, z) estimated from a particle snapshot, for
    conditioning the EOF basis on the particles themselves (the reference's
    accumulate_eof path).  Returns a callable rho(R, z), bilinear in
    log-density and clipped to the table edges; pass it as `disk_density=`
    to build_empcyl_tables."""
    x = np.asarray(x, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    live = mass > 0
    R = np.hypot(x[live, 0], x[live, 1])
    z = x[live, 2]
    m = mass[live]
    if Rmax is None:
        Rmax = np.percentile(R, 99.5)
    if zmax is None:
        zmax = np.percentile(np.abs(z), 99.5)
    # sqrt-spaced R bins resolve the inner disk, where the density (and the
    # EOF conditioning weight) is largest
    Re = np.linspace(0.0, np.sqrt(Rmax), nR + 1) ** 2
    ze = np.linspace(-zmax, zmax, nz + 1)
    H, _, _ = np.histogram2d(R, z, bins=[Re, ze], weights=m)
    Rc = 0.5 * (Re[:-1] + Re[1:])
    zc = 0.5 * (ze[:-1] + ze[1:])
    vol = (np.pi * np.diff(Re ** 2))[:, None] * np.diff(ze)[None, :]
    rho_t = H / vol
    floor = rho_t[rho_t > 0].min() * 1e-3 if (rho_t > 0).any() else 1e-300
    lg = np.log(np.maximum(rho_t, floor))
    if smooth > 1:
        # edge-padded boxcar (zero padding would bias the boundary bins)
        k = np.ones(smooth) / smooth
        half = smooth // 2

        def _boxcar(a):
            ap = np.pad(a, half, mode="edge")
            return np.convolve(ap, k, mode="same")[half:half + a.size]

        lg = np.apply_along_axis(_boxcar, 0, lg)
        lg = np.apply_along_axis(_boxcar, 1, lg)

    from scipy.interpolate import RegularGridInterpolator

    itp = RegularGridInterpolator((Rc, zc), lg, bounds_error=False,
                                  fill_value=np.log(floor))

    def rho(Rq, zq):
        Rq = np.clip(np.asarray(Rq, dtype=np.float64), Rc[0], Rc[-1])
        zq = np.clip(np.asarray(zq, dtype=np.float64), zc[0], zc[-1])
        return np.exp(itp(np.stack(np.broadcast_arrays(Rq, zq), axis=-1)))

    return rho


def build_empcyl_tables(
        mmax: int = 6, nmax: int = 18, ncylodd: int | None = None,
        lmaxfid: int = 48, nmaxfid: int = 32,
        acyl: float = 0.01, hcyl: float = 0.002,
        rcylmin: float = 1e-3, rcylmax: float = 20.0,
        numx: int = 256, numy: int = 128,
        rnum: int = 200, tnum: int = 80,
        disk_density=None, sech2: bool = True, density_key: str = None,
        cachename: str | None = None, world=None, verbose: bool = False) -> EmpCylTables:
    """Build (or load from cache) the EOF disk basis tables.

    `disk_density`: optional rho(R, z) callable conditioning the basis (e.g.
    from disk_density_from_particles); pass `density_key` to distinguish it
    in the cache key (custom densities never match the analytic cache).
    `world`: a World of several ranks builds on rank 0 only."""
    if world is not None and world.size > 1:
        # rank 0 builds (or reads its cache) and broadcasts; the others
        # never build (SLGridMP2.cc:280-382)
        kw = {k: v for k, v in locals().items() if k != "world"}
        from exp_tpu_torch.parallel.distributed import primary_build

        return primary_build(world, lambda: build_empcyl_tables(**kw))
    if ncylodd is None:
        ncylodd = nmax // 3
    if disk_density is None:
        disk_density = exp_disk_density(acyl, hcyl, sech2=sech2)
        if density_key is None:
            density_key = "analytic"
    elif density_key is None:
        # content hash of the density on a fixed probe grid
        Rp = np.geomspace(max(rcylmin * acyl, 1e-8), rcylmax * acyl, 32)
        zp = np.linspace(-5.0 * hcyl, 5.0 * hcyl, 17)
        probe = np.asarray(disk_density(Rp[:, None], zp[None, :]),
                           np.float64)
        density_key = "custom:" + hashlib.sha256(
            probe.tobytes()).hexdigest()[:16]

    params = dict(mmax=mmax, nmax=nmax, ncylodd=ncylodd, lmaxfid=lmaxfid,
                  nmaxfid=nmaxfid, acyl=acyl, hcyl=hcyl, rcylmin=rcylmin,
                  rcylmax=rcylmax, numx=numx, numy=numy, rnum=rnum, tnum=tnum,
                  sech2=sech2, density_key=density_key, version=2)
    key = hashlib.sha256(json.dumps(params, sort_keys=True).encode()
                         ).hexdigest()[:16]
    if cachename is not None:
        try:
            t = EmpCylTables.read_cache(cachename)
            if t.key == key:
                return t
        except (OSError, KeyError, ValueError):
            pass

    rmin = rcylmin * acyl
    rmax_grid = rcylmax * acyl
    rmax_sph = rmax_grid * 1.5            # corners of the (R,z) grid

    # 1. auxiliary spherical model: spherical average of the disk density
    mu_q, mu_w = np.polynomial.legendre.leggauss(64)

    def rho_sph(r):
        r = np.atleast_1d(r)
        R = r[:, None] * np.sqrt(1.0 - mu_q[None, :] ** 2)
        Z = r[:, None] * mu_q[None, :]
        return 0.5 * np.sum(disk_density(R, Z) * mu_w[None, :], axis=1) + 1e-12

    model = SphericalModelTable.from_density(rho_sph, rmin, rmax_sph,
                                             numr=1200)

    # 2. fiducial spherical SL basis
    sl = build_sph_sl_tables(model, lmax=lmaxfid, nmax=nmaxfid, numr=3000,
                             rmin=rmin, rmax=rmax_sph, cmap=1, rmap=acyl)
    if verbose:
        print(f"[empcyl] fiducial SL basis built: lmaxfid={lmaxfid} "
              f"nmaxfid={nmaxfid}")

    # quadrature grid over (r, mu): log-spaced radii + Gauss-Legendre in mu
    rq = np.geomspace(rmin, rmax_sph, rnum)
    # trapezoid weights in log r: dr = r dlnr
    dlnr = np.log(rq[1] / rq[0])
    rw = rq * dlnr
    rw[0] *= 0.5
    rw[-1] *= 0.5
    tq, tw = np.polynomial.legendre.leggauss(tnum)

    Rq = rq[:, None] * np.sqrt(1.0 - tq[None, :] ** 2)     # (rnum, tnum)
    Zq = rq[:, None] * tq[None, :]
    rho_q = disk_density(Rq, Zq)
    wq = (rw[:, None] * tw[None, :] * rq[:, None] ** 2 * rho_q).ravel()

    # fiducial basis values at quadrature nodes
    from scipy.special import sph_legendre_p_all

    theta_q = np.arccos(np.clip(tq, -1, 1))
    # Ylm-normalized P: (lmaxfid+1, 2 mmax+1, tnum) -> [l, m]
    Pq = sph_legendre_p_all(lmaxfid, mmax, theta_q)[0]

    # spherical pot/dens tables interpolated at rq: (rnum, L+1, nmaxfid)
    xi_q = coords.r_to_xi(rq, 1, acyl)
    pot_rq = _interp_rows(sl.pot_table, sl.xmin, sl.dxi, xi_q)

    pot_out = np.zeros((numx, numy, mmax + 1, nmax))
    rfo_out = np.zeros_like(pot_out)
    zfo_out = np.zeros_like(pot_out)
    den_out = np.zeros_like(pot_out)
    even_count = np.zeros(mmax + 1, dtype=np.int64)

    # output grid in mapped coordinates
    xmin = float(coords.r_to_xi(rmin, 1, acyl))
    xmax = float(coords.r_to_xi(rmax_grid, 1, acyl))
    xg = np.linspace(xmin, xmax, numx)
    Rg = np.asarray(coords.xi_to_r(xg, 1, acyl))
    ymax = float(np.arcsinh(rmax_grid / hcyl))
    yg = np.linspace(-ymax, ymax, numy)
    zg = hcyl * np.sinh(yg)

    RG, ZG = np.meshgrid(Rg, zg, indexing="ij")
    rG = np.sqrt(RG ** 2 + ZG ** 2) + 1e-30
    muG = np.clip(ZG / rG, -1 + 1e-12, 1 - 1e-12)
    thetaG = np.arccos(muG)
    # normalized P and dP/dtheta at grid nodes
    PG, dPG = _sph_legendre_and_dtheta(lmaxfid, mmax, thetaG.ravel())
    # spherical radial tables at grid nodes
    xiG = coords.r_to_xi(np.clip(rG.ravel(), rmin, rmax_sph), 1, acyl)
    potG = _interp_rows(sl.pot_table, sl.xmin, sl.dxi, xiG)
    densG = _interp_rows(sl.dens_table, sl.xmin, sl.dxi, xiG)
    dpotG = _interp_rows_deriv(sl.pot_table, sl.xmin, sl.dxi, xiG) \
        * np.asarray(coords.dxi_dr(xiG, 1, acyl))[:, None, None]

    # chain-rule geometry factors: mu = z/r, dmu/dR = -zR/r^3,
    # dtheta/dmu = -r/R  =>  dtheta/dR = z/r^2; dtheta/dz = -R/r^2
    dr_dR = (RG / rG).ravel()
    dr_dz = (ZG / rG).ravel()
    dth_dR = (ZG / rG ** 2).ravel()
    dth_dz = (-RG / rG ** 2).ravel()
    for m in range(mmax + 1):
        ls = np.arange(m, lmaxfid + 1)
        sq2 = np.sqrt(2.0) if m > 0 else 1.0
        # B over quadrature nodes: (n_l * nmaxfid, rnum*tnum)
        Pl = Pq[ls, m]                       # (n_l, tnum)
        B = np.einsum("lt,rln->lnrt", Pl, pot_rq[:, ls, :]) * sq2
        D = len(ls) * nmaxfid
        B = B.reshape(D, -1)

        # parity masks: l-m even / odd
        par = (ls - m) % 2                   # (n_l,)
        par_flat = np.repeat(par, nmaxfid)

        # Gram matrix (chunked over quadrature nodes)
        M = np.zeros((D, D))
        Q = B.shape[1]
        step = max(1, 2_000_000 // max(D, 1))
        for q0 in range(0, Q, step):
            Bc = B[:, q0:q0 + step] * wq[q0:q0 + step]
            M += Bc @ B[:, q0:q0 + step].T
        M = 0.5 * (M + M.T)

        # eigen per parity block, top counts
        nodd = ncylodd
        neven = nmax - nodd
        evecs = []
        for parity, count in ((0, neven), (1, nodd)):
            idx = np.nonzero(par_flat == parity)[0]
            if count <= 0 or idx.size == 0:
                continue
            w_, v_ = np.linalg.eigh(M[np.ix_(idx, idx)])
            order = np.argsort(w_)[::-1][:count]
            V = v_[:, order]
            # f64 re-orthonormalization (exactness of biorthogonality)
            V, _ = np.linalg.qr(V)
            full = np.zeros((D, V.shape[1]))
            full[idx] = V
            # deterministic sign: largest-magnitude entry positive
            for k in range(full.shape[1]):
                j = np.argmax(np.abs(full[:, k]))
                if full[j, k] < 0:
                    full[:, k] = -full[:, k]
            evecs.append((parity, full, w_[order]))
        # interleave by eigenvalue magnitude (even block first by power)
        blocks = []
        for parity, V, w_ in evecs:
            for k in range(V.shape[1]):
                blocks.append((w_[k], parity, V[:, k]))
        blocks.sort(key=lambda b: -b[0])
        if len(blocks) < nmax:
            raise ValueError(
                f"EOF m={m}: only {len(blocks)} eigenfunctions available "
                f"for nmax={nmax} (ncylodd={nodd}) -- the fiducial basis "
                f"l in [{m}, {lmaxfid}] has too few members of one vertical "
                f"parity; raise lmaxfid or lower nmax/ncylodd")
        E = np.stack([b[2] for b in blocks], axis=1)      # (D, nmax)
        even_count[m] = sum(1 for b in blocks if b[1] == 0)

        # tabulate on the grid: value/derivative matrices (nodes, D)
        PlG = PG[:, ls, m]
        dPlG = dPG[:, ls, m]
        # basis value at node: sq2 * P_l(theta) * pot_ln(r)
        Vv = (np.einsum("gl,gln->gln", PlG, potG[:, ls, :]) * sq2)
        Vd = (np.einsum("gl,gln->gln", PlG, densG[:, ls, :]) * sq2)
        # dU/dR = sq2 [dP dth/dR pot + P dpot dr/dR], same for z
        VdR = sq2 * (np.einsum("gl,g,gln->gln", dPlG, dth_dR, potG[:, ls, :])
                     + np.einsum("gl,gln,g->gln", PlG, dpotG[:, ls, :], dr_dR))
        Vdz = sq2 * (np.einsum("gl,g,gln->gln", dPlG, dth_dz, potG[:, ls, :])
                     + np.einsum("gl,gln,g->gln", PlG, dpotG[:, ls, :], dr_dz))
        pot_out[:, :, m, :] = (Vv.reshape(-1, D) @ E).reshape(numx, numy, nmax)
        den_out[:, :, m, :] = (Vd.reshape(-1, D) @ E).reshape(numx, numy, nmax)
        rfo_out[:, :, m, :] = (VdR.reshape(-1, D) @ E).reshape(numx, numy, nmax)
        zfo_out[:, :, m, :] = (Vdz.reshape(-1, D) @ E).reshape(numx, numy, nmax)
        if verbose:
            print(f"[empcyl] m={m}: D={D} done")

    t = EmpCylTables(
        mmax=mmax, nmax=nmax, numx=numx, numy=numy, acyl=acyl, hcyl=hcyl,
        rcylmin=rcylmin, rcylmax=rcylmax,
        xmin=xmin, xmax=xmax, dx=float(xg[1] - xg[0]),
        ymin=-ymax, ymax=ymax, dy=float(yg[1] - yg[0]),
        pot=pot_out, rforce=rfo_out, zforce=zfo_out, dens=den_out,
        even_count=even_count, key=key)
    if cachename is not None:
        t.write_cache(cachename)
    return t


def _interp_rows(table, xmin, dx, x):
    """Linear interp of (numr, L+1, nmax) table at points x -> (N, L+1, nmax)."""
    n = table.shape[0]
    tt = np.clip((x - xmin) / dx, 0, n - 1 - 1e-9)
    idx = tt.astype(np.int64)
    frac = (tt - idx)[:, None, None]
    return table[idx] * (1 - frac) + table[idx + 1] * frac


def _interp_rows_deriv(table, xmin, dx, x):
    """d/dxi of the linear interpolant."""
    n = table.shape[0]
    tt = np.clip((x - xmin) / dx, 0, n - 1 - 1e-9)
    idx = tt.astype(np.int64)
    return (table[idx + 1] - table[idx]) / dx


def _sph_legendre_and_dtheta(lmax, mmax, theta):
    """Normalized P_lm(cos th) and dP_lm/dtheta at points theta.

    Returns (P, dP) with shape (ntheta, lmax+1, mmax+1)."""
    from scipy.special import sph_legendre_p_all

    out = sph_legendre_p_all(lmax, mmax, theta, diff_n=1)
    # shape (2, lmax+1, 2*mmax+1, ntheta): [0]=P, [1]=dP/dtheta
    P = np.moveaxis(out[0][:, :mmax + 1, :], -1, 0)
    dP = np.moveaxis(out[1][:, :mmax + 1, :], -1, 0)
    return P, dP
