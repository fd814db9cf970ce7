"""Spherical Sturm-Liouville basis tables (a jax-free copy of
exp_tpu/basis/slgrid.py: the host build, the HDF5 cache, the
biorthogonality check, and `SLGridSph` as an nn.Module of tensors).

For a background model with potential psi(r) < 0 and density rho(r), with
rt(r) = 4 pi rho(r), each harmonic l solves

    -(p u')' + q u = lambda w u,
    p = r^2 psi^2,  q = (l(l+1) psi - rt r^2) psi,  w = -rt r^2 psi

(SLGridMP2.cc:3632-3655 in the reference), with a Robin (l=0) or Dirichlet
(l>0) inner condition and the vacuum multipole condition at rmax.  The
biorthogonal pair is pot_ln = u_ln psi / sqrt(lambda_ln) and
dens_ln = u_ln rt sqrt(lambda_ln), tabulated on a uniform grid in the
mapped coordinate xi(r) (ops/coords.py).  The generalized tridiagonal
eigenproblem of a P1 finite-volume scheme is solved by shift-invert
Lanczos (scipy eigsh, sigma=0).

Differences from the JAX module: in a world of several ranks rank 0 builds
(or reads its cache) and broadcasts the tables, where exp_tpu's other
processes wait for its cache file; and `h5py` is imported only by the cache
reader and writer, so a machine without it can build tables fresh.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from exp_tpu_torch.ops import coords
from exp_tpu_torch.basis.model import SphericalModelTable

CACHE_VERSION = 2   # v2: correct inner-Dirichlet flux coupling for l>0


# ---------------------------------------------------------------------------
# Host-side build
# ---------------------------------------------------------------------------

def _solve_sl_one_l(l: int, xi: np.ndarray, r: np.ndarray, rp: np.ndarray,
                    psi: np.ndarray, dpsi: np.ndarray, rt: np.ndarray,
                    nmax: int):
    """Solve the SL problem for one l on the xi grid.

    Args:
      xi: uniform mapped grid (numr,); r = r(xi); rp = dr/dxi at nodes.
      psi, dpsi: background potential and its r-derivative at nodes.
      rt: 4 pi rho at nodes.

    Returns (ev (nmax,), ef (nmax, numr)) with int u^2 w dr = 1.
    """
    numr = xi.size
    h = xi[1] - xi[0]

    p = r**2 * psi**2
    q = (l * (l + 1) * psi - rt * r**2) * psi
    w = -rt * r**2 * psi
    # Guard against zero-density regions (truncated models): the SL weight
    # must stay positive for the symmetric reduction.
    wfloor = max(w.max() * 1e-14, 1e-300)
    w = np.maximum(w, wfloor)

    # transform to xi:  -(pt u')' + qt u = lambda wt u   with ' = d/dxi
    pt = p / rp
    qt = q * rp
    wt = w * rp

    dirichlet_inner = l > 0
    j0 = 1 if dirichlet_inner else 0
    idx = np.arange(j0, numr)
    n = idx.size

    # half-point pt values between consecutive retained nodes
    ph = 0.5 * (pt[idx[:-1]] + pt[idx[1:]])

    # cell measures (half cells at the boundary NODES of the reduced
    # problem; under inner Dirichlet the first retained node is interior)
    cell = np.full(n, h)
    cell[-1] = 0.5 * h
    if not dirichlet_inner:
        cell[0] = 0.5 * h

    diag = np.zeros(n)
    diag[1:] += ph / h
    diag[:-1] += ph / h
    diag += qt[idx] * cell
    off = -ph / h

    if dirichlet_inner:
        # eliminated u(node0) = 0 (the reference's sledge cons[0]=1.0
        # Dirichlet, SLGridMP2.cc): the first retained node keeps its
        # left-face flux coupling to the zero boundary value — without it
        # the reduced problem silently imposes Neumann at node 1 and the
        # stored table jumps from ef[:,0]=0 to a finite value across the
        # first cell
        diag[0] += 0.5 * (pt[0] + pt[1]) / h

    # Robin terms: (p u')(a) = (A1/A2) u(a);  (p u')(b) = -(B1/B2) u(b)
    if not dirichlet_inner:
        a = r[0]
        diag[0] += p[0] * dpsi[0] / psi[0]          # A1/A2 = p(a) psi'/psi
    b = r[-1]
    diag[-1] += p[-1] * ((l + 1.0) / b + dpsi[-1] / psi[-1])

    # diagonal mass matrix M = diag(wt * cell)
    m = wt[idx] * cell

    # Solve the generalized problem A u = lambda W u by shift-invert Lanczos
    # (scipy eigsh with sigma=0).  The naive symmetric reduction by
    # sqrt(W) fails when the model density spans many decades (the matrix
    # norm blows up as 1/w_min and eigenvalues near 1 drown in roundoff —
    # e.g. truncated disk models); shift-invert keeps full relative
    # precision for the smallest eigenvalues.  Non-positive eigenvalues
    # (spurious boundary modes from the negative l=0 Robin term) are
    # dropped.
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh

    nloc = len(diag)
    A = sp.diags([off, diag, off], [-1, 0, 1], format="csc")
    W = sp.diags(m)
    k = min(nmax + 4, nloc - 2)
    # a fixed start vector: ARPACK's own random start advances from call to
    # call, so the same tables built twice in one process differed in their
    # last bits (~1e-13), and so did runs that must agree bit for bit
    v0 = np.random.default_rng(0).standard_normal(nloc)
    try:
        ev, y = eigsh(A, k=k, M=W, sigma=0.0, which="LM", v0=v0)
    except RuntimeError:
        # fallback: tiny negative shift if A is exactly singular at 0
        ev, y = eigsh(A, k=k, M=W, sigma=-1e-8, which="LM", v0=v0)
    order = np.argsort(ev)
    ev, y = ev[order], y[:, order]
    pos = ev > 0.0
    if pos.sum() < nmax:
        raise RuntimeError(
            f"SL solve l={l}: only {int(pos.sum())} positive eigenvalues "
            f"for nmax={nmax}")
    ev = ev[pos][:nmax]
    y = y[:, pos][:, :nmax]
    # eigsh M-normalizes: u^T W u = 1 already (W includes the cell measure)
    u = y.T                                          # (nmax, n)

    ef = np.zeros((nmax, numr))
    ef[:, j0:] = u

    # deterministic sign convention: ef > 0 at its global max magnitude
    for k in range(nmax):
        j = np.argmax(np.abs(ef[k]))
        if ef[k, j] < 0:
            ef[k] = -ef[k]

    return ev, ef


@dataclass
class SphSLTables:
    """Host-side spherical SL basis tables (NumPy)."""

    lmax: int
    nmax: int
    numr: int
    cmap: int
    rmap: float
    rmin: float
    rmax: float
    xmin: float
    xmax: float
    dxi: float
    xi: np.ndarray        # (numr,)
    r: np.ndarray         # (numr,)
    p0: np.ndarray        # background potential psi at nodes (numr,)
    d0: np.ndarray        # 4 pi rho at nodes (numr,)
    ev: np.ndarray        # (lmax+1, nmax)
    ef: np.ndarray        # (lmax+1, nmax, numr)
    model_key: str = ""

    # Combined evaluation tables (grid index leading for device gathers):
    #   pot_t[j, l, n]  = ef[l,n,j] p0[j] / sqrt(ev[l,n])
    #   dens_t[j, l, n] = ef[l,n,j] d0[j] * sqrt(ev[l,n])
    @property
    def pot_table(self) -> np.ndarray:
        sq = np.sqrt(self.ev)                                # (L+1, nmax)
        t = np.einsum("lnj,j->jln", self.ef, self.p0)
        return t / sq[None, :, :]

    @property
    def dens_table(self) -> np.ndarray:
        sq = np.sqrt(self.ev)
        t = np.einsum("lnj,j->jln", self.ef, self.d0)
        return t * sq[None, :, :]

    # -- HDF5 cache ---------------------------------------------------------

    def write_cache(self, path):
        import h5py

        with h5py.File(path, "w") as f:
            f.attrs["cache_version"] = CACHE_VERSION
            f.attrs["type"] = "SphSL"
            for k in ("lmax", "nmax", "numr", "cmap"):
                f.attrs[k] = getattr(self, k)
            for k in ("rmap", "rmin", "rmax", "xmin", "xmax", "dxi"):
                f.attrs[k] = getattr(self, k)
            f.attrs["model_key"] = self.model_key
            for k in ("xi", "r", "p0", "d0", "ev", "ef"):
                f.create_dataset(k, data=getattr(self, k))

    @classmethod
    def read_cache(cls, path):
        import h5py

        with h5py.File(path, "r") as f:
            if f.attrs.get("cache_version") != CACHE_VERSION:
                raise ValueError(f"stale cache version in {path}")
            kw = {k: int(f.attrs[k]) for k in ("lmax", "nmax", "numr", "cmap")}
            kw.update({k: float(f.attrs[k])
                       for k in ("rmap", "rmin", "rmax", "xmin", "xmax", "dxi")})
            kw["model_key"] = str(f.attrs["model_key"])
            for k in ("xi", "r", "p0", "d0", "ev", "ef"):
                kw[k] = f[k][...]
        return cls(**kw)


def model_fingerprint(model: SphericalModelTable, **params) -> str:
    h = hashlib.sha256()
    for a in (model.r, model.rho, model.mass, model.pot):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(json.dumps(params, sort_keys=True).encode())
    return h.hexdigest()[:16]


def build_sph_sl_tables(model: SphericalModelTable, lmax: int, nmax: int,
                        numr: int = 2000, rmin: float | None = None,
                        rmax: float | None = None, cmap: int = 1,
                        rmap: float = 0.067,
                        cachename: str | None = None,
                        world=None) -> SphSLTables:
    """Build (or load from cache) the spherical SL basis tables.  `world`:
    a World of several ranks builds on rank 0 only."""
    if world is not None and world.size > 1:
        # rank 0 builds (or reads its cache) and broadcasts; the others
        # never build (SLGridMP2.cc:280-382)
        kw = {k: v for k, v in locals().items() if k != "world"}
        from exp_tpu_torch.parallel.distributed import primary_build

        return primary_build(world, lambda: build_sph_sl_tables(**kw))
    rmin = model.rmin if rmin is None else max(rmin, model.rmin)
    rmax = model.rmax if rmax is None else min(rmax, model.rmax)
    if cmap == 2 and rmin <= 0:
        raise ValueError("cmap=2 (log) requires rmin > 0")

    key = model_fingerprint(model, lmax=lmax, nmax=nmax, numr=numr,
                            rmin=rmin, rmax=rmax, cmap=cmap, rmap=rmap,
                            version=CACHE_VERSION)
    if cachename is not None:
        try:
            t = SphSLTables.read_cache(cachename)
            if t.model_key == key:
                return t
        except (OSError, KeyError, ValueError):
            pass
    t = _build_sph_sl_tables_nocache(model, lmax, nmax, numr, rmin, rmax,
                                     cmap, rmap, key)
    if cachename is not None:
        t.write_cache(cachename)
    return t


def _build_sph_sl_tables_nocache(model, lmax, nmax, numr, rmin, rmax,
                                 cmap, rmap, key) -> SphSLTables:
    xmin = float(coords.r_to_xi(rmin, cmap, rmap))
    xmax = float(coords.r_to_xi(rmax, cmap, rmap))
    xi = np.linspace(xmin, xmax, numr)
    dxi = xi[1] - xi[0]
    r = np.asarray(coords.xi_to_r(xi, cmap, rmap))
    rp = 1.0 / np.asarray(coords.dxi_dr(xi, cmap, rmap))    # dr/dxi

    psi = model.get_pot(r)
    dpsi = model.get_dpot(r)
    d0 = 4.0 * np.pi * model.get_density(r)

    ev = np.zeros((lmax + 1, nmax))
    ef = np.zeros((lmax + 1, nmax, numr))
    for l in range(lmax + 1):
        ev[l], ef[l] = _solve_sl_one_l(l, xi, r, rp, psi, dpsi, d0, nmax)

    return SphSLTables(lmax=lmax, nmax=nmax, numr=numr, cmap=cmap,
                       rmap=rmap, rmin=rmin, rmax=rmax, xmin=xmin,
                       xmax=xmax, dxi=float(dxi), xi=xi, r=r, p0=psi,
                       d0=d0, ev=ev, ef=ef, model_key=key)


def biorthogonality_matrix(t: SphSLTables, l: int) -> np.ndarray:
    """int pot_ln dens_ln' r^2 dr for one l — should be -I.

    The analogue of the reference's orthoTest self-check
    (exputil/orthoTest.cc, libvars orthoTol).
    """
    rp = 1.0 / np.asarray(coords.dxi_dr(t.xi, t.cmap, t.rmap))
    wq = np.full(t.numr, t.dxi)
    wq[0] = wq[-1] = 0.5 * t.dxi
    pot = t.pot_table[:, l, :]      # (numr, nmax)
    dens = t.dens_table[:, l, :]
    return np.einsum("jn,jm,j->nm", pot, dens, t.r**2 * rp * wq)


# ---------------------------------------------------------------------------
# Tensor bundle
# ---------------------------------------------------------------------------

class SLGridSph(nn.Module):
    """Spherical SL basis as tensors: combined tables + grid metadata.

    pot_t/dens_t are registered buffers with the grid index LEADING,
    (numr, lmax+1, nmax), so a per-particle lookup is a row gather.
    """

    def __init__(self, pot_t, dens_t, lmax, nmax, numr, cmap, rmap, xmin,
                 dxi, rmin, rmax):
        super().__init__()
        self.register_buffer("pot_t", pot_t)
        self.register_buffer("dens_t", dens_t)
        self.lmax, self.nmax, self.numr = int(lmax), int(nmax), int(numr)
        self.cmap = int(cmap)
        self.rmap, self.xmin, self.dxi = float(rmap), float(xmin), float(dxi)
        self.rmin, self.rmax = float(rmin), float(rmax)

    @classmethod
    def from_tables(cls, t: SphSLTables, dtype=torch.float32,
                    device="cpu") -> "SLGridSph":
        def tens(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(tens(t.pot_table), tens(t.dens_table), t.lmax, t.nmax,
                   t.numr, t.cmap, t.rmap, t.xmin, t.dxi, t.rmin, t.rmax)

    @classmethod
    def from_raw(cls, pot_table, dens_table, rmin, rmax, cmap=1, rmap=1.0,
                 dtype=torch.float32, device="cpu") -> "SLGridSph":
        """Build directly from (numr, lmax+1, nmax) pot/dens tables, for
        the analytic bases (Bessel, Clutton-Brock, Hernquist) that do not
        go through the SL solve."""
        numr, lp1, nmax = pot_table.shape
        xmin = float(coords.r_to_xi(rmin, cmap, rmap))
        xmax = float(coords.r_to_xi(rmax, cmap, rmap))

        def tens(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(tens(pot_table), tens(dens_table), lp1 - 1, nmax, numr,
                   cmap, float(rmap), xmin, (xmax - xmin) / (numr - 1),
                   float(rmin), float(rmax))

    def xi_of_r(self, r):
        return coords.r_to_xi(r, self.cmap, self.rmap)

    def get_pot(self, r):
        """pot_ln(r): (N,) -> (N, lmax+1, nmax)."""
        from exp_tpu_torch.ops.interp import lerp_uniform
        return lerp_uniform(self.pot_t, self.xi_of_r(r), self.xmin, self.dxi)

    def get_dens(self, r):
        from exp_tpu_torch.ops.interp import lerp_uniform
        return lerp_uniform(self.dens_t, self.xi_of_r(r), self.xmin,
                            self.dxi)

    def get_pot_dpot(self, r, deriv: str = "stencil3"):
        """pot and d(pot)/dr, each (N, lmax+1, nmax).

        deriv='stencil3' is the reference's 3-point stencil
        (SLGridMP2.cc:838-870); deriv='lerp' the exact derivative of the
        linear interpolant."""
        from exp_tpu_torch.ops.interp import (lerp_and_deriv3, lerp_uniform,
                                              uniform_index)
        xi = self.xi_of_r(r)
        if deriv == "lerp":
            val = lerp_uniform(self.pot_t, xi, self.xmin, self.dxi)
            idx, _ = uniform_index(xi, self.xmin, self.dxi, self.numr)
            dxi_deriv = (self.pot_t[idx + 1] - self.pot_t[idx]) / self.dxi
        else:
            val, dxi_deriv = lerp_and_deriv3(self.pot_t, xi, self.xmin,
                                             self.dxi)
        fac = coords.dxi_dr(xi, self.cmap, self.rmap)
        return val, dxi_deriv * fac[:, None, None]
