"""Spherical BFE force, sphereSL (port of exp_tpu/forces/spherical.py).

  coefficients:
      c[l,m,n] = -4 pi sum_i m_i fac[l,m] P_lm(cos th_i) trig(m phi_i)
                 * pot_ln(r_i/scale)
  acceleration:
      Phi = sum fac P_lm (c cos + s sin) pot_ln, its gradient in spherical
      coordinates -> Cartesian, with the vacuum multipole continuation
      (rmax/r)^(l+1) outside the table (SphericalBasis.cc:1570-1633).

Real coefficient layout: (2, lmax+1, lmax+1, nmax) indexed [cs, l, m, n],
zero for m > l.  fac[l,m] = sqrt((2l+1)/4pi (l-m)!/(l+m)!) (* sqrt2 for
m>0), unnormalized Condon-Shortley P_lm (src/SphericalBasis.cc:328-335).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from exp_tpu_torch import resolve_device
from exp_tpu_torch.basis.slgrid import SLGridSph, SphSLTables
from exp_tpu_torch.ops import coords
from exp_tpu_torch.ops import sphere_kernels as sk
from exp_tpu_torch.ops.special import (dlegendre_lm, legendre_lm,
                                       real_ylm_norm, sincos_m)

#: the pallas_* settings the pallas backend does not run yet, each with the
#: ROADMAP queue-2 item that will port the kernel it selects
_UNPORTED = {
    "harmonics=poly": "K6 (make_accel_kernel_poly, ROADMAP queue 2)",
    "harmonics=recurrence": "K3 (make_coef_kernel, ROADMAP queue 2)",
    "lmax>6": "K3 (make_coef_kernel, ROADMAP queue 2)",
    "interp=hat": "the 'hat' interpolation (K3 and the hat force pass, "
                  "ROADMAP queue 2)",
    "precision=default": "a Hopper meaning for pallas_precision='default' "
                         "(ROADMAP queue 2)",
    "precision=mixed3": "a Hopper meaning for pallas_precision='mixed3' "
                        "(ROADMAP queue 2)",
}


def _dsmall(dtype):
    """Radius floor guarding r -> 0 divisions; dtype-aware so that r^3 does
    not underflow in float32."""
    return 1.0e-16 if dtype == torch.float64 else 1.0e-10


def spline_radial_tables(pot_flat, xi_fine, ncs):
    """Spline tables for the 'spline' interp: resample the fine (numr, F)
    pot table and its d/dxi (2nd-order stencil on the fine f64 grid) onto
    ncs uniform xi nodes and prefilter both into ghost-extended quadratic
    B-spline coefficients (ncs + 2, F) f32 NumPy arrays."""
    from exp_tpu_torch.ops.spline import prefilter_x

    xi_s = np.linspace(xi_fine[0], xi_fine[-1], ncs)
    dxi_fine = float(xi_fine[1] - xi_fine[0])
    dpt = np.gradient(pot_flat, dxi_fine, axis=0, edge_order=2)
    tabs = np.empty((ncs, pot_flat.shape[1]))
    tabd = np.empty((ncs, pot_flat.shape[1]))
    for k in range(pot_flat.shape[1]):
        tabs[:, k] = np.interp(xi_s, xi_fine, pot_flat[:, k])
        tabd[:, k] = np.interp(xi_s, xi_fine, dpt[:, k])
    return prefilter_x(tabs), prefilter_x(tabd)


class SphereSL(nn.Module):
    """sphereSL force: SL basis grid + harmonics metadata.

    Tables are registered buffers, so `.to(device)` moves them.

    Three evaluation backends:
      'gather' — per-particle row gather from the full-resolution table.
      'matmul' — hat-function weight matrix against a coarse resampled
                 table (numr_c nodes), processed in particle chunks.
      'pallas' — the hand-written Hopper kernels K1 (coefficients) and K2
                 (force), ops/sphere_kernels.py, on the spline tables
                 (numr_cs nodes + tabulated d(pot)/dxi).  On CPU tensors
                 their plain PyTorch versions run instead.

    Precision on the 'pallas' backend ('pallas_precision'):
      'mixed' (the default) and 'highest' both run K1 and K2 in FP32 on the
      CUDA cores.  For the coefficient pass this is at least as accurate as
      the TPU's one-pass bf16 under 'mixed'.  The coefficient -> table
      contraction is a torch matmul with TF32 off: constructing a SphereSL
      on a CUDA device sets torch.backends.cuda.matmul.allow_tf32 and
      torch.backends.cudnn.allow_tf32 to False.
      'default' (one bf16 pass) and 'mixed3' (the 3-pass bf16 split) raise
      NotImplementedError until a Hopper meaning is given to them.

    The pallas backend runs only what is ported: 'auto' harmonics at
    lmax <= 6 and the 'spline' interpolation; 'poly', 'recurrence',
    lmax > 6 and 'hat' select kernels not ported yet and raise
    NotImplementedError rather than run K1/K2 in their place.
    """

    def __init__(self, grid: SLGridSph, fac, tabc, lmax: int, nmax: int,
                 scale: float = 1.0, backend: str = "matmul",
                 numr_c: int = 512, chunk: int = 65536, tabc_s=None,
                 tabd_s=None, numr_cs: int = 256,
                 pallas_precision: str = "mixed",
                 pallas_interp: str = "spline", pallas_harmonics: str = "auto",
                 deriv: str = "stencil3"):
        super().__init__()
        _validate(pallas_precision, pallas_harmonics)
        self.grid = grid
        self.register_buffer("fac", fac)
        self.register_buffer("tabc", tabc)
        self.register_buffer("tabc_s", tabc_s)
        self.register_buffer("tabd_s", tabd_s)
        self.lmax, self.nmax = int(lmax), int(nmax)
        self.scale = float(scale)
        self.backend = backend
        self.numr_c, self.chunk, self.numr_cs = int(numr_c), int(chunk), int(numr_cs)
        self.pallas_precision = pallas_precision
        self.pallas_interp = pallas_interp
        self.pallas_harmonics = pallas_harmonics
        self.deriv = deriv
        if backend == "pallas":
            self._check_ported()
            dev = fac.device
            fac_np = fac.detach().cpu().numpy().astype(np.float32)
            self.register_buffer(
                "fac32", torch.as_tensor(fac_np, device=dev).contiguous())
            self.register_buffer("Mp", torch.as_tensor(
                sk.poly_matrix(self.lmax, fac_np), device=dev))
            # index tensors made once: a host list turned into a CUDA
            # tensor every step would stall the host on the device
            self.register_buffer("prows", sk.packed_rows_tensor(self.lmax,
                                                                dev))
            if dev.type == "cuda":
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False

    @classmethod
    def from_tables(cls, t: SphSLTables, scale: float = 1.0,
                    dtype=torch.float32, backend: str = "matmul",
                    numr_c: int = 512, chunk: int = 65536,
                    pallas_precision: str = "mixed",
                    pallas_interp: str = "spline", numr_cs: int = 256,
                    pallas_harmonics: str = "auto",
                    deriv: str = "stencil3", device=None) -> "SphereSL":
        """Build from host tables on `device` (None: CUDA, raising when
        there is none)."""
        device = resolve_device(device)
        grid = SLGridSph.from_tables(t, dtype=dtype, device=device)
        # resample the (numr, L+1, nmax) table onto a coarse uniform xi grid
        nc = min(numr_c, t.numr)
        xi_c = np.linspace(t.xmin, t.xmax, nc)
        pt = t.pot_table.reshape(t.numr, -1)
        tabc = np.empty((nc, pt.shape[1]))
        for k in range(pt.shape[1]):
            tabc[:, k] = np.interp(xi_c, t.xi, pt[:, k])
        ncs = min(numr_cs, t.numr)
        tabc_s, tabd_s = (np.ascontiguousarray(a) for a in
                          spline_radial_tables(pt, np.asarray(t.xi), ncs))
        f32 = dict(dtype=torch.float32, device=device)
        return cls(grid=grid, fac=real_ylm_norm(t.lmax, dtype, device),
                   tabc=torch.as_tensor(tabc, dtype=dtype, device=device),
                   lmax=t.lmax, nmax=t.nmax, scale=scale, backend=backend,
                   numr_c=nc, chunk=chunk,
                   tabc_s=torch.as_tensor(tabc_s, **f32),
                   tabd_s=torch.as_tensor(tabd_s, **f32), numr_cs=ncs,
                   pallas_precision=pallas_precision,
                   pallas_interp=pallas_interp,
                   pallas_harmonics=pallas_harmonics, deriv=deriv)

    def replace(self, **changes) -> "SphereSL":
        """A new SphereSL with the named constructor fields changed (the
        counterpart of dataclasses.replace on the JAX force)."""
        kw = dict(grid=self.grid, fac=self.fac, tabc=self.tabc,
                  lmax=self.lmax, nmax=self.nmax, scale=self.scale,
                  backend=self.backend, numr_c=self.numr_c, chunk=self.chunk,
                  tabc_s=self.tabc_s, tabd_s=self.tabd_s,
                  numr_cs=self.numr_cs,
                  pallas_precision=self.pallas_precision,
                  pallas_interp=self.pallas_interp,
                  pallas_harmonics=self.pallas_harmonics, deriv=self.deriv)
        kw.update(changes)
        return SphereSL(**kw)

    @property
    def _interp_eff(self):
        """'spline' only when the spline tables exist."""
        return self.pallas_interp if self.tabc_s is not None else "hat"

    def _check_ported(self):
        """Raise NotImplementedError for a pallas setting whose kernel is
        not ported yet."""
        keys = []
        if self.pallas_harmonics in ("poly", "recurrence"):
            keys.append(f"harmonics={self.pallas_harmonics}")
        elif self.lmax > 6:
            keys.append("lmax>6")
        if self._interp_eff == "hat":
            keys.append("interp=hat")
        if self.pallas_precision in ("default", "mixed3"):
            keys.append(f"precision={self.pallas_precision}")
        if keys:
            raise NotImplementedError(
                "backend='pallas' with " + ", ".join(keys) + " needs "
                + "; ".join(_UNPORTED[k] for k in keys)
                + ", not ported to Hopper yet")
        if self.grid.cmap not in (0, 1):
            raise NotImplementedError(
                f"backend='pallas' with cmap={self.grid.cmap}: the sphere "
                "kernels take the identity and algebraic maps only")

    def _kernel_params(self) -> sk.SphereKernelParams:
        g = self.grid
        nc = self.numr_cs
        return sk.SphereKernelParams(
            lmax=self.lmax, nmax=self.nmax, nc=nc, xmin=float(g.xmin),
            dxc=float((g.dxi * (g.numr - 1)) / (nc - 1)),
            rmin=float(g.rmin), rmax=float(g.rmax), cmap=g.cmap,
            rmap=float(g.rmap), scale=self.scale)

    # -- coarse-grid helpers (matmul backend) ---------------------------

    @property
    def _dxc(self):
        g = self.grid
        return (g.xmin + g.dxi * (g.numr - 1) - g.xmin) / (self.numr_c - 1)

    def _hat_weights(self, rs, deriv=False):
        """Two-hot interpolation weights (N, numr_c) and optionally their
        xi-derivative counterpart."""
        g = self.grid
        xi = g.xi_of_r(rs)
        dxc = self._dxc
        t = torch.clamp((xi - g.xmin) / dxc, 0.0, self.numr_c - 1.0)
        j = torch.arange(self.numr_c, dtype=rs.dtype, device=rs.device)
        d = j[None, :] - t[:, None]
        W = torch.clamp(1.0 - torch.abs(d), min=0.0)
        if not deriv:
            return W, None
        # cell-based derivative: +-1/dx at the cell endpoints
        fl = torch.clamp(torch.floor(t), 0.0, self.numr_c - 2.0)
        e = j[None, :] - fl[:, None]
        dW = ((e == 1.0).to(rs.dtype) - (e == 0.0).to(rs.dtype)) / dxc
        fac = coords.dxi_dr(xi, g.cmap, g.rmap)
        return W, dW * fac[:, None]

    # ------------------------------------------------------------------
    # Coefficients
    # ------------------------------------------------------------------

    def coefficients(self, x, mass, accum_dtype=torch.float32):
        """Coefficients (2, lmax+1, lmax+1, nmax) of particles x (N, 3)
        with masses (N,); zero-mass rows contribute nothing."""
        if self.backend == "pallas":
            c = sk.sphere_coef(x.to(torch.float32).contiguous(),
                               mass.to(torch.float32).contiguous(),
                               self.tabc_s, self.Mp, self._kernel_params())
            return c.to(accum_dtype)
        if self.backend == "matmul":
            return self._chunked_sum(self._coef_chunk_matmul, x, mass,
                                     accum_dtype)
        return self._coef_chunk_gather(x, mass, accum_dtype)

    def _angular(self, x, mass):
        g = self.grid
        r = torch.sqrt(torch.sum(x * x, dim=-1)) + _dsmall(x.dtype)
        costh = x[:, 2] / r
        phi = torch.atan2(x[:, 1], x[:, 0])
        rs = r / self.scale
        # mask to the table's radial support (SphericalBasis.cc:488)
        w = torch.where((rs >= g.rmin) & (rs <= g.rmax), mass,
                        torch.zeros_like(mass))
        return r, rs, costh, phi, w

    def _coef_chunk_gather(self, x, mass, accum_dtype):
        lmax = self.lmax
        r, rs, costh, phi, w = self._angular(x, mass)
        P = legendre_lm(lmax, costh)
        cosm, sinm = sincos_m(lmax, phi)
        potd = self.grid.get_pot(rs).to(accum_dtype)
        wyc = (self.fac[None] * P * cosm[:, None, :]
               * w[:, None, None]).to(accum_dtype)
        wys = (self.fac[None] * P * sinm[:, None, :]
               * w[:, None, None]).to(accum_dtype)
        cc = torch.einsum("ilm,iln->lmn", wyc, potd)
        cs = torch.einsum("ilm,iln->lmn", wys, potd)
        return -4.0 * math.pi * torch.stack([cc, cs])

    def _coef_chunk_matmul(self, x, mass, accum_dtype):
        """Hat-weight matmul + one dense contraction (the (lm) x (l', n)
        cross terms with l' != l are computed and discarded)."""
        lmax, nmax = self.lmax, self.nmax
        nlm = (lmax + 1) * (lmax + 1)
        r, rs, costh, phi, w = self._angular(x, mass)
        P = legendre_lm(lmax, costh)
        cosm, sinm = sincos_m(lmax, phi)
        yc = (self.fac[None] * P * cosm[:, None, :]).reshape(-1, nlm)
        ys = (self.fac[None] * P * sinm[:, None, :]).reshape(-1, nlm)
        Y2 = torch.cat([yc * w[:, None], ys * w[:, None]], dim=1)
        W, _ = self._hat_weights(rs)
        G = W @ self.tabc
        big = Y2.T.to(accum_dtype) @ G.to(accum_dtype)
        big = big.reshape(2, lmax + 1, lmax + 1, lmax + 1, nmax)
        lsel = torch.arange(lmax + 1, device=x.device)
        out = torch.movedim(big[:, lsel, :, lsel, :], 0, 1)
        return -4.0 * math.pi * out

    def _chunked_sum(self, fn, x, mass, accum_dtype):
        """Apply a per-chunk reducer over particle chunks and sum (the
        whole array at once when it is not a multiple of `chunk`)."""
        n = x.shape[0]
        ch = self.chunk
        if n <= ch or n % ch != 0:
            return fn(x, mass, accum_dtype)
        parts = [fn(x[s:s + ch], mass[s:s + ch], accum_dtype)
                 for s in range(0, n, ch)]
        return torch.sum(torch.stack(parts), dim=0)

    # ------------------------------------------------------------------
    # Acceleration / potential
    # ------------------------------------------------------------------

    def acceleration(self, coef, x, deriv: str | None = None):
        """Acceleration (N, 3) and potential (N,) at x (N, 3) from
        coefficients (2, lmax+1, lmax+1, nmax).  `deriv` is the radial
        derivative mode of the gather/matmul paths (SLGridSph.get_pot_dpot);
        None uses `self.deriv`."""
        deriv = deriv if deriv is not None else self.deriv
        coef = coef.to(x.dtype)
        n = x.shape[0]
        ch = self.chunk
        if self.backend == "pallas":
            twT = sk.contract_coef_table2(coef, self.tabc_s, self.tabd_s,
                                          self.prows)
            acc, pot = sk.sphere_accel(x.to(torch.float32).contiguous(), twT,
                                       self.fac32, self._kernel_params())
            return acc.to(x.dtype), pot.to(x.dtype)
        if self.backend == "matmul" and n > ch and n % ch == 0:
            parts = [self._accel_chunk(coef, x[s:s + ch], deriv)
                     for s in range(0, n, ch)]
            return (torch.cat([a for a, _ in parts]),
                    torch.cat([p for _, p in parts]))
        return self._accel_chunk(coef, x, deriv)

    def _accel_chunk(self, coef, x, deriv="stencil3"):
        lmax = self.lmax
        g = self.grid
        dtype = x.dtype

        r = torch.sqrt(torch.sum(x * x, dim=-1)) + _dsmall(dtype)
        costh = x[:, 2] / r
        phi = torch.atan2(x[:, 1], x[:, 0])

        # clamp to the table range; outside rmax the multipole continuation
        outside = r > g.rmax * self.scale
        r_eval = torch.clamp(r, max=g.rmax * self.scale)
        # clamp below rmin too (the reference holds the boundary value)
        rs = torch.clamp(r_eval / self.scale, min=g.rmin)

        P, dP = dlegendre_lm(lmax, costh)
        cosm, sinm = sincos_m(lmax, phi)
        if self.backend == "matmul":
            W, dW = self._hat_weights(rs, deriv=True)
            sh = (x.shape[0], lmax + 1, self.nmax)
            potd = (W @ self.tabc).reshape(sh)
            dpot = (dW @ self.tabc).reshape(sh)
        else:
            potd, dpot = g.get_pot_dpot(rs, deriv=deriv)

        cc, ss = coef[0], coef[1]
        pc = torch.einsum("lmn,iln->ilm", cc, potd)
        ps = torch.einsum("lmn,iln->ilm", ss, potd)
        dpc = torch.einsum("lmn,iln->ilm", cc, dpot)
        dps = torch.einsum("lmn,iln->ilm", ss, dpot)

        # vacuum continuation for r > rmax: p *= (rmax/r)^(l+1),
        # dp = -(l+1) p / r, the derivative wrt the SCALED radius because
        # potr is divided by scale^2 below like the in-table d/d(rs)
        lvals = torch.arange(lmax + 1, dtype=dtype, device=x.device)
        att = torch.pow((g.rmax * self.scale / r)[:, None], lvals + 1.0)
        att = torch.where(outside[:, None], att, torch.ones_like(att))
        pc = pc * att[:, :, None]
        ps = ps * att[:, :, None]
        dfac_out = (-(lvals + 1.0)[None, :, None]
                    / (r / self.scale)[:, None, None])
        o3 = outside[:, None, None]
        dpc = torch.where(o3, pc * dfac_out, dpc * att[:, :, None])
        dps = torch.where(o3, ps * dfac_out, dps * att[:, :, None])

        facL = self.fac[None] * P
        facD = self.fac[None] * dP
        mvals = torch.arange(lmax + 1, dtype=dtype, device=x.device)
        cosm_b = cosm[:, None, :]
        sinm_b = sinm[:, None, :]

        potl = torch.sum(facL * (pc * cosm_b + ps * sinm_b), dim=(1, 2))
        potr = torch.sum(facL * (dpc * cosm_b + dps * sinm_b), dim=(1, 2))
        pott = torch.sum(facD * (pc * cosm_b + ps * sinm_b), dim=(1, 2))
        potp = torch.sum(facL * (ps * cosm_b - pc * sinm_b)
                         * mvals[None, None, :], dim=(1, 2))

        s = self.scale
        potr = potr / (s * s)
        potl = potl / s
        pott = pott / s
        potp = potp / s

        xx, yy, zz = x[:, 0], x[:, 1], x[:, 2]
        r3 = r * r * r
        rho2 = xx * xx + yy * yy
        ax = -(potr * xx / r - pott * xx * zz / r3)
        ay = -(potr * yy / r - pott * yy * zz / r3)
        az = -(potr * zz / r + pott * rho2 / r3)
        safe = rho2 > _dsmall(dtype)
        zero = torch.zeros_like(ax)
        ax = ax + torch.where(safe, potp * yy / rho2, zero)
        ay = ay - torch.where(safe, potp * xx / rho2, zero)
        return torch.stack([ax, ay, az], dim=-1), potl

    # ------------------------------------------------------------------
    # Field evaluation
    # ------------------------------------------------------------------

    def density(self, coef, x):
        """BFE density (physical rho) at points x (N, 3)."""
        lmax = self.lmax
        g = self.grid
        coef = coef.to(x.dtype)
        r = torch.sqrt(torch.sum(x * x, dim=-1)) + _dsmall(x.dtype)
        costh = x[:, 2] / r
        phi = torch.atan2(x[:, 1], x[:, 0])
        rs = torch.clamp(r / self.scale, g.rmin, g.rmax)
        P = legendre_lm(lmax, costh)
        cosm, sinm = sincos_m(lmax, phi)
        densd = g.get_dens(rs)
        dc = torch.einsum("lmn,iln->ilm", coef[0], densd)
        dsn = torch.einsum("lmn,iln->ilm", coef[1], densd)
        facL = self.fac[None] * P
        dens = torch.sum(facL * (dc * cosm[:, None, :]
                                 + dsn * sinm[:, None, :]), dim=(1, 2))
        # dens tables carry 4 pi rho; return physical density / scale^3
        return dens / (4.0 * math.pi) / self.scale**3


def _validate(pallas_precision, pallas_harmonics):
    """The JAX force's argument checks (forces/spherical.py:160-175)."""
    if pallas_precision not in ("default", "mixed", "mixed3", "highest"):
        raise ValueError(
            f"pallas_precision={pallas_precision!r}: expected one of "
            "'default', 'mixed', 'mixed3', 'highest'")
    if pallas_precision == "mixed3" and pallas_harmonics == "poly":
        raise ValueError(
            "pallas_precision='mixed3' is validated with the recurrence "
            "accel kernel only; use pallas_harmonics='auto'/'recurrence' "
            "with mixed3")
