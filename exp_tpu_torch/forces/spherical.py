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
      'pallas' — the hand-written Hopper kernels of ops/sphere_kernels.py.
                 On CPU tensors their plain PyTorch versions run instead.

    The pallas kernels, chosen as exp_tpu chooses its Pallas kernels
    (`_harmonics_eff`):
      coefficients  'poly' harmonics: K1; 'recurrence': K3.  'auto' is
                    poly at lmax <= 6, else recurrence.
      force         'poly': K6; 'recurrence' and 'auto': K2.
    Each is built for lmax 0..10.
    Each runs 'spline' (numr_cs prefiltered nodes + tabulated d(pot)/dxi)
    or 'hat' (numr_c nodes, the cell difference for the derivative);
    'hat' is taken when the spline tables are absent (`_interp_eff`).  An
    lmax above 10 raises NotImplementedError: no kernel is built there.

    Precision on the 'pallas' backend ('pallas_precision'): every knob
      runs every pass in FP32 on the CUDA cores, for 'spline' and 'hat'
      alike: the sphere's Hopper kernels (K1, K2, K3, K6) use no tensor
      cores.  'mixed' (the default) and 'highest' are exp_tpu's FP32
      passes (exp_tpu runs 'hat' at HIGHEST for every precision but
      'default'); for 'default' (exp_tpu's one bf16 pass, a force error of
      p50 1.2e-3) and 'mixed3' (its 3-pass bf16 split of the force pass,
      within 2e-4 of 'mixed') the FP32 passes meet both contracts, and
      give 'mixed''s values.  A tensor-core (bf16 or TF32) meaning of the
      two is performance work.  'mixed3' with pallas_harmonics='poly'
      raises ValueError, as in exp_tpu.  For the coefficient pass FP32 is
      at least as accurate as the TPU's one-pass bf16 under 'mixed'.  The
      coefficient -> table contraction is a torch matmul with TF32 off:
      constructing a SphereSL on a CUDA device sets
      torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.
      allow_tf32 to False.
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
            if self._harmonics_eff("coef") == "poly":
                self.register_buffer("Mp", torch.as_tensor(
                    sk.poly_matrix(self.lmax, fac_np), device=dev))
            if self._harmonics_eff("accel") == "poly":
                self.register_buffer("Ms", torch.as_tensor(
                    sk.poly_matrix_stack(self.lmax, fac_np), device=dev))
            if self._interp_eff == "hat":
                self.register_buffer("tabc32", tabc.to(torch.float32)
                                     .contiguous())
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
    def coef_shape(self):
        return (2, self.lmax + 1, self.lmax + 1, self.nmax)

    @property
    def _interp_eff(self):
        """'spline' only when the spline tables exist."""
        return self.pallas_interp if self.tabc_s is not None else "hat"

    def _harmonics_eff(self, kind="coef"):
        """Angular evaluation per pass (exp_tpu's _harmonics_eff): 'auto'
        is poly for the coefficient pass while the f32 monomials hold
        (lmax <= 6) and recurrence for the force pass."""
        if self.pallas_harmonics == "auto":
            if kind == "coef":
                return "poly" if self.lmax <= 6 else "recurrence"
            return "recurrence"
        return self.pallas_harmonics

    def _check_ported(self):
        """Raise NotImplementedError for a pallas setting no Hopper kernel
        is built for: an lmax outside the selected kernels' ranges."""
        setting = (f"lmax={self.lmax} (harmonics "
                   f"'{self.pallas_harmonics}', interp '{self._interp_eff}')")
        for kind in ("coef", "accel"):
            if self._harmonics_eff(kind) == "poly":
                lr, kernels = sk.POLY_LMAX, "poly kernels K1 and K6"
            else:
                lr, kernels = sk.REC_LMAX, "recurrence kernels K3 and K2"
            if self.lmax not in lr:
                raise NotImplementedError(
                    f"backend='pallas' with {setting}: the {kernels} are "
                    f"built for lmax {lr.start}..{lr.stop - 1}")
        if self.grid.cmap not in (0, 1):
            raise NotImplementedError(
                f"backend='pallas' with cmap={self.grid.cmap}: the sphere "
                "kernels take the identity and algebraic maps only")

    def _kernel_params(self) -> sk.SphereKernelParams:
        g = self.grid
        interp = self._interp_eff
        nc = self.numr_cs if interp == "spline" else self.numr_c
        return sk.SphereKernelParams(
            lmax=self.lmax, nmax=self.nmax, nc=nc, xmin=float(g.xmin),
            dxc=float((g.dxi * (g.numr - 1)) / (nc - 1)),
            rmin=float(g.rmin), rmax=float(g.rmax), cmap=g.cmap,
            rmap=float(g.rmap), scale=self.scale, interp=interp)

    def _radial_table(self):
        """The pallas passes' radial table: tabc_s ('spline') or tabc
        ('hat')."""
        return self.tabc_s if self._interp_eff == "spline" else self.tabc32

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
            x32 = x.to(torch.float32).contiguous()
            m32 = mass.to(torch.float32).contiguous()
            prm = self._kernel_params()
            if self._harmonics_eff("coef") == "poly":
                c = sk.sphere_coef(x32, m32, self._radial_table(), self.Mp,
                                   prm)
            else:
                c = sk.sphere_coef_rec(x32, m32, self._radial_table(),
                                       self.fac32, prm)
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
        # points in another dtype than the tables: promote, as jnp does
        G = W @ self.tabc.to(W.dtype)
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
            twT = self.accel_table(coef)
            x32 = x.to(torch.float32).contiguous()
            prm = self._kernel_params()
            if self._harmonics_eff("accel") == "poly":
                acc, pot = sk.sphere_accel_poly(x32, twT, self.Ms, prm)
            else:
                acc, pot = sk.sphere_accel(x32, twT, self.fac32, prm)
            return acc.to(x.dtype), pot.to(x.dtype)
        if self.backend == "matmul" and n > ch and n % ch == 0:
            parts = [self._accel_chunk(coef, x[s:s + ch], deriv)
                     for s in range(0, n, ch)]
            return (torch.cat([a for a, _ in parts]),
                    torch.cat([p for _, p in parts]))
        return self._accel_chunk(coef, x, deriv)

    def accel_table(self, coef):
        """The pallas force kernels' table twT of coefficients (2, L+1,
        L+1, nmax): the pot and d(pot)/dxi spline tables contracted
        ('spline') or the pot table ('hat')."""
        if self._interp_eff == "spline":
            return sk.contract_coef_table2(coef, self.tabc_s, self.tabd_s,
                                           self.prows)
        return sk.contract_coef_table(coef, self.tabc32, self.prows)

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
            tabc = self.tabc.to(W.dtype)
            potd = (W @ tabc).reshape(sh)
            dpot = (dW @ tabc).reshape(sh)
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
