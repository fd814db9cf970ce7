"""Cylindrical EOF disk force (port of exp_tpu/forces/cylinder.py).

Coefficients and forces from the tabulated EOF functions U^m_n(R, z)
(basis/empcyl.py, or the flatdisk tables of basis/flatdisk.py) on the
mapped (x(R), y(z)) grid:

  coefficients: b^{c/s}_{mn} = -4 pi sum_i m_i U^m_n(R_i, z_i) cos/sin(m phi_i)
  potential:    Phi = sum_mn (b^c cos + b^s sin) U^m_n
  acceleration: F_R = -sum (b^c cos + b^s sin) dU/dR,  F_z likewise,
                F_phi = (1/R) sum m (b^c sin - b^s cos) U

Outside the table sphere r > rmax the monopole continuation
Phi ~ Phi_edge * r_edge/r is applied (the l=0 limit of the spherical
continuation, SphericalBasis.cc:1570-1633).  Coefficient layout (2, mmax+1,
nmax) [cos/sin, m, n].
"""

from __future__ import annotations

import math

import torch
from torch import nn

from exp_tpu_torch import resolve_device
from exp_tpu_torch.basis.empcyl import EmpCylTables
from exp_tpu_torch.ops import cyl_kernels as ck
from exp_tpu_torch.ops.spline import prefilter_x

PRECISIONS = ("default", "highest")


class CylinderForce(nn.Module):
    """EOF disk force; coefficient layout (2, mmax+1, nmax).

    Tables are registered buffers, so `.to(device)` moves them.

    Two evaluation backends:
      'xla'    (the default) -- plain torch: bilinear lookups into the
               full-resolution (numx, numy) tables, the fused 2-gather
               coefficient path and the 4-corner contracted-table force
               path of the JAX package's XLA backend.
      'pallas' -- the hand-written Hopper kernels K4 (coefficients) and K5
               (force), ops/cyl_kernels.py, on tables resampled onto ncx
               coarse x nodes (prefiltered quadratic B-splines for
               pallas_interp='spline', the default, or hats for 'linear');
               y keeps full resolution.  On CPU tensors their plain PyTorch
               versions run instead.

    Precision on the 'pallas' backend ('pallas_precision'): 'default' (the
    default) and 'highest' both run K4 and K5 in FP32 on the CUDA cores.
    On the TPU 'default' is one bf16 MXU pass and 'highest' 6-pass f32
    emulation; FP32 is at least as accurate as either, and the accuracy of
    this backend is set by the coarse x grid, not the precision.  The two
    small contractions (coefficients -> force table, G -> coefficients) are
    torch matmuls with TF32 off: constructing a CylinderForce on a CUDA
    device sets torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 to False.  A bf16 meaning for 'default'
    on Hopper is left to a later change that makes the kernels fast.
    """

    def __init__(self, pot_t, rfrc_t, zfrc_t, dens_t, potq_t, tab3,
                 mmax: int, nmax: int, numx: int, numy: int, acyl: float,
                 hcyl: float, xmin: float, dx: float, ymin: float, dy: float,
                 rmax_grid: float, ncx: int = 64, dxc: float = 0.0,
                 backend: str = "xla", pallas_precision: str = "default",
                 pallas_interp: str = "spline"):
        super().__init__()
        if backend not in ("xla", "pallas"):
            raise ValueError(f"backend={backend!r}: expected 'xla' or "
                             "'pallas'")
        if pallas_precision not in PRECISIONS:
            raise ValueError(f"pallas_precision={pallas_precision!r}: "
                             f"expected one of {PRECISIONS}")
        if pallas_interp not in ck.INTERPS:
            raise ValueError(f"pallas_interp={pallas_interp!r}: expected "
                             f"one of {ck.INTERPS}")
        self.register_buffer("pot_t", pot_t)     # (numx*numy, (mmax+1)*nmax)
        self.register_buffer("rfrc_t", rfrc_t)   # dU/dR
        self.register_buffer("zfrc_t", zfrc_t)   # dU/dz
        self.register_buffer("dens_t", dens_t)
        self.register_buffer("potq_t", potq_t)   # [pot | pot shifted -1 in y]
        self.register_buffer("tab3", tab3)       # coarse tables, stacked
        self.mmax, self.nmax = int(mmax), int(nmax)
        self.numx, self.numy = int(numx), int(numy)
        self.acyl, self.hcyl = float(acyl), float(hcyl)
        self.xmin, self.dx = float(xmin), float(dx)
        self.ymin, self.dy = float(ymin), float(dy)
        self.rmax_grid = float(rmax_grid)
        self.ncx, self.dxc = int(ncx), float(dxc)
        self.backend = backend
        self.pallas_precision = pallas_precision
        self.pallas_interp = pallas_interp
        if backend == "pallas" and tab3.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    @classmethod
    def from_tables(cls, t: EmpCylTables, dtype=torch.float32,
                    backend: str = "xla", ncx: int = 64,
                    pallas_precision: str = "default",
                    pallas_interp: str = "spline",
                    device=None) -> "CylinderForce":
        """Build from host tables on `device` (None: CUDA, raising when
        there is none).  The full-resolution tables are stored flat,
        (numx*numy, (mmax+1)*nmax), so a lookup is a row gather."""
        device = resolve_device(device)

        def flat(a):
            return torch.as_tensor(
                a.reshape(t.numx * t.numy, (t.mmax + 1) * t.nmax),
                dtype=dtype, device=device)

        def coarse(a):
            c = ck.resample_coarse_x(a, t.numx, ncx)
            return prefilter_x(c) if pallas_interp == "spline" else c

        potf = flat(t.pot)
        return cls(
            pot_t=potf, rfrc_t=flat(t.rforce), zfrc_t=flat(t.zforce),
            dens_t=flat(t.dens),
            potq_t=torch.cat([potf, torch.roll(potf, -1, dims=0)], dim=1),
            tab3=ck.coarse_table_stack(coarse(t.pot), coarse(t.rforce),
                                       coarse(t.zforce), device=device),
            mmax=t.mmax, nmax=t.nmax, numx=t.numx, numy=t.numy,
            acyl=t.acyl, hcyl=t.hcyl, xmin=t.xmin, dx=t.dx,
            ymin=t.ymin, dy=t.dy, rmax_grid=t.rcylmax * t.acyl,
            ncx=ncx, dxc=ck.coarse_dxc(t.numx, ncx, t.dx), backend=backend,
            pallas_precision=pallas_precision, pallas_interp=pallas_interp)

    @property
    def lmax(self):
        """Protocol metadata (coefficient writers key off it)."""
        return self.mmax

    @property
    def coef_shape(self):
        return (2, self.mmax + 1, self.nmax)

    def _kernel_params(self) -> ck.CylKernelParams:
        return ck.CylKernelParams(
            mmax=self.mmax, ncx=self.ncx, ncy=self.numy,
            acyl=self.acyl, hcyl=self.hcyl, xmin=self.xmin, dxc=self.dxc,
            ymin=self.ymin, dy=self.dy, rmax_grid=self.rmax_grid,
            interp=self.pallas_interp)

    # ------------------------------------------------------------------

    def _geometry(self, x):
        R = torch.sqrt(x[:, 0] ** 2 + x[:, 1] ** 2) + 1e-12
        phi = torch.atan2(x[:, 1], x[:, 0])
        return R, x[:, 2], phi

    def _cell(self, R, z):
        """Lower-left node index into the flat tables and the fractional
        offsets (N, 1) of the bilinear lookup."""
        xg = (R / self.acyl - 1.0) / (R / self.acyl + 1.0)
        yg = torch.asinh(z / self.hcyl)
        tx = torch.clamp((xg - self.xmin) / self.dx, 0.0, self.numx - 1.001)
        ty = torch.clamp((yg - self.ymin) / self.dy, 0.0, self.numy - 1.001)
        ix = tx.to(torch.int64)
        iy = ty.to(torch.int64)
        return (ix * self.numy + iy, (tx - ix)[:, None], (ty - iy)[:, None])

    def _bilinear_flat(self, table, R, z):
        """Bilinear interpolation of a flat (numx*numy, M*n) table
        -> (N, M*n)."""
        i00, fx, fy = self._cell(R, z)
        return (table[i00] * (1 - fx) * (1 - fy)
                + table[i00 + 1] * (1 - fx) * fy
                + table[i00 + self.numy] * fx * (1 - fy)
                + table[i00 + self.numy + 1] * fx * fy)

    def _bilinear(self, table, R, z):
        """The flat lookup as per-particle rows (N, mmax+1, nmax), read by
        analysis.diskeof; not on the force's own path."""
        v = self._bilinear_flat(table, R, z)
        return v.reshape(v.shape[0], self.mmax + 1, self.nmax)

    def _trig(self, phi, dtype):
        m = torch.arange(self.mmax + 1, dtype=dtype, device=phi.device)
        ang = phi[:, None] * m
        return torch.cos(ang), torch.sin(ang)

    # ------------------------------------------------------------------
    # Coefficients
    # ------------------------------------------------------------------

    def coefficients_local(self, x, mass, accum_dtype=torch.float32):
        """Coefficients (2, mmax+1, nmax) of particles x (N, 3) with masses
        (N,); zero-mass rows contribute nothing."""
        if self.backend == "pallas":
            G = ck.cyl_coef(x.to(torch.float32).contiguous(),
                            mass.to(torch.float32).contiguous(),
                            self._kernel_params())
            return ck.contract_coef_output(G, self.tab3).to(accum_dtype)
        R, z, phi = self._geometry(x)
        r = torch.sqrt(R * R + z * z)
        w = torch.where(r <= self.rmax_grid, mass, torch.zeros_like(mass))
        # 2-gather bilinear via the y-pair-fused table
        i00, fx, fy = self._cell(R, z)
        Fn = (self.mmax + 1) * self.nmax
        g0 = self.potq_t[i00]
        g1 = self.potq_t[i00 + self.numy]
        U = ((g0[:, :Fn] * (1 - fy) + g0[:, Fn:] * fy) * (1 - fx)
             + (g1[:, :Fn] * (1 - fy) + g1[:, Fn:] * fy) * fx)
        cosm, sinm = self._trig(phi, x.dtype)
        Wcs = torch.cat([w[:, None] * cosm, w[:, None] * sinm], dim=1)
        # one dense matmul; select the matching-m diagonal afterwards
        big = U.T.to(accum_dtype) @ Wcs.to(accum_dtype)  # (M1*nmax, 2*M1)
        big = big.reshape(self.mmax + 1, self.nmax, 2, self.mmax + 1)
        msel = torch.arange(self.mmax + 1, device=x.device)
        sel = big[msel, :, :, msel]                      # (M+1, nmax, 2)
        return -4.0 * math.pi * sel.permute(2, 0, 1)

    def coefficients(self, x, mass, accum_dtype=torch.float32):
        """Coefficients of this device's particles; on a World the caller
        sums them over the ranks (parallel.world_coefficients)."""
        return self.coefficients_local(x, mass, accum_dtype=accum_dtype)

    # ------------------------------------------------------------------
    # Acceleration / potential
    # ------------------------------------------------------------------

    def _contracted_quad(self, coef):
        """The coefficients contracted over n into the whole table first
        (the n-sum commutes with the lookup), then the four bilinear
        corners fused into one row [C(y) | C(y+1) | C(x+1,y) | C(x+1,y+1)]
        -> (numx*numy, 24 (M+1))."""
        M1, nn = self.mmax + 1, self.nmax
        eye = torch.eye(M1, dtype=coef.dtype, device=coef.device)
        # block-diagonal selectors (M1*nn, M1) for cos and sin
        Bc = (coef[0][:, :, None] * eye[:, None, :]).reshape(M1 * nn, M1)
        Bs = (coef[1][:, :, None] * eye[:, None, :]).reshape(M1 * nn, M1)
        B = torch.cat([Bc, Bs], dim=1)                   # (M1*nn, 2*M1)
        # coefficients in another dtype than the tables: promote, as jnp
        C = torch.cat([self.pot_t.to(B.dtype) @ B,
                       self.rfrc_t.to(B.dtype) @ B,
                       self.zfrc_t.to(B.dtype) @ B], dim=1)  # (G, 6*M1)
        return torch.cat([C, torch.roll(C, -1, dims=0),
                          torch.roll(C, -self.numy, dims=0),
                          torch.roll(C, -self.numy - 1, dims=0)], dim=1)

    def acceleration(self, coef, x):
        """Acceleration (N, 3) and potential (N,) at x (N, 3) from
        coefficients (2, mmax+1, nmax)."""
        dtype = x.dtype
        if self.backend == "pallas":
            prm = self._kernel_params()
            Ct = ck.contract_coef_tables(coef, self.tab3, prm.xrows, prm.ncy)
            acc, pot = ck.cyl_accel(x.to(torch.float32).contiguous(), Ct, prm)
            return acc.to(dtype), pot.to(dtype)
        coef = coef.to(dtype)
        R, z, phi = self._geometry(x)
        r = torch.sqrt(R * R + z * z) + 1e-12
        outside = r > self.rmax_grid
        # clamp the evaluation point onto the boundary sphere along r-hat
        shrink = torch.where(outside, self.rmax_grid / r, torch.ones_like(r))
        Cq = self._contracted_quad(coef)
        # fused lookup: ONE gather of the 4-corner contracted rows
        i00, fx, fy = self._cell(R * shrink, z * shrink)
        M1 = self.mmax + 1
        Fn = 6 * M1
        g = Cq[i00]
        v0 = g[:, :Fn] * (1 - fy) + g[:, Fn:2 * Fn] * fy
        v1 = g[:, 2 * Fn:3 * Fn] * (1 - fy) + g[:, 3 * Fn:] * fy
        v = v0 * (1 - fx) + v1 * fx                      # (N, 6*M1)
        cosm, sinm = self._trig(phi, dtype)

        cmn, smn = v[:, :M1], v[:, M1:2 * M1]            # U.bc, U.bs per m
        pot = torch.sum(cmn * cosm + smn * sinm, dim=1)
        FR = -(v[:, 2 * M1:3 * M1] * cosm
               + v[:, 3 * M1:4 * M1] * sinm).sum(dim=1)
        Fz = -(v[:, 4 * M1:5 * M1] * cosm
               + v[:, 5 * M1:6 * M1] * sinm).sum(dim=1)
        mvals = torch.arange(M1, dtype=dtype, device=x.device)
        Fp = torch.sum((cmn * sinm - smn * cosm) * mvals[None, :], dim=1) / R

        # monopole continuation beyond the table sphere:
        # Phi -> Phi_b * r_b/r; F_r = Phi_b r_b / r^2 toward the center
        pot_out = pot * shrink
        Fr_out = pot * shrink / r
        cphi = x[:, 0] / R
        sphi = x[:, 1] / R
        ax = torch.where(outside, Fr_out * x[:, 0] / r, FR * cphi - Fp * sphi)
        ay = torch.where(outside, Fr_out * x[:, 1] / r, FR * sphi + Fp * cphi)
        az = torch.where(outside, Fr_out * z / r, Fz)
        pot = torch.where(outside, pot_out, pot)
        return torch.stack([ax, ay, az], dim=-1), pot

    def density(self, coef, x):
        """BFE density at points x (N, 3); 0 outside the table sphere."""
        coef = coef.to(x.dtype)
        R, z, phi = self._geometry(x)
        D = self._bilinear_flat(self.dens_t, R, z)
        cosm, sinm = self._trig(phi, x.dtype)
        M1, nn = self.mmax + 1, self.nmax
        dc = (D * coef[0].reshape(-1)[None, :]).reshape(-1, M1, nn).sum(2)
        ds = (D * coef[1].reshape(-1)[None, :]).reshape(-1, M1, nn).sum(2)
        dens = torch.sum(dc * cosm + ds * sinm, dim=1) / (4.0 * math.pi)
        # vacuum outside the table sphere: the clipped lookup would plateau
        # at the boundary cell's basis density
        r = torch.sqrt(R * R + z * z)
        return torch.where(r > self.rmax_grid, torch.zeros_like(dens), dens)
