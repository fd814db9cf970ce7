"""Slab force: periodic (x, y) plane waves x tabulated z functions (port of
exp_tpu/forces/slab.py).

Companion of basis/slab.py, the reference's SlabSL force path
(src/SlabSL.cc coefficient/force loops, cudaSlabSL.cu):

  a_{kx ky n} = -4 pi s_n sum_i m_i e^{-2 pi i (kx x + ky y)} phi^{|k|}_n(z_i)
  Phi(x)      = Re sum a e^{+2 pi i k.x} phi_n(z)

with s_n the tables' pairing signs and the mass masked to |z| <= zmax.
Horizontal accelerations via the 2 pi i k factors (like the cube force),
vertical via the tabulated dphi/dz; beyond |z| = zmax the vacuum
continuation of the boundary values.  The tables depend on |kx|, |ky|
only; the coefficients are a complex (2 nmaxx + 1, 2 nmaxy + 1, nmax)
tensor over signed k.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from exp_tpu_torch import resolve_device
from exp_tpu_torch.basis.slab import SlabTables
from exp_tpu_torch.ops import slab_kernels as sk
from exp_tpu_torch.ops.spline import prefilter_x


def _cdtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


class SlabForce(nn.Module):
    """Slab force; coefficients (2 nmaxx + 1, 2 nmaxy + 1, nmax) complex.

    The tables are registered buffers, so `.to(device)` moves them:
    phi_t, dphi_t, dens_t (numz, nmaxx + 1, nmaxy + 1, nmax) at full
    resolution, sgn (2 nmaxx + 1, 2 nmaxy + 1, nmax) the pairing signs over
    signed k, and phi_s, dphi_s (zrows, 2 nmaxx + 1, 2 nmaxy + 1, nmax) f32
    the coarse signed tables of the kernels.

    Two evaluation backends:
      'einsum' (the default) -- plain torch: the full-resolution tables
               hat-interpolated at each particle (t clipped at numz - 1.001)
               and complex einsums over (N, Kx, Ky, nmax) intermediates, as
               the JAX package's XLA path.  As there, the coefficients wrap
               x, y into the unit box and the force does not (the phases of
               unwrapped positions are periodic up to f32 rounding of the
               angle).
      'pallas' -- the hand-written Hopper kernels, ops/slab_kernels.py:
               `slab_coef` (K9) for the coefficients and `slab_accel` (K10)
               for the force, on the z-tables resampled onto nzc coarse
               nodes (prefiltered quadratic B-splines for
               pallas_interp='spline', the default, or hats for 'linear'),
               t clipped at nzc - 1.  On CPU tensors their plain PyTorch
               versions run instead.

    Precision: SlabForce has no precision knob.  On the TPU K9's
    contraction is one bf16 pass and K10's z interpolation and phase outer
    product are compensated bf16 splits; here both kernels run in FP32 on
    the CUDA cores, more accurate than either.  The torch products in the
    glue (G -> coefficients, coefficients -> force table) and the einsum
    backend run with TF32 off: constructing a SlabForce on a CUDA device
    sets torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 to False.
    """

    def __init__(self, phi_t, dphi_t, dens_t, sgn, phi_s, dphi_s,
                 nmaxx: int, nmaxy: int, nmax: int, numz: int, zmax: float,
                 nzc: int = 126, backend: str = "einsum",
                 pallas_interp: str = "spline"):
        super().__init__()
        if backend not in ("einsum", "pallas"):
            raise ValueError(f"backend={backend!r}: expected 'einsum' or "
                             "'pallas'")
        if pallas_interp not in sk.INTERPS:
            raise ValueError(f"pallas_interp={pallas_interp!r}: expected one "
                             f"of {sk.INTERPS}")
        self.register_buffer("phi_t", phi_t)
        self.register_buffer("dphi_t", dphi_t)
        self.register_buffer("dens_t", dens_t)
        self.register_buffer("sgn", sgn)
        self.register_buffer("phi_s", phi_s)
        self.register_buffer("dphi_s", dphi_s)
        # the kernels' operands that do not change between steps
        self.register_buffer("zq_s", sk.z_profile_tables(phi_s, dphi_s,
                                                         pallas_interp))
        self.register_buffer("bnd_s", sk.boundary_rows(phi_t, dphi_t))
        self.nmaxx, self.nmaxy, self.nmax = int(nmaxx), int(nmaxy), int(nmax)
        self.numz, self.zmax = int(numz), float(zmax)
        self.nzc = int(nzc)
        self.backend = backend
        self.pallas_interp = pallas_interp
        if backend == "pallas":
            sk.check_params(self._kernel_params())
        if phi_t.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    @classmethod
    def from_tables(cls, t: SlabTables, dtype=torch.float32,
                    backend: str = "einsum", nzc: int = 126,
                    pallas_interp: str = "spline", device=None) -> "SlabForce":
        """Build from host tables on `device` (None: CUDA, raising when
        there is none): the pairing signs mirrored to signed k, the z-tables
        resampled onto nzc = min(nzc, numz) nodes, prefiltered for 'spline',
        and mirrored to signed k."""
        device = resolve_device(device)
        nzc = min(nzc, t.numz)
        phi_c = sk.resample_z(t.phi, t.numz, nzc)
        dphi_c = sk.resample_z(t.dphi, t.numz, nzc)
        if pallas_interp == "spline":
            phi_c = prefilter_x(phi_c)
            dphi_c = prefilter_x(dphi_c)

        def buf(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        return cls(phi_t=buf(t.phi), dphi_t=buf(t.dphi), dens_t=buf(t.dens),
                   sgn=sk.signed_k(buf(t.sgn)),
                   phi_s=sk.signed_k(buf(phi_c, torch.float32)),
                   dphi_s=sk.signed_k(buf(dphi_c, torch.float32)),
                   nmaxx=t.nmaxx, nmaxy=t.nmaxy, nmax=t.nmax, numz=t.numz,
                   zmax=t.zmax, nzc=nzc, backend=backend,
                   pallas_interp=pallas_interp)

    @property
    def lmax(self):
        return max(self.nmaxx, self.nmaxy)

    @property
    def coef_shape(self):
        return (2 * self.nmaxx + 1, 2 * self.nmaxy + 1, self.nmax)

    def _kernel_params(self) -> sk.SlabKernelParams:
        return sk.SlabKernelParams(self.nmaxx, self.nmaxy, self.nzc,
                                   self.zmax, self.pallas_interp)

    def _phases(self, x, sign):
        """e^{sign 2 pi i n x_c} for c = x, y; n = -nmax..nmax."""
        cd = _cdtype(x.dtype)
        out = []
        for c, nmax in ((0, self.nmaxx), (1, self.nmaxy)):
            n = torch.arange(-nmax, nmax + 1, dtype=x.dtype, device=x.device)
            ang = sign * 2.0 * math.pi * x[:, c:c + 1] * n[None, :]
            out.append(torch.complex(torch.cos(ang), torch.sin(ang)).to(cd))
        return out

    def _ztab(self, table, z):
        """Hat-interpolate (numz, nx+1, ny+1, nmax) tables at z and expand to
        the signed-k layout (N, 2nx+1, 2ny+1, nmax) by |k| symmetry."""
        dz = 2.0 * self.zmax / (self.numz - 1)
        tt = torch.clamp((z + self.zmax) / dz, 0.0, self.numz - 1.001)
        iz = tt.to(torch.int64)
        fz = (tt - iz.to(tt.dtype))[:, None, None, None]
        v = table[iz] * (1 - fz) + table[iz + 1] * fz
        return sk.signed_k(v)

    # ------------------------------------------------------------------
    # Coefficients
    # ------------------------------------------------------------------

    def coefficients_local(self, x, mass, accum_dtype=torch.float32):
        """a_k of particles x (N, 3) with masses (N,): complex64 (complex128
        for accum_dtype float64 on the einsum backend; the pallas backend
        gives complex64)."""
        if self.backend == "pallas":
            G = sk.slab_coef(x.to(torch.float32).contiguous(),
                             mass.to(torch.float32).contiguous(),
                             self._kernel_params())
            return sk.contract_coef_output(G, self.phi_s, self.sgn)
        xw = torch.remainder(x[:, :2], 1.0)
        z = x[:, 2]
        w = torch.where(torch.abs(z) <= self.zmax, mass,
                        torch.zeros_like(mass)).to(x.dtype)
        ex, ey = self._phases(xw, sign=-1.0)
        cd = _cdtype(accum_dtype)
        phi = self._ztab(self.phi_t, z)                 # (N, A, B, n) real
        t1 = torch.einsum("ia,ib->iab", ex * w[:, None], ey)
        coef = torch.einsum("iab,iabn->abn", t1.to(cd), phi.to(cd))
        return -4.0 * math.pi * coef * self.sgn.to(cd)

    def coefficients(self, x, mass, accum_dtype=torch.float32):
        """Coefficients on this device; the all-reduce across devices comes
        with the multi-device slice."""
        return self.coefficients_local(x, mass, accum_dtype=accum_dtype)

    # ------------------------------------------------------------------
    # Acceleration / potential
    # ------------------------------------------------------------------

    def _outside_continuation(self, coef, x, acc, pot):
        """Replace the clamped boundary evaluation for |z| > zmax with the
        vacuum solution: each k != 0 mode decays as e^{-2 pi |k| (|z| -
        zmax)} off its boundary value and the k = 0 plane-sheet mode
        continues linearly (constant F_z)."""
        dtype = x.dtype
        cd = _cdtype(dtype)
        dev = x.device
        z = x[:, 2]
        outside = torch.abs(z) > self.zmax
        dz = torch.clamp(torch.abs(z) - self.zmax, min=0.0)
        cf = coef.to(cd)
        A, B = 2 * self.nmaxx + 1, 2 * self.nmaxy + 1
        rows = self.bnd_s.reshape(4, A, B, -1).to(cd)
        Tb = torch.einsum("abn,qabn->qab", cf, rows[:2])   # top, bottom
        Td = torch.einsum("abn,qabn->qab", cf, rows[2:])
        top = (z >= 0)[:, None, None]
        Ti = torch.where(top, Tb[0][None], Tb[1][None])
        Tdi = torch.where(top, Td[0][None], Td[1][None])

        kx = torch.arange(-self.nmaxx, self.nmaxx + 1, dtype=dtype, device=dev)
        ky = torch.arange(-self.nmaxy, self.nmaxy + 1, dtype=dtype, device=dev)
        tpi = 2.0 * math.pi
        kmag = torch.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
        att = torch.exp(-tpi * kmag[None] * dz[:, None, None])
        ex, ey = self._phases(x, sign=+1.0)
        E = ex[:, :, None] * ey[:, None, :] * att.to(cd)

        TiE = Ti * E
        k0 = (kmag == 0.0)[None]
        zero = torch.zeros((), dtype=cd, device=dev)
        pot_o = torch.real(torch.sum(TiE, dim=(1, 2)))
        # k = 0: linear potential continuation off the boundary value
        pot_o = pot_o + torch.real(torch.sum(
            torch.where(k0, Tdi * E, zero), dim=(1, 2))
        ) * (torch.abs(z) - self.zmax) * torch.sign(z)
        ax_o = torch.imag(torch.sum(TiE * (tpi * kx)[None, :, None],
                                    dim=(1, 2)))
        ay_o = torch.imag(torch.sum(TiE * (tpi * ky)[None, None, :],
                                    dim=(1, 2)))
        # k > 0: dPhi/dz = -sign(z) 2 pi |k| Phi; k = 0: boundary F_z
        azT = torch.where(k0, -Tdi * E,
                          torch.sign(z)[:, None, None]
                          * (tpi * kmag)[None] * TiE)
        az_o = torch.real(torch.sum(azT, dim=(1, 2)))
        acc_o = torch.stack([ax_o, ay_o, az_o], dim=-1).to(dtype)
        acc = torch.where(outside[:, None], acc_o, acc)
        pot = torch.where(outside, pot_o.to(dtype), pot)
        return acc, pot

    def acceleration(self, coef, x):
        """Acceleration (N, 3) and potential (N,) at x (N, 3) from the
        coefficient tensor."""
        dtype = x.dtype
        cd = _cdtype(dtype)
        coef = coef.to(cd)
        if self.backend == "pallas":
            prm = self._kernel_params()
            tab = sk.slab_force_table(coef, self.zq_s, prm)
            aux = sk.slab_force_aux(coef, self.bnd_s, prm)
            acc, pot = sk.slab_accel(x.to(torch.float32).contiguous(), tab,
                                     aux, prm)
            return acc.to(dtype), pot.to(dtype)
        z = torch.clamp(x[:, 2], -self.zmax, self.zmax)
        ex, ey = self._phases(x, sign=+1.0)
        phi = self._ztab(self.phi_t, z).to(cd)
        dphi = self._ztab(self.dphi_t, z).to(cd)
        # the n-contraction first: T, Tz (N, A, B) feed pot, ax, ay, az
        T = torch.einsum("abn,iabn->iab", coef, phi)
        Tz = torch.einsum("abn,iabn->iab", coef, dphi)
        E = ex[:, :, None] * ey[:, None, :]
        TE = T * E
        pot = torch.sum(TE, dim=(1, 2)).real.to(dtype)
        dev = x.device
        kx = torch.arange(-self.nmaxx, self.nmaxx + 1, dtype=dtype, device=dev)
        ky = torch.arange(-self.nmaxy, self.nmaxy + 1, dtype=dtype, device=dev)
        tpi = 2.0 * math.pi
        ax = torch.imag(torch.sum(TE * (tpi * kx).to(cd)[None, :, None],
                                  dim=(1, 2)))
        ay = torch.imag(torch.sum(TE * (tpi * ky).to(cd)[None, None, :],
                                  dim=(1, 2)))
        az = -torch.real(torch.sum(Tz * E, dim=(1, 2)))
        acc = torch.stack([ax.to(dtype), ay.to(dtype), az.to(dtype)], dim=-1)
        return self._outside_continuation(coef, x, acc, pot)

    def density(self, coef, x):
        """BFE density at x (N, 3) from the tabulated density partners."""
        cd = _cdtype(x.dtype)
        coef = coef.to(cd)
        z = torch.clamp(x[:, 2], -self.zmax, self.zmax)
        ex, ey = self._phases(x, sign=+1.0)
        dens = self._ztab(self.dens_t, z).to(cd)
        out = torch.einsum("abn,ia,ib,iabn->i", coef, ex, ey, dens)
        return out.real.to(x.dtype) / (4.0 * math.pi)
