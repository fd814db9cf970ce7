"""Triply-periodic plane-wave (cube) BFE force (port of
exp_tpu/forces/cube.py).

Gravitational field on the unit box [0,1]^3 expanded in plane waves
exp(2 pi i k.x), k = (kx, ky, kz), |k_c| <= nmax_c per axis (the reference's
src/Cube.cc, cudaCube.cu).  Basis pair (G=1):

    Phi_k = norm_k e^{2 pi i k.x},   4 pi rho_k = -|2 pi k|^2 Phi_k,

norm_k = 1/sqrt(pi |k|^2), k=0 excluded (the uniform-background swindle),
optional minimum wavenumber nmin per axis.

    coefficients:  a_k = - sum_i m_i norm_k e^{-2 pi i k.x_i}
    potential:     Phi(x) = Re sum_k a_k norm_k e^{+2 pi i k.x}
    acceleration:  acc(x) = -Re sum_k (2 pi i k) a_k norm_k e^{+2 pi i k.x}

Positions are wrapped mod 1 inside the evaluation (floor-based); the state
keeps them unwrapped.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from exp_tpu_torch import resolve_device
from exp_tpu_torch.ops import cube_kernels as ck

PRECISIONS = ("mixed", "highest", "default")
VERSIONS = (1, 2)


def _cdtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


class Cube(nn.Module):
    """Plane-wave cube force; coefficients are a complex (2 nmaxx + 1,
    2 nmaxy + 1, 2 nmaxz + 1) tensor with axis layout -nmax..nmax.

    `norm` (norm_k with the k = 0 and nmin masks folded in) and `lap`
    (|2 pi k|^2) are registered buffers, so `.to(device)` moves them.

    Two evaluation backends:
      'einsum' (the default) -- plain torch: per-axis phase rows, their
               outer products and complex einsums, as the JAX package's XLA
               path (its (N, Kx, Ky) complex intermediates take 5.7 GB in
               complex64 at 4,194,304 particles and nmax = 6).
      'pallas' -- the hand-written Hopper kernels, ops/cube_kernels.py:
               `cube_coef` (K7; K11a) for the coefficients and `cube_accel`
               (K8) for the force.  pallas_version 2 (the default) hands K8
               the folded table built from b = coef norm directly;
               pallas_version 1 packs b as the TPU's v1 kernel took it,
               (R_re, R_im), and runs K8 through `cube_accel_v1` (K11b).
               On CPU tensors the kernels' plain PyTorch versions run.

    Precision on the 'pallas' backend ('pallas_precision'): on the TPU
    'mixed' (the default) runs bf16 coefficient matmuls and f32 force
    matmuls, 'highest' f32 emulation throughout and 'default' bf16
    throughout.  Here all three run K7 and K8 in FP32 on the CUDA cores,
    at least as accurate as any of them.  Torch matmuls and complex einsums
    run with TF32 off: constructing a Cube on a CUDA device sets
    torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    to False.
    """

    def __init__(self, norm, lap, nmaxx: int, nmaxy: int, nmaxz: int,
                 nminx: int = 0, nminy: int = 0, nminz: int = 0,
                 backend: str = "einsum", pallas_precision: str = "mixed",
                 pallas_version: int = 2):
        super().__init__()
        if backend not in ("einsum", "pallas"):
            raise ValueError(f"backend={backend!r}: expected 'einsum' or "
                             "'pallas'")
        if pallas_precision not in PRECISIONS:
            raise ValueError(f"pallas_precision={pallas_precision!r}: "
                             f"expected one of {PRECISIONS}")
        if pallas_version not in VERSIONS:
            raise ValueError(f"pallas_version={pallas_version!r}: expected "
                             f"one of {VERSIONS}")
        self.register_buffer("norm", norm)
        self.register_buffer("lap", lap)
        self.nmaxx, self.nmaxy, self.nmaxz = int(nmaxx), int(nmaxy), int(nmaxz)
        self.nminx, self.nminy, self.nminz = int(nminx), int(nminy), int(nminz)
        self.backend = backend
        self.pallas_precision = pallas_precision
        self.pallas_version = int(pallas_version)
        if backend == "pallas":
            ck.check_params(self._kernel_params())
        if norm.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    @classmethod
    def create(cls, nmaxx=6, nmaxy=6, nmaxz=6, nminx=0, nminy=0, nminz=0,
               dtype=torch.float32, backend: str = "einsum",
               pallas_precision: str = "mixed", pallas_version: int = 2,
               device=None) -> "Cube":
        """The force on `device` (None: CUDA, raising when there is none)."""
        device = resolve_device(device)
        kx = np.arange(-nmaxx, nmaxx + 1)
        ky = np.arange(-nmaxy, nmaxy + 1)
        kz = np.arange(-nmaxz, nmaxz + 1)
        KX, KY, KZ = np.meshgrid(kx, ky, kz, indexing="ij")
        k2 = KX**2 + KY**2 + KZ**2
        norm = np.zeros_like(k2, dtype=np.float64)
        mask = k2 > 0
        mask &= (np.abs(KX) >= nminx) & (np.abs(KY) >= nminy) \
            & (np.abs(KZ) >= nminz)
        norm[mask] = 1.0 / np.sqrt(np.pi * k2[mask])
        lap = (2.0 * np.pi) ** 2 * k2
        return cls(norm=torch.as_tensor(norm, dtype=dtype, device=device),
                   lap=torch.as_tensor(lap, dtype=dtype, device=device),
                   nmaxx=nmaxx, nmaxy=nmaxy, nmaxz=nmaxz, nminx=nminx,
                   nminy=nminy, nminz=nminz, backend=backend,
                   pallas_precision=pallas_precision,
                   pallas_version=pallas_version)

    # mirrors the SphereSL coef-file metadata protocol
    @property
    def lmax(self):
        return max(self.nmaxx, self.nmaxy, self.nmaxz)

    @property
    def nmax(self):
        return 2 * self.nmaxz + 1

    @property
    def coef_shape(self):
        return (2 * self.nmaxx + 1, 2 * self.nmaxy + 1, 2 * self.nmaxz + 1)

    def _kernel_params(self) -> ck.CubeKernelParams:
        return ck.CubeKernelParams(self.nmaxx, self.nmaxy, self.nmaxz)

    def _phases(self, x, sign):
        """exp(sign 2 pi i n x_c) for each axis; n = -nmax..nmax."""
        cd = _cdtype(x.dtype)
        out = []
        for c, nmax in ((0, self.nmaxx), (1, self.nmaxy), (2, self.nmaxz)):
            n = torch.arange(-nmax, nmax + 1, dtype=x.dtype, device=x.device)
            ang = sign * 2.0 * math.pi * x[:, c:c + 1] * n[None, :]
            out.append(torch.complex(torch.cos(ang), torch.sin(ang)).to(cd))
        return out

    # ------------------------------------------------------------------
    # Coefficients
    # ------------------------------------------------------------------

    def coefficients_local(self, x, mass, accum_dtype=torch.float32):
        """a_k of particles x (N, 3) with masses (N,), complex64 (complex128
        for accum_dtype float64); positions wrapped into the unit box."""
        cd = _cdtype(accum_dtype)
        if self.backend == "pallas":
            raw = ck.cube_coef(x.to(torch.float32).contiguous(),
                               mass.to(torch.float32).contiguous(),
                               self._kernel_params())
            return -raw.to(cd) * self.norm.to(cd)
        xw = ck.wrap(x)
        ex, ey, ez = self._phases(xw, sign=-1.0)
        m = mass.to(x.dtype)
        exm = ex * m[:, None]
        t = torch.einsum("ia,ib->iab", exm, ey)
        coef = torch.einsum("iab,ic->abc", t.to(cd), ez.to(cd))
        return -coef * self.norm.to(cd)

    def coefficients(self, x, mass, accum_dtype=torch.float32):
        """Coefficients of this device's particles; on a World the caller
        sums them over the ranks (parallel.world_coefficients)."""
        return self.coefficients_local(x, mass, accum_dtype=accum_dtype)

    # ------------------------------------------------------------------
    # Acceleration / potential
    # ------------------------------------------------------------------

    def acceleration(self, coef, x):
        """Acceleration (N, 3) and potential (N,) at x (N, 3) from the
        coefficient tensor."""
        dtype = x.dtype
        cd = _cdtype(dtype)
        b = coef.to(cd) * self.norm.to(cd)              # a_k norm_k
        if self.backend == "pallas":
            prm = self._kernel_params()
            x32 = x.to(torch.float32).contiguous()
            if self.pallas_version == 2:
                acc, pot = ck.cube_accel(x32, ck.cube_force_table(b, prm), prm)
            else:
                Rr, Ri = ck.pack_force_matrix(b, self.nmaxx, self.nmaxy,
                                              self.nmaxz)
                acc, pot = ck.cube_accel_v1(x32, Rr, Ri, prm)
            return acc.to(dtype), pot.to(dtype)
        xw = ck.wrap(x)
        ex, ey, ez = self._phases(xw, sign=+1.0)
        dev = x.device
        kxv = torch.arange(-self.nmaxx, self.nmaxx + 1, dtype=dtype, device=dev)
        kyv = torch.arange(-self.nmaxy, self.nmaxy + 1, dtype=dtype, device=dev)
        kzv = torch.arange(-self.nmaxz, self.nmaxz + 1, dtype=dtype, device=dev)
        tpi = 2.0 * math.pi

        # contract axes one at a time, applying each 2 pi k_c weight at axis
        # c's own contraction stage, so pot, ay and az share t1 and pot and
        # az share t2
        t1 = torch.einsum("abc,ia->ibc", b, ex)
        t1x = torch.einsum("abc,a,ia->ibc", b, (tpi * kxv).to(cd), ex)
        t2 = torch.einsum("ibc,ib->ic", t1, ey)
        t2y = torch.einsum("ibc,b,ib->ic", t1, (tpi * kyv).to(cd), ey)
        pot = torch.einsum("ic,ic->i", t2, ez).real.to(dtype)
        # acc_c = -Re[i 2 pi k_c sum] = +Im[2 pi k_c sum]
        ax = torch.einsum("ibc,ib,ic->i", t1x, ey, ez).imag
        ay = torch.einsum("ic,ic->i", t2y, ez).imag
        az = torch.einsum("ic,c,ic->i", t2, (tpi * kzv).to(cd), ez).imag
        acc = torch.stack([ax, ay, az], dim=-1).to(dtype)
        return acc, pot

    def density(self, coef, x):
        """BFE density: rho = -|2 pi k|^2 Phi_k a_k / (4 pi)."""
        cd = _cdtype(x.dtype)
        xw = ck.wrap(x)
        ex, ey, ez = self._phases(xw, sign=+1.0)
        b = coef.to(cd) * (self.norm * self.lap).to(cd) / (-4.0 * math.pi)
        t1 = torch.einsum("abc,ia->ibc", b, ex)
        t2 = torch.einsum("ibc,ib->ic", t1, ey)
        return torch.einsum("ic,ic->i", t2, ez).real.to(x.dtype)
