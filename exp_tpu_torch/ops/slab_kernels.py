"""Periodic-slab coefficient (K9) and force (K10) passes: CUDA kernels for
Hopper, their plain PyTorch versions, and the host glue around them.

Port of exp_tpu/ops/pallas_slab.py, for interp 'spline' (the default of
SlabForce) and 'linear':

  K9  `slab_coef`   replaces make_slab_coef_kernel   (csrc/slab_coef.cu)
  K10 `slab_accel`  replaces make_slab_accel_kernel  (csrc/slab_accel.cu)
  P1  `stream_coef` replaces the probe's make_stream_kernel
                    (scripts/probe_slab_phasestream.py; csrc/slab_phasestream.cu)

P1 computes K9's G from a bf16 phase table streamed from device memory,
which `phase_table` (the probe's producer, plain torch) builds; it serves
the port's probe (exp_tpu_torch/probe_slab_phasestream.py), not SlabForce.

The kernels read x (N, 3) and mass (N,) as they are and mask their own
ragged tail: the TPU's transposed (8, N) layout, its 1024-particle padding,
its selection matrices, its padded 16 x 16 (kx, ky) lattice and its bf16
splits are not carried over.  A particle touches 3 z-nodes ('spline'; 2 for
'linear'), and the kernels and the plain versions touch only those, where
the TPU multiplied dense (rows, B) weight matrices.

Layouts.  Wavevectors k = (kx, ky), kx = -nmaxx..nmaxx, ky = -nmaxy..nmaxy,
are flattened ab = (kx + nmaxx)(2 nmaxy + 1) + (ky + nmaxy), C of them; the
mirror -k of ab is C - 1 - ab.  The half lattice (kx > 0, or kx = 0 and
ky >= 0) is h = kx (2 nmaxy + 1) + ky = ab - (C - 1)/2, h = 0..H-1 with
H = (C + 1)/2.  K9 returns G (C, zrows) complex64, the JAX kernel's
contract; the caller contracts it with the z-tables (contract_coef_output).
K10 takes the port's own tables: the z-profiles folded onto the half lattice,
on each first z node as a polynomial in the particle's offset from it
(slab_force_table, (force_rows, H, kz, 4)), and the vacuum continuation's
boundary rows (slab_force_aux, (H, 8)); the TPU's Ct (4 Cp, nzp) and Aux
(Cp, 128) packings are kept as functions for the tests.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  `launch_counts` counts kernel
launches, one per wrapper call that reaches the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from exp_tpu_torch.ops import _build
from exp_tpu_torch.ops.cube_kernels import axis_phases, wrap
from exp_tpu_torch.ops.spline import b2

#: launches of each kernel since the last reset (only kernel launches count)
launch_counts = {"slab_coef": 0, "slab_accel": 0, "slab_phasestream": 0}

#: the nmax values per axis the kernels are built for, and the most table
#: rows in z (nzc + 2 for 'spline', nzc for 'linear')
KERNEL_NMAX = range(0, 9)
KERNEL_ZROWS_MAX = 128

#: K9's most groups a block, its most particles a tile, and its most
#: threads a block (kMaxThreads of csrc/slab_coef.cu, which two blocks an
#: SM fit in registers)
K9_MAX_GROUPS = 32
K9_MAX_TILE = 1024
K9_MAX_THREADS = 576

#: K10's threads a block, blocks an SM (kThreads, kBlocksPerSm of
#: csrc/slab_accel.cu, whose launch bounds fit that many in registers) and
#: its most particles a tile (kMaxTile)
K10_THREADS = 256
K10_BLOCKS_PER_SM = 2
K10_MAX_TILE = 1024

#: P1's tiles of particles, in the order its plan tries them, and its most
#: threads a block (the TILE instantiations and kMaxThreads of
#: csrc/slab_phasestream.cu; its kMaxZ is KERNEL_ZROWS_MAX)
P1_TILES = (128, 64)
P1_MAX_THREADS = 256

INTERPS = ("spline", "linear")

_TWO_PI = 2.0 * math.pi


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclass(frozen=True)
class SlabKernelParams:
    """Static geometry of the slab kernels (exp_tpu's kernel-maker
    arguments): nmax per horizontal axis, nzc coarse z nodes over
    [-zmax, zmax] and the z interpolation ('spline' or 'linear')."""

    nmaxx: int
    nmaxy: int
    nzc: int
    zmax: float
    interp: str = "spline"

    @property
    def C(self):
        return (2 * self.nmaxx + 1) * (2 * self.nmaxy + 1)

    @property
    def H(self):
        """Wavevectors of the half lattice."""
        return (self.C + 1) // 2

    @property
    def zrows(self):
        return self.nzc + 2 if self.interp == "spline" else self.nzc

    @property
    def dz(self):
        return 2.0 * self.zmax / (self.nzc - 1)

    @property
    def kz(self):
        """z rows a particle's interpolation takes: 3 'spline', 2 'linear'."""
        return 3 if self.interp == "spline" else 2

    @property
    def force_rows(self):
        """K10's table rows: the first z nodes j0 a particle can take
        (z_frac), nzc 'spline', nzc - 1 'linear'."""
        return self.nzc if self.interp == "spline" else self.nzc - 1


def check_params(prm: SlabKernelParams) -> None:
    """Raise NotImplementedError for a geometry the kernels are not built
    for: nmax 0..8 on each axis, 2..KERNEL_ZROWS_MAX table rows in z."""
    if prm.interp not in INTERPS:
        raise NotImplementedError(f"interp={prm.interp!r}: the slab kernels "
                                  f"are built for {INTERPS}")
    bad = [n for n in (prm.nmaxx, prm.nmaxy) if n not in KERNEL_NMAX]
    if bad:
        raise NotImplementedError(
            f"nmax {(prm.nmaxx, prm.nmaxy)}: the slab kernels are built for "
            f"nmax {KERNEL_NMAX.start}..{KERNEL_NMAX.stop - 1} on each axis")
    if prm.nzc < 2 or prm.zrows > KERNEL_ZROWS_MAX:
        raise NotImplementedError(
            f"nzc={prm.nzc} ({prm.zrows} table rows, interp "
            f"{prm.interp!r}): the slab kernels take 2..{KERNEL_ZROWS_MAX} "
            "rows in z")


def half_lattice(prm: SlabKernelParams, device=None):
    """(kx, ky) of the half-lattice wavevectors h = 0..H-1, int64."""
    B2 = 2 * prm.nmaxy + 1
    h = torch.arange(prm.H, device=device)
    kx = torch.div(h + prm.nmaxy, B2, rounding_mode="floor")
    return kx, h - kx * B2


# ---------------------------------------------------------------------------
# host packing (copies of pallas_slab.py :313-413, and the port's layouts)
# ---------------------------------------------------------------------------

def resample_z(table, numz, nzc):
    """Linear resample a (numz, ...) uniform-z table onto nzc nodes
    (host-side, once)."""
    t = np.linspace(0.0, numz - 1.0, nzc)
    i0 = np.minimum(t.astype(np.int64), numz - 2)
    f = (t - i0).reshape((-1,) + (1,) * (np.ndim(table) - 1))
    a = np.asarray(table, np.float32)
    return a[i0] * (1.0 - f) + a[i0 + 1] * f


def signed_k(v):
    """(..., nkx, nky, n) |k| rows -> (..., 2nkx-1, 2nky-1, n): the mirror
    of the |k| tables to signed k (pallas_slab.py expand_signed and the
    `sgn` mirror of forces/slab.py), the one copy in the port."""
    a = torch.cat([v[..., 1:, :, :].flip(-3), v], dim=-3)
    return torch.cat([a[..., 1:, :].flip(-2), a], dim=-2)


def contract_coef_output(G, phi_s, sgn):
    """G (C, zrows) complex x phi_s (zrows, A, B2, n) signed z-table ->
    coefficients (A, B2, n) complex with the -4 pi and pairing signs: one
    batched FP32 product over the z nodes, per wavevector (TF32 off on a
    CUDA device, set by SlabForce)."""
    A, B2, nn = phi_s.shape[1:]
    P = phi_s.reshape(-1, A * B2, nn).transpose(0, 1)     # (C, zrows, n)
    Gr = torch.view_as_real(G).transpose(1, 2)            # (C, 2, zrows)
    c = torch.bmm(Gr, P.to(Gr.dtype))                     # (C, 2, n)
    c = torch.view_as_complex(c.transpose(1, 2).contiguous())
    return c.reshape(A, B2, nn) * (-4.0 * math.pi * sgn.to(Gr.dtype))


def fold_half(T, prm: SlabKernelParams, dim=-1):
    """T (..., C, ...) complex over the full lattice (wavevectors along
    `dim`) -> (..., H, ...): T_h + conj T_{-h} for h > 0, T_0 as it is.
    Re and Im of the conjugate term at k equal those of T_{-k}'s term at
    -k (with the sign of k for Im), so every real output of the force pass
    is unchanged."""
    T = T.movedim(dim, -1)
    ctr = (prm.C - 1) // 2
    h = T[..., ctr:].clone()
    h[..., 1:] += torch.conj(T[..., :ctr].flip(-1))
    return h.movedim(-1, dim)


def force_poly(T, interp):
    """Rows (zrows, ...) of a profile on the z nodes -> (force_rows, kz,
    ...): on each first node j0 (z_frac) the coefficients of the
    interpolated profile as a polynomial in the particle's offset g = t -
    j0, which z_nodes' weights are.  'spline': T0/8 + 3 T1/4 + T2/8,
    (T2 - T0)/2 and T0/2 - T1 + T2/2 of rows j0..j0+2, for the weights
    (1/2 - g)^2/2, 3/4 - g^2, (1/2 + g)^2/2 (g in [-1/2, 1/2]); 'linear':
    T0 and T1 - T0, for 1 - g and g (g in [0, 1])."""
    if interp == "spline":
        t0, t1, t2 = T[:-2], T[1:-1], T[2:]
        return torch.stack([0.125 * t0 + 0.75 * t1 + 0.125 * t2,
                            0.5 * (t2 - t0), 0.5 * t0 - t1 + 0.5 * t2], dim=1)
    return torch.stack([T[:-1], T[1:] - T[:-1]], dim=1)


def z_profile_tables(phi_s, dphi_s, interp):
    """The signed coarse z-tables (zrows, A, B2, n) of phi and dphi as
    polynomials in the offset from each first node (force_poly), stacked
    once into (2, force_rows, kz, C, n): the operand of slab_force_table,
    built when the force is, so that a step's table stays one product."""
    zr, A, B2, nn = phi_s.shape
    return torch.stack([force_poly(t.reshape(zr, A * B2, nn), interp)
                        for t in (phi_s, dphi_s)])


def boundary_rows(phi_t, dphi_t):
    """The full-resolution tables' rows at z = +zmax and -zmax (phi_t[-1],
    phi_t[0], dphi_t[-1], dphi_t[0]) in the signed-k layout, stacked once
    into (4, C, n), the operand of slab_force_aux."""
    rows = signed_k(torch.stack([phi_t[-1], phi_t[0], dphi_t[-1],
                                 dphi_t[0]]))
    return rows.reshape(4, -1, rows.shape[-1])


def slab_force_table(coef, zq, prm: SlabKernelParams):
    """coef (A, B2, n) complex x the polynomial z-tables (z_profile_tables)
    -> K10's table (force_rows, H, kz, 4) f32: on each first z node and
    half-lattice wavevector the coefficients of the folded (fold_half)
    complex profiles T = sum_n coef phi and T' = sum_n coef dphi as
    polynomials in the particle's offset from the node, each as (Re T,
    Im T, Re T', Im T'), so that a particle reads kz rows of 16 bytes a
    wavevector, one after the other."""
    cr = torch.view_as_real(coef).reshape(prm.C, -1, 2)    # (C, n, 2)
    R = torch.einsum("qjkcn,cnr->jckqr", zq.to(cr.dtype), cr).contiguous()
    T = fold_half(torch.view_as_complex(R), prm, dim=1)    # (rows, H, kz, 2)
    return torch.view_as_real(T).reshape(-1, prm.H, prm.kz, 4).to(
        torch.float32).contiguous()


def slab_force_aux(coef, bnd, prm: SlabKernelParams):
    """K10's vacuum-continuation rows (H, 8) f32 from coef (A, B2, n)
    complex and the stacked boundary rows (boundary_rows): per
    half-lattice wavevector the folded sum_n coef * row as (Re, Im) of the
    top and bottom potential, then of the top and bottom dPhi/dz."""
    cr = torch.view_as_real(coef).reshape(prm.C, -1, 2)
    R = torch.einsum("qcn,cnr->cqr", bnd.to(cr.dtype), cr).contiguous()
    T = fold_half(torch.view_as_complex(R), prm, dim=0)    # (H, 4)
    return torch.view_as_real(T).reshape(prm.H, 8).to(
        torch.float32).contiguous()


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def contract_slab_tables(coef, phi_s, dphi_s, nmaxx, nmaxy):
    """The TPU packing (pallas_slab.py:340-363): coef (A, B2, n) complex x
    signed z-tables -> Ct (4 Cp, nzp) f32, rows [pot re | pot im | d/dz re |
    d/dz im] of Cp wavevector rows each.  Kept for the tests, which feed
    the JAX kernel and the port the same coefficients."""
    nzc, A, B2, nn = phi_s.shape
    C = A * B2
    Cp, nzp = _round_up(C, 8), _round_up(nzc, 128)
    rows = []
    for tab in (phi_s, dphi_s):
        Tq = torch.einsum("abn,jabn->jab", coef, tab.to(coef.dtype))
        M = Tq.reshape(nzc, C).T
        for part in (M.real, M.imag):
            rows.append(torch.nn.functional.pad(
                part.to(torch.float32), (0, nzp - nzc, 0, Cp - C)))
    return torch.cat(rows, dim=0)


def slab_accel_aux(coef, phi_top, phi_bot, dphi_top, dphi_bot, nmaxx, nmaxy):
    """The TPU's Aux operand (pallas_slab.py:366-413), (Cp, 128) f32:
    columns 2 pi kx, 2 pi ky, 2 pi |k|, the k = 0 mask, then the top and
    bottom boundary potential and dPhi/dz (re, im).  Kept for the tests."""
    kxv = np.arange(-nmaxx, nmaxx + 1, dtype=np.float32)
    kyv = np.arange(-nmaxy, nmaxy + 1, dtype=np.float32)
    A, B2 = 2 * nmaxx + 1, 2 * nmaxy + 1
    C = A * B2
    Cp = _round_up(C, 8)
    kmag = np.sqrt(kxv[:, None] ** 2 + kyv[None, :] ** 2)
    cols = [np.broadcast_to((_TWO_PI * kxv)[:, None], (A, B2)).reshape(C),
            np.broadcast_to((_TWO_PI * kyv)[None, :], (A, B2)).reshape(C),
            (_TWO_PI * kmag).reshape(C),
            (kmag == 0).astype(np.float32).reshape(C)]
    cols = [torch.as_tensor(np.ascontiguousarray(c), dtype=torch.float32,
                            device=coef.device) for c in cols]
    for tab in (phi_top, phi_bot, dphi_top, dphi_bot):
        Tb = torch.einsum("abn,abn->ab", coef,
                          signed_k(tab).to(coef.dtype)).reshape(C)
        cols += [Tb.real.to(torch.float32), Tb.imag.to(torch.float32)]
    aux = torch.stack(cols, dim=1)                        # (C, 12)
    return torch.nn.functional.pad(aux, (0, 128 - aux.shape[1], 0, Cp - C))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def z_grid(z, prm: SlabKernelParams):
    """Grid position t = clip((z + zmax) / dz, 0, nzc - 1), as the JAX
    kernels round it (f32, zmax and dz rounded to f32)."""
    return torch.clamp(_build.div_f32(z + prm.zmax, prm.dz), 0.0,
                       prm.nzc - 1.0)


def z_frac(t, prm: SlabKernelParams):
    """The first of a particle's contiguous z nodes, j0, and its offset g =
    t - j0, in which its interpolation is a polynomial (force_poly;
    csrc/slab_common.cuh z_frac).  'spline': j0 = floor(t + 1.5) - 1 held
    in 0..nzc-1 (rows 0 and nzc + 1 are ghost spline coefficients);
    'linear': j0 = floor(t) held in 0..nzc-2, so that the window stays
    inside the table."""
    if prm.interp == "spline":
        j0 = torch.clamp(torch.floor(t + 1.5), 1.0, float(prm.nzc)) - 1.0
    else:
        j0 = torch.clamp(torch.floor(t), max=prm.nzc - 2.0)
    return j0.long(), t - j0


def z_nodes(t, prm: SlabKernelParams):
    """The first z node (z_frac) and the weights of the nodes from it
    (csrc/slab_common.cuh z_nodes).  'spline': the prefiltered quadratic
    B-spline weights b2(j - 1 - t) on rows j0..j0+2; 'linear': the hats
    max(0, 1 - |j - t|) on rows j0, j0 + 1 (at t = nzc - 1 the first
    weight is 0)."""
    j0, _ = z_frac(t, prm)
    jf = j0.to(t.dtype)
    if prm.interp == "spline":
        ws = [b2(jf + k - 1.0 - t) for k in range(3)]
    else:
        ws = [torch.clamp(1.0 - torch.abs(jf + k - t), min=0.0)
              for k in range(2)]
    return j0, ws


def slab_coef_plain(x, mass, prm: SlabKernelParams, chunk: int = 65536):
    """Plain version of K9: G (C, zrows) complex64 raw sums
    G[ab, j] = sum_i w_i e^{-2 pi i k.u_i} Wz[j, i] of particles x (N, 3),
    mass (N,), with u = x - floor(x) and w the mass masked to |z| <= zmax,
    as the JAX kernel contracts them: [xyr; xyi] (2C, B) against the
    (B, zrows) z weights, one f32 matmul a chunk of particles."""
    C, zr = prm.C, prm.zrows
    acc = torch.zeros((2 * C, zr), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], chunk):
        xs = x[s:s + chunk].to(torch.float32)
        m = mass[s:s + chunk].to(torch.float32)
        u, z = wrap(xs[:, :2]), xs[:, 2]
        w = torch.where(torch.abs(z) <= prm.zmax, m, torch.zeros_like(m))
        ex = axis_phases(u[:, 0], prm.nmaxx, -1.0) * w[:, None]
        ey = axis_phases(u[:, 1], prm.nmaxy, -1.0)
        exy = (ex[:, :, None] * ey[:, None, :]).reshape(-1, C)
        XY = torch.cat([exy.real, exy.imag], dim=1)
        j0, ws = z_nodes(z_grid(z, prm), prm)
        Wz = torch.zeros((xs.shape[0], zr), dtype=torch.float32,
                         device=x.device)
        for k, wk in enumerate(ws):
            Wz.scatter_add_(1, (j0 + k)[:, None], wk[:, None])
        acc += XY.T @ Wz
    return torch.complex(acc[:C], acc[C:])


def phase_rows(prm: SlabKernelParams) -> int:
    """Cr: the rows of each half (re, im) of P1's phase table, C rounded up
    to 8 as the probe pads it."""
    return _round_up(prm.C, 8)


def phase_table(x, prm: SlabKernelParams, split: bool = False):
    """The probe's producer (probe_slab_phasestream.py:70-93), plain torch:
    the phases e^{-2 pi i (kx u_x + ky u_y)} of the wrapped positions
    u = x - floor(x), k in the (kx, ky) order of G, rounded to bf16 (round
    to nearest even) as a (2 Cr, N) table [re | im]; with `split`, the bf16
    residuals of the f32 phases follow as [re_hi | im_hi | re_lo | im_lo]
    (4 Cr, N).  The Cr - C padding rows have k = 0 (phase 1), as the probe's
    have.  x (N, 3) f32."""
    C, Cr = prm.C, phase_rows(prm)
    B2 = 2 * prm.nmaxy + 1
    r = torch.arange(Cr, device=x.device)
    ka = torch.where(r < C, torch.div(r, B2, rounding_mode="floor")
                     - prm.nmaxx, 0).to(torch.float32)
    kb = torch.where(r < C, r % B2 - prm.nmaxy, 0).to(torch.float32)
    u = wrap(x[:, :2].to(torch.float32))
    ang = (-_TWO_PI) * (ka[:, None] * u[None, :, 0] + kb[:, None] * u[None, :, 1])
    re, im = torch.cos(ang), torch.sin(ang)
    if not split:
        return torch.cat([re, im]).to(torch.bfloat16)
    re_h, im_h = re.to(torch.bfloat16), im.to(torch.bfloat16)
    re_l = (re - re_h.to(torch.float32)).to(torch.bfloat16)
    im_l = (im - im_h.to(torch.float32)).to(torch.bfloat16)
    return torch.cat([re_h, im_h, re_l, im_l])


def _phase_split(ph, prm):
    """Whether a phase table of ph's rows is split (4 Cr) or not (2 Cr)."""
    Cr = phase_rows(prm)
    if ph.dim() != 2 or ph.shape[0] not in (2 * Cr, 4 * Cr):
        raise ValueError(f"phase table has shape {tuple(ph.shape)}, expected "
                         f"({2 * Cr} or {4 * Cr}, N)")
    return ph.shape[0] == 4 * Cr


def stream_coef_plain(ph, x, mass, prm: SlabKernelParams, chunk: int = 65536):
    """Plain version of P1: G (C, zrows) complex64 = sum_i P[r, i] w_i
    Wz[j, i] from the bf16 phase table ph (phase_table) of particles x
    (N, 3), mass (N,), with w the mass masked to |z| <= zmax and Wz the
    particle's z weights (z_nodes); P is ph widened to f32, or hi + lo of
    a split table (exact in f32).  One f32 matmul a chunk of particles."""
    split = _phase_split(ph, prm)
    C, Cr, zr = prm.C, phase_rows(prm), prm.zrows
    acc = torch.zeros((2 * Cr, zr), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], chunk):
        z = x[s:s + chunk, 2].to(torch.float32)
        m = mass[s:s + chunk].to(torch.float32)
        w = torch.where(torch.abs(z) <= prm.zmax, m, torch.zeros_like(m))
        j0, ws = z_nodes(z_grid(z, prm), prm)
        Wz = torch.zeros((z.shape[0], zr), dtype=torch.float32,
                         device=x.device)
        for k, wk in enumerate(ws):
            Wz.scatter_add_(1, (j0 + k)[:, None], (w * wk)[:, None])
        P = ph[:2 * Cr, s:s + chunk].to(torch.float32)
        if split:
            P = P + ph[2 * Cr:, s:s + chunk].to(torch.float32)
        acc += P @ Wz
    return torch.complex(acc[:C], acc[Cr:Cr + C])


def slab_accel_plain(x, tab, aux, prm: SlabKernelParams, chunk: int = 65536):
    """Plain version of K10: (acc (N, 3), pot (N,)) f32 at x (N, 3) from
    the folded table (slab_force_table) and boundary rows (slab_force_aux).
    With e_h = e^{+2 pi i k.u} and T, T' interpolated at the clamped z (the
    table's polynomial at the offset g of z_frac, by Horner's rule):
    pot = Re sum T e, a_x, a_y = Im sum 2 pi k T e, a_z = -Re sum T' e.
    For |z| > zmax the vacuum continuation: each mode decays as
    e^{-2 pi |k| (|z| - zmax)} off its boundary value, and the k = 0 mode
    continues linearly (pallas_slab.py:248-279)."""
    kx, ky = half_lattice(prm, x.device)
    kxw = _TWO_PI * kx.to(torch.float32)
    kyw = _TWO_PI * ky.to(torch.float32)
    kmw = _TWO_PI * torch.sqrt((kx * kx + ky * ky).to(torch.float32))
    auxc = torch.view_as_complex(aux.reshape(prm.H, 4, 2))     # (H, 4)
    accs, pots = [], []
    for s in range(0, x.shape[0], chunk):
        xs = x[s:s + chunk].to(torch.float32)
        u, z = wrap(xs[:, :2]), xs[:, 2]
        ex = axis_phases(u[:, 0], prm.nmaxx, 1.0)[:, prm.nmaxx:]
        ey = axis_phases(u[:, 1], prm.nmaxy, 1.0)
        e = ex[:, kx] * ey[:, ky + prm.nmaxy]                  # (B, H)
        zc = torch.clamp(z, -prm.zmax, prm.zmax)
        j0, g = z_frac(z_grid(zc, prm), prm)
        P = tab[j0]                                            # (B, H, kz, 4)
        T = P[:, :, -1]
        for k in range(prm.kz - 2, -1, -1):
            T = P[:, :, k] + g[:, None, None] * T
        tp = torch.complex(T[..., 0], T[..., 1]) * e
        pot = tp.real.sum(dim=1)
        ax = (tp.imag * kxw).sum(dim=1)
        ay = (tp.imag * kyw).sum(dim=1)
        az = -(torch.complex(T[..., 2], T[..., 3]) * e).real.sum(dim=1)

        dzp = torch.clamp(torch.abs(z) - prm.zmax, min=0.0)
        out = dzp > 0.0
        if bool(out.any()):
            top = (z >= 0)[:, None]
            szn = torch.where(z >= 0, 1.0, -1.0)
            Tb = torch.where(top, auxc[:, 0], auxc[:, 1])      # (B, H)
            Td0 = torch.where(top[:, 0], auxc[0, 2], auxc[0, 3]).real
            OE = Tb * e * torch.exp(-kmw * dzp[:, None])
            pot_o = OE.real.sum(dim=1) + Td0 * dzp * szn
            ax_o = (OE.imag * kxw).sum(dim=1)
            ay_o = (OE.imag * kyw).sum(dim=1)
            az_o = -Td0 + szn * (kmw * OE.real).sum(dim=1)
            ax, ay = torch.where(out, ax_o, ax), torch.where(out, ay_o, ay)
            az, pot = torch.where(out, az_o, az), torch.where(out, pot_o, pot)
        accs.append(torch.stack([ax, ay, az], dim=1))
        pots.append(pot)
    if not accs:
        return (torch.empty((0, 3), dtype=torch.float32, device=x.device),
                torch.empty((0,), dtype=torch.float32, device=x.device))
    return torch.cat(accs), torch.cat(pots)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong


def _on_card(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _geometry_args(prm):
    return (prm.nmaxx, prm.nmaxy, prm.nzc, 1 if prm.interp == "spline" else 0,
            prm.zmax, prm.dz)


def _round32(v):
    return -(-v // 32) * 32


def k9_smem(prm: SlabKernelParams, ng: int, tile: int) -> int:
    """K9's shared memory a block of ng groups with tiles of `tile`
    particles, in the order csrc/slab_coef.cu carves it (its Smem): the
    tile's sorted records (w Wz, j0; 16 B), the (zrows, H) complex
    accumulator, the sorted phase rows (nmaxx + 1 + 2 nmaxy + 1 complex a
    particle), the side buffer (KZ - 1 complex rows of H a group), each
    particle's bin and rank, each 32-particle chunk's counts by bin (nzc
    rounded up to 32 bins), the bins' totals and the tile's count, and the
    groups' parts and next j0.  The launcher refuses a smaller `smem`."""
    kz = 3 if prm.interp == "spline" else 2
    row = prm.nmaxx + 1 + 2 * prm.nmaxy + 1
    nbins = _round32(prm.nzc)
    return (16 * tile + 8 * prm.zrows * prm.H + 8 * tile * row
            + 8 * ng * (kz - 1) * prm.H + 4 * tile
            + 4 * (tile // 32 + 1) * nbins + 4 + 4 * (2 * ng + 1))


@dataclass(frozen=True)
class SlabCoefPlan:
    """K9's launch: `nblocks` blocks of `ng` groups of H threads (packed,
    `threads` = ng H rounded up to 32), tiles of `tile` particles, and
    `smem` bytes of shared memory a block."""

    ng: int
    tile: int
    threads: int
    nblocks: int
    smem: int


def k9_groups(prm: SlabKernelParams) -> list:
    """K9's groups a block in the order its plan tries them: the fewest
    idle lanes for each live one first (ng H threads rounded up to 32, at
    most K9_MAX_THREADS), then more groups."""
    H = prm.H
    ok = [g for g in range(1, K9_MAX_GROUPS + 1)
          if _round32(g * H) <= K9_MAX_THREADS]
    return sorted(ok, key=lambda g: ((_round32(g * H) - g * H) / (g * H), -g))


def coef_plan(prm: SlabKernelParams, props, n) -> SlabCoefPlan:
    """K9's launch plan on a device with properties `props`.  Two blocks
    an SM where their shared memory fits (one block's staging then
    overlaps the other's walk), else one; the groups of k9_groups and the
    largest tile (a multiple of 32, at most K9_MAX_TILE) that fits; no
    more blocks than tiles of particles.  Raises ValueError when nothing
    fits."""
    for per_sm in (2, 1):
        budget = min(props.shared_memory_per_block_optin,
                     props.shared_memory_per_multiprocessor // per_sm - 1024)
        for ng in k9_groups(prm):
            fits = [t for t in range(32, K9_MAX_TILE + 1, 32)
                    if k9_smem(prm, ng, t) <= budget]
            if fits:
                tile = fits[-1]
                nblocks = max(1, min(per_sm * props.multi_processor_count,
                                     -(-n // tile)))
                return SlabCoefPlan(ng, tile, _round32(ng * prm.H), nblocks,
                                    k9_smem(prm, ng, tile))
    raise ValueError(f"slab_coef: the smallest block ({k9_smem(prm, 1, 32)}"
                     " B) exceeds a block's shared memory")


def slab_coef(x, mass, prm: SlabKernelParams):
    """K9: G (C, zrows) complex64 raw sums.

    x (N, 3), mass (N,), f32.  CPU tensors take slab_coef_plain; CUDA
    tensors launch csrc/slab_coef.cu with the plan of coef_plan."""
    check_params(prm)
    if x.device.type == "cpu":
        return slab_coef_plain(x, mass, prm)
    _on_card(x, "slab_coef")
    n = x.shape[0]
    dev = x.device
    _build.check_tensor(x, "x", (n, 3), dev)
    _build.check_tensor(mass, "mass", (n,), dev)
    fn, err = _build.bind("slab_coef", [_P, _P, _LL, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _F, _F, _P])
    plan = coef_plan(prm, torch.cuda.get_device_properties(dev), n)
    partial = torch.empty((plan.nblocks, prm.zrows, prm.H, 2),
                          dtype=torch.float32, device=dev)
    out = torch.empty((prm.C, prm.zrows, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), mass.data_ptr(), n, partial.data_ptr(),
                  out.data_ptr(), plan.ng, plan.tile, plan.nblocks, plan.smem,
                  *_geometry_args(prm), stream)
    _build.raise_on(code, err, "slab_coef")
    launch_counts["slab_coef"] += 1
    return torch.view_as_complex(out)


def stream_smem_bytes(prm: SlabKernelParams, split: bool, tile: int) -> int:
    """P1's shared memory a block with tiles of `tile` particles, as
    csrc/slab_phasestream.cu lays it out: the tile's sorted records (16 B
    each), each sorting warp's counts and offsets by z bin, the bins'
    starts and occupancy, a table offset for each staged row, and two
    buffers of the 2C (or 4C, split) staged rows of tile / 2 + 1 words."""
    A = 2 * prm.C
    nst = 2 * A if split else A
    zb = KERNEL_ZROWS_MAX
    return (16 * tile + 4 * (2 * (tile // 32) * zb + zb + 4) + 4 * (zb // 32)
            + 8 * nst + 8 * nst * (tile // 2 + 1))


@dataclass(frozen=True)
class StreamPlan:
    """P1's launch: tiles of `tile` particles, blocks of `threads` threads
    and `smem` bytes of shared memory, `nblocks` blocks."""

    tile: int
    threads: int
    nblocks: int
    smem: int


def stream_plan(prm: SlabKernelParams, split: bool, props, n) -> StreamPlan:
    """P1's launch plan on a device with properties `props`: the largest
    tile (P1_TILES) with which two blocks fit an SM's shared memory, else
    the largest with which one fits; threads enough for the 2C output rows
    and the tile's particles (rounded up to 32); two or one blocks an SM,
    no more than tiles of particles.  Raises ValueError when the 2C rows
    exceed P1_MAX_THREADS or no tile fits (nmax above 5)."""
    A = 2 * prm.C
    if -(-A // 32) * 32 > P1_MAX_THREADS:
        raise ValueError(f"slab_phasestream: {A} output rows exceed "
                         f"a block's {P1_MAX_THREADS} threads")
    for per_sm in (2, 1):
        for tile in P1_TILES:
            smem = stream_smem_bytes(prm, split, tile)
            if smem <= props.shared_memory_per_block_optin and \
                    per_sm * (smem + 1024) <= \
                    props.shared_memory_per_multiprocessor:
                threads = max(-(-A // 32) * 32, tile)
                tiles = -(-n // tile)
                nblocks = max(1, min(per_sm * props.multi_processor_count,
                                     tiles))
                return StreamPlan(tile, threads, nblocks, smem)
    raise ValueError(f"slab_phasestream: {stream_smem_bytes(prm, split, 64)}"
                     " B of shared memory a block exceeds the device's "
                     f"{props.shared_memory_per_block_optin}")


def stream_coef(ph, x, mass, prm: SlabKernelParams):
    """P1: G (C, zrows) complex64 from the bf16 phase table.

    ph (2 Cr or 4 Cr, N) bf16 from phase_table, x (N, 3) and mass (N,) f32.
    CPU tensors take stream_coef_plain; CUDA tensors launch
    csrc/slab_phasestream.cu."""
    check_params(prm)
    split = _phase_split(ph, prm)
    if x.device.type == "cpu":
        return stream_coef_plain(ph, x, mass, prm)
    _on_card(x, "slab_phasestream")
    n = x.shape[0]
    dev = x.device
    _build.check_tensor(x, "x", (n, 3), dev)
    _build.check_tensor(mass, "mass", (n,), dev)
    if ph.device != dev or ph.dtype != torch.bfloat16 or ph.shape[1] != n \
            or not ph.is_contiguous():
        raise ValueError(f"ph must be a contiguous bf16 ({ph.shape[0]}, {n}) "
                         f"tensor on {dev}")
    fn, err = _build.bind("slab_phasestream",
                          [_P, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _F, _F, _P])
    plan = stream_plan(prm, split, torch.cuda.get_device_properties(dev), n)
    partial = torch.empty((plan.nblocks, prm.zrows, 2 * prm.C),
                          dtype=torch.float32, device=dev)
    out = torch.empty((prm.C, prm.zrows, 2), dtype=torch.float32, device=dev)
    vec = int(n % 2 == 0 and ph.data_ptr() % 4 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(ph.data_ptr(), x.data_ptr(), mass.data_ptr(), n,
                  partial.data_ptr(), out.data_ptr(), plan.nblocks, plan.tile,
                  plan.threads, int(split), vec, *_geometry_args(prm), stream)
    _build.raise_on(code, err, "slab_phasestream")
    launch_counts["slab_phasestream"] += 1
    return torch.view_as_complex(out)


def k10_smem(prm: SlabKernelParams, tile: int) -> int:
    """K10's shared memory a block with tiles of `tile` particles, in the
    order csrc/slab_accel.cu carves it (its Smem): the tile's sorted
    records (x, y, z, place; 16 B), with room for a padding record a bin
    (nzc + 2 bins rounded up to 32), its x as it lies in memory (12 B a
    particle), its outputs (acc and pot, 16 B a particle), each particle's
    key, the bins' counts and their first places and the tile's padded
    count."""
    nbp = _round32(prm.nzc + 2)
    return 16 * (tile + nbp) + 32 * tile + 4 * nbp + 4 * (nbp + 1)


@dataclass(frozen=True)
class SlabAccelPlan:
    """K10's launch: tiles of `tile` particles sorted into `nbins` bins (the
    first z node, then below -zmax and above +zmax), blocks of `threads`,
    `nblocks` blocks and `smem` bytes of shared memory a block."""

    tile: int
    threads: int
    nblocks: int
    nbins: int
    smem: int


@functools.lru_cache(maxsize=256)
def accel_plan(n, prm: SlabKernelParams, sm_count, smem_optin) -> SlabAccelPlan:
    """K10's launch plan for n particles on a device of `sm_count` SMs and
    `smem_optin` bytes of shared memory a block: the largest tile (a power
    of two, 32..K10_MAX_TILE) that still gives every SM a tile where n
    allows, since a larger tile sorts more particles into each warp's z
    nodes; K10_THREADS threads (no more than the tile); one block a tile up
    to K10_BLOCKS_PER_SM an SM, which then walk the tiles in turn.  Raises
    ValueError when the shared memory does not fit."""
    tile = K10_MAX_TILE
    while tile > 32 and -(-n // tile) < sm_count:
        tile //= 2
    smem = k10_smem(prm, tile)
    if smem > smem_optin:
        raise ValueError(f"slab_accel: {smem} B of shared memory a block "
                         f"exceeds the device's {smem_optin}")
    nblocks = max(1, min(-(-n // tile), K10_BLOCKS_PER_SM * sm_count))
    return SlabAccelPlan(tile, min(K10_THREADS, tile), nblocks, prm.nzc + 2,
                         smem)


def slab_accel(x, tab, aux, prm: SlabKernelParams):
    """K10: slab force (acc (N, 3), pot (N,)) f32.

    x (N, 3), tab (force_rows, H, kz, 4) from slab_force_table, aux (H,
    8) from slab_force_aux; f32.  CPU tensors take slab_accel_plain; CUDA
    tensors launch csrc/slab_accel.cu with the plan of accel_plan."""
    check_params(prm)
    if x.device.type == "cpu":
        return slab_accel_plain(x, tab, aux, prm)
    _on_card(x, "slab_accel")
    n = x.shape[0]
    dev = x.device
    _build.check_tensor(x, "x", (n, 3), dev)
    _build.check_tensor(tab, "tab", (prm.force_rows, prm.H, prm.kz, 4), dev)
    _build.check_tensor(aux, "aux", (prm.H, 8), dev)
    if tab.data_ptr() % 16 or aux.data_ptr() % 16:
        raise ValueError("tab and aux must be 16-byte aligned")
    fn, err = _build.bind("slab_accel", [_P, _LL, _P, _P, _P, _P, _I, _I, _I,
                                         _I, _F, _F, _I, _I, _I, _I, _P])
    props = torch.cuda.get_device_properties(dev)
    plan = accel_plan(n, prm, props.multi_processor_count,
                      props.shared_memory_per_block_optin)
    acc = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pot = torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), n, tab.data_ptr(), aux.data_ptr(),
                  acc.data_ptr(), pot.data_ptr(), *_geometry_args(prm),
                  plan.tile, plan.threads, plan.nblocks, plan.smem, stream)
    _build.raise_on(code, err, "slab_accel")
    launch_counts["slab_accel"] += 1
    return acc, pot
