"""Sphere coefficient (K1) and force (K2) passes: CUDA kernels for Hopper,
their plain PyTorch versions, and the host glue around them.

Port of exp_tpu/ops/pallas_sphere.py, the 'spline' interpolation with the
default harmonics ('auto': poly coefficient pass, recurrence force pass):

  K1 `sphere_coef`  replaces make_coef_kernel_poly  (csrc/sphere_coef.cu)
  K2 `sphere_accel` replaces make_accel_kernel      (csrc/sphere_accel.cu)

The kernels read x (N, 3) and mass (N,) as they are and mask their own
ragged tail: the TPU's transposed (8, N) layout, its 4096-particle blocks
and its lane padding of tables (C1, Fp) are not carried over.  Each
wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  `launch_counts` counts kernel
launches, one per wrapper call that reaches the card.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from exp_tpu_torch.ops import _build
from exp_tpu_torch.ops.spline import b2

#: launches of each kernel since the last reset (only kernel launches count)
launch_counts = {"sphere_coef": 0, "sphere_accel": 0}

#: the lmax values the kernels are instantiated for
KERNEL_LMAX = range(0, 7)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def packed_rows(lmax):
    """Valid (cs, l, m) harmonic rows in packed order: cos for m <= l,
    then sin for 1 <= m <= l ((lmax+1)^2 rows)."""
    rows = [(0, l, m) for l in range(lmax + 1) for m in range(l + 1)]
    rows += [(1, l, m) for l in range(lmax + 1) for m in range(1, l + 1)]
    return rows


def poly_matrix(lmax, fac_np=None) -> np.ndarray:
    """M (P, n_mono) f32 with M[p] . mono(u) = fac[l,m] P_lm {cos,sin}(m phi)
    for the packed rows p, rescaled to a custom `fac_np` when given (the
    matrix is linear in fac).  Unpadded: the kernel skips the structural
    zeros itself (exp_tpu's _poly_matrices pads to (C1, NMp))."""
    from exp_tpu_torch.ops.solidharm import harmonic_matrix, standard_fac

    prows = packed_rows(lmax)
    M = harmonic_matrix(lmax, tuple(prows))
    if fac_np is not None:
        fac_np = np.asarray(fac_np)
        ratio = np.array([fac_np[l, m] / standard_fac(l, m)
                          for (cs, l, m) in prows])[:, None]
        M = M * ratio
    return np.ascontiguousarray(M, dtype=np.float32)


def packed_rows_tensor(lmax, device):
    """packed_rows as an int64 (P, 3) tensor of (cs, l, m) on `device`."""
    return torch.as_tensor(packed_rows(lmax), dtype=torch.int64,
                           device=device)


def expand_coef_matrix(coef, prows):
    """coef (2, L+1, L+1, nmax) -> Wc (F, P) f32, F = (L+1)*nmax: rows
    (l, n), columns in packed-row order (`prows` from packed_rows_tensor,
    on coef's device), Wc[l*nmax+n, p] = coef[p][n] where l is row p's
    degree and zero elsewhere."""
    L1, nmax = coef.shape[1], coef.shape[3]
    P = prows.shape[0]
    vals = coef.to(torch.float32)[prows[:, 0], prows[:, 1], prows[:, 2]]
    Wc = torch.zeros((L1, P, nmax), dtype=torch.float32, device=coef.device)
    Wc[prows[:, 1], torch.arange(P, device=coef.device)] = vals
    return Wc.transpose(1, 2).reshape(L1 * nmax, P)


def contract_coef_table2(coef, tabc_s, tabd_s, prows):
    """The pot and d(pot)/dxi spline tables (each (rows, F)) contracted with
    the coefficients -> twT (2P, rows) f32, the force kernel's table.

    A (2 rows) x F x P matmul in full FP32: on CUDA it runs with TF32 off
    (torch.backends.cuda.matmul.allow_tf32 and cudnn.allow_tf32 both set
    False by SphereSL for a CUDA device)."""
    Wc = expand_coef_matrix(coef, prows)
    rows = tabc_s.shape[0]
    tw = torch.cat([tabc_s, tabd_s]) @ Wc                 # (2 rows, P)
    return tw.reshape(2, rows, -1).transpose(1, 2).reshape(-1, rows)


@dataclass(frozen=True)
class SphereKernelParams:
    """Static geometry of the sphere kernels (exp_tpu's kernel-maker
    arguments): nc spline nodes over [xmin, xmin + (nc-1) dxc] in xi,
    mass support rmin <= r/scale <= rmax, radial map (cmap, rmap)."""

    lmax: int
    nmax: int
    nc: int
    xmin: float
    dxc: float
    rmin: float
    rmax: float
    cmap: int
    rmap: float
    scale: float

    @property
    def rows(self):
        return self.nc + 2


# ---------------------------------------------------------------------------
# plain PyTorch versions (the same math in tensor ops)
# ---------------------------------------------------------------------------

def _ximap(rs, prm):
    if prm.cmap == 1:
        return (rs / prm.rmap - 1.0) / (rs / prm.rmap + 1.0)
    return rs


def _spline_matrix(xi, prm):
    """Dense (n, nc + 2) quadratic-B-spline weights b2(j - 1 - t)."""
    t = torch.clamp((xi - prm.xmin) / prm.dxc, 0.0, prm.nc - 1.0)
    j = torch.arange(prm.rows, dtype=xi.dtype, device=xi.device)
    return b2(j[None, :] - 1.0 - t[:, None])


def _monomials(lmax, ux, uy, uz):
    """mono(u) columns (n, n_mono) built degree at a time
    (solidharm.monomial_build_plan)."""
    from exp_tpu_torch.ops.solidharm import monomial_build_plan

    u = [ux, uy, uz]
    cols = [torch.ones_like(ux)]
    if lmax >= 1:
        cols += [ux, uy, uz]
    for dst, s_mono, s_u in monomial_build_plan(lmax):
        for k in range(len(dst)):
            cols.append(cols[s_mono[k]] * u[s_u[k]])
    return torch.stack(cols, dim=1)


def sphere_coef_plain(x, mass, tab, M, prm: SphereKernelParams,
                      chunk: int = 65536):
    """Plain version of K1: coefficients (2, L+1, L+1, nmax) f32 of
    particles x (N, 3), mass (N,) against the spline table tab
    (nc + 2, F) and the monomial matrix M (P, n_mono)."""
    lmax, nmax = prm.lmax, prm.nmax
    prows = packed_rows(lmax)
    YW = torch.zeros((len(prows), prm.rows), dtype=torch.float32,
                     device=x.device)
    for s in range(0, x.shape[0], chunk):
        xs = x[s:s + chunk].to(torch.float32)
        m = mass[s:s + chunk].to(torch.float32)
        x0, x1, x2 = xs[:, 0], xs[:, 1], xs[:, 2]
        r = torch.sqrt(x0 * x0 + x1 * x1 + x2 * x2) + 1e-10
        rs = r / prm.scale
        w = torch.where((rs >= prm.rmin) & (rs <= prm.rmax), m,
                        torch.zeros_like(m))
        u = xs * (1.0 / r)[:, None]
        mono = _monomials(lmax, u[:, 0], u[:, 1], u[:, 2])
        Y = (mono @ M.T) * w[:, None]                     # (n, P)
        YW += Y.T @ _spline_matrix(_ximap(rs, prm), prm)
    big = YW @ tab                                        # (P, F)
    out = torch.zeros((2, lmax + 1, lmax + 1, nmax), dtype=torch.float32,
                      device=x.device)
    for p, (cs, l, mm) in enumerate(prows):
        out[cs, l, mm] = big[p, l * nmax:(l + 1) * nmax]
    return -4.0 * math.pi * out


def sphere_accel_plain(x, twT, fac, prm: SphereKernelParams,
                       chunk: int = 65536):
    """Plain version of K2: (acc (N, 3), pot (N,)) f32 at x (N, 3) from the
    coefficient-contracted table twT (2P, nc + 2) and fac (L+1, L+1)."""
    accs, pots = [], []
    for s in range(0, x.shape[0], chunk):
        a, p = _accel_chunk_plain(x[s:s + chunk].to(torch.float32), twT,
                                  fac.to(torch.float32), prm)
        accs.append(a)
        pots.append(p)
    if not accs:
        return (torch.empty((0, 3), dtype=torch.float32, device=x.device),
                torch.empty((0,), dtype=torch.float32, device=x.device))
    return torch.cat(accs), torch.cat(pots)


def _accel_chunk_plain(xs, twT, fac, prm):
    from exp_tpu_torch.ops.special import _legendre_lists

    lmax = prm.lmax
    prows = packed_rows(lmax)
    P = len(prows)
    eps = 1e-10
    x, y, z = xs[:, 0], xs[:, 1], xs[:, 2]
    r = torch.sqrt(x * x + y * y + z * z) + eps
    R = torch.sqrt(x * x + y * y) + eps
    costh, cphi, sphi = z / r, x / R, y / R
    rs = r / prm.scale
    rb = prm.rmax * prm.scale
    outside = r > rb
    xi = _ximap(torch.clamp(rs, max=prm.rmax), prm)

    # f32 pole clamp: 1 - 1e-12 would round back to 1 and 1/(x^2-1) overflow
    peps = 1e-6
    xc = torch.clamp(costh, -1.0 + peps, 1.0 - peps)
    Pl = _legendre_lists(lmax, xc)
    inv = 1.0 / (xc * xc - 1.0)
    dP = {}
    for l in range(lmax + 1):
        for mm in range(l + 1):
            if l == 0:
                dP[(l, mm)] = torch.zeros_like(xc)
            elif l == mm:
                dP[(l, mm)] = inv * (l * xc * Pl[l][mm])
            else:
                dP[(l, mm)] = inv * (l * xc * Pl[l][mm]
                                     - (l + mm) * Pl[l - 1][mm])
    cm, sm = [torch.ones_like(cphi)], [torch.zeros_like(sphi)]
    for _ in range(lmax):
        cm.append(cm[-1] * cphi - sm[-1] * sphi)
        sm.append(sm[-1] * cphi + cm[-2] * sphi)

    if prm.cmap == 1:
        dxidr = 0.5 * (1.0 - xi) * (1.0 - xi) / prm.rmap
    else:
        dxidr = torch.ones_like(xi)
    pcd = _spline_matrix(xi, prm) @ twT.T                 # (n, 2P)
    pc = pcd[:, :P]
    dpc = pcd[:, P:] * dxidr[:, None]

    base = torch.where(outside, rb / r, torch.ones_like(r))
    att = [base]
    for _ in range(lmax):
        att.append(att[-1] * base)

    potl = torch.zeros_like(r)
    potr = torch.zeros_like(r)
    pott = torch.zeros_like(r)
    potp = torch.zeros_like(r)
    for row, (cs, l, mm) in enumerate(prows):
        trig = cm if cs == 0 else sm
        a = att[l]
        pcv = pc[:, row] * a
        dpv = torch.where(outside, -(l + 1.0) / rs * pcv, dpc[:, row] * a)
        fl = fac[l, mm] * Pl[l][mm]
        fd = fac[l, mm] * dP[(l, mm)]
        tg = trig[mm]
        potl += fl * pcv * tg
        potr += fl * dpv * tg
        pott += fd * pcv * tg
        if mm:
            og = sm[mm] if cs == 0 else cm[mm]
            sgn = -1.0 if cs == 0 else 1.0
            potp += sgn * mm * fac[l, mm] * Pl[l][mm] * pcv * og

    potr = potr / (prm.scale * prm.scale)
    potl = potl / prm.scale
    pott = pott / prm.scale
    potp = potp / prm.scale

    r3 = r * r * r
    rho2 = x * x + y * y
    ax = -(potr * x / r - pott * x * z / r3)
    ay = -(potr * y / r - pott * y * z / r3)
    az = -(potr * z / r + pott * rho2 / r3)
    safe = rho2 > eps
    zero = torch.zeros_like(ax)
    ax = ax + torch.where(safe, potp * y / rho2, zero)
    ay = ay - torch.where(safe, potp * x / rho2, zero)
    return torch.stack([ax, ay, az], dim=1), potl


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong


def _check_prm(prm):
    if prm.lmax not in KERNEL_LMAX:
        raise ValueError(f"lmax={prm.lmax}: the sphere kernels are built "
                         f"for lmax {KERNEL_LMAX.start}..{KERNEL_LMAX.stop - 1}")
    if prm.cmap not in (0, 1):
        raise ValueError(f"cmap={prm.cmap}: the sphere kernels take the "
                         "identity (0) and algebraic (1) maps")


def sphere_coef(x, mass, tab, M, prm: SphereKernelParams):
    """K1: sphere coefficients (2, L+1, L+1, nmax) f32.

    x (N, 3), mass (N,), tab (nc + 2, F) spline table, M (P, n_mono);
    all f32.  CPU tensors take sphere_coef_plain; CUDA tensors launch
    csrc/sphere_coef.cu."""
    if x.device.type == "cpu":
        return sphere_coef_plain(x, mass, tab, M, prm)
    if x.device.type != "cuda":
        raise ValueError(f"sphere_coef: unsupported device {x.device}")
    _check_prm(prm)
    n = x.shape[0]
    lmax, nmax = prm.lmax, prm.nmax
    P = (lmax + 1) ** 2
    dev = x.device
    _build.check_tensor(x, "x", (n, 3), dev)
    _build.check_tensor(mass, "mass", (n,), dev)
    _build.check_tensor(tab, "tab", (prm.rows, (lmax + 1) * nmax), dev)
    _build.check_tensor(M, "M",
                        (P, (lmax + 1) * (lmax + 2) * (lmax + 3) // 6), dev)
    fn, err = _build.bind("sphere_coef", [_P, _P, _LL, _P, _P, _P, _I, _P,
                                          _I, _I, _I, _I, _F, _F, _F, _F, _F,
                                          _F, _P])
    nblocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty((nblocks, P, prm.rows), dtype=torch.float32,
                          device=dev)
    coef = torch.empty((2, lmax + 1, lmax + 1, nmax), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), mass.data_ptr(), n, M.data_ptr(),
                  tab.data_ptr(), partial.data_ptr(), nblocks,
                  coef.data_ptr(), lmax, nmax, prm.nc, prm.cmap, prm.xmin,
                  prm.dxc, prm.rmin, prm.rmax, prm.rmap, prm.scale, stream)
    _build.raise_on(code, err, "sphere_coef")
    launch_counts["sphere_coef"] += 1
    return coef


def sphere_accel(x, twT, fac, prm: SphereKernelParams):
    """K2: sphere force (acc (N, 3), pot (N,)) f32.

    x (N, 3), twT (2P, nc + 2) from contract_coef_table2, fac (L+1, L+1);
    all f32.  CPU tensors take sphere_accel_plain; CUDA tensors launch
    csrc/sphere_accel.cu."""
    if x.device.type == "cpu":
        return sphere_accel_plain(x, twT, fac, prm)
    if x.device.type != "cuda":
        raise ValueError(f"sphere_accel: unsupported device {x.device}")
    _check_prm(prm)
    n = x.shape[0]
    lmax = prm.lmax
    dev = x.device
    _build.check_tensor(x, "x", (n, 3), dev)
    _build.check_tensor(twT, "twT", (2 * (lmax + 1) ** 2, prm.rows), dev)
    _build.check_tensor(fac, "fac", (lmax + 1, lmax + 1), dev)
    fn, err = _build.bind("sphere_accel", [_P, _LL, _P, _P, _P, _P, _I, _I,
                                           _I, _I, _F, _F, _F, _F, _F, _F, _F,
                                           _P])
    acc = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pot = torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), n, twT.data_ptr(), fac.data_ptr(),
                  acc.data_ptr(), pot.data_ptr(), lmax, prm.nmax, prm.nc,
                  prm.cmap, prm.xmin, prm.dxc, prm.rmin, prm.rmax,
                  prm.rmap, prm.scale, prm.rmax * prm.scale, stream)
    _build.raise_on(code, err, "sphere_accel")
    launch_counts["sphere_accel"] += 1
    return acc, pot
