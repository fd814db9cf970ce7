"""Sphere coefficient (K1, K3) and force (K2, K6) passes: CUDA kernels for
Hopper, their plain PyTorch versions, and the host glue around them.

Port of exp_tpu/ops/pallas_sphere.py, for the 'spline' and 'hat'
interpolations:

  K1 `sphere_coef`        replaces make_coef_kernel_poly  (csrc/sphere_coef.cu)
  K2 `sphere_accel`       replaces make_accel_kernel      (csrc/sphere_accel.cu)
  K3 `sphere_coef_rec`    replaces make_coef_kernel       (csrc/sphere_coef_rec.cu)
  K6 `sphere_accel_poly`  replaces make_accel_kernel_poly (csrc/sphere_accel_poly.cu)

K1 and K6 evaluate the harmonics as polynomials in the unit vector
('poly'), K3 and K2 by the Legendre and trig recurrences ('recurrence').
Both pairs are built for lmax 0..10 (POLY_LMAX, REC_LMAX).  K1 has two
forms: one (P, rows) accumulator a block at lmax 0..6 (K1_ONE_LMAX) where
it fits, and the packed rows split into groups over the grid's second
dimension otherwise (k1_plan).  The kernels read x (N, 3) and mass (N,)
as they are and mask their own ragged tail: the TPU's transposed (8, N)
layout, its 4096-particle blocks and its lane padding of tables (C1, Fp)
are not carried over.  Each wrapper takes its plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
`launch_counts` counts kernel launches, one per wrapper call that reaches
the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from exp_tpu_torch.ops import _build
from exp_tpu_torch.ops.spline import b2

#: launches of each kernel since the last reset (only kernel launches count)
launch_counts = {"sphere_coef": 0, "sphere_accel": 0, "sphere_coef_rec": 0,
                 "sphere_accel_poly": 0}

#: the lmax values each kernel is built for: the poly kernels K1 and K6,
#: and the recurrence kernels K3 and K2
POLY_LMAX = range(0, 11)
REC_LMAX = range(0, 11)
#: the lmax of K1's one-accumulator form (csrc/sphere_coef.cu); above, and
#: where its accumulator does not fit a block, K1 splits the rows
K1_ONE_LMAX = range(0, 7)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def packed_rows(lmax):
    """Valid (cs, l, m) harmonic rows in packed order: cos for m <= l,
    then sin for 1 <= m <= l ((lmax+1)^2 rows)."""
    rows = [(0, l, m) for l in range(lmax + 1) for m in range(l + 1)]
    rows += [(1, l, m) for l in range(lmax + 1) for m in range(1, l + 1)]
    return rows


def _harmonic_rows(lmax) -> np.ndarray:
    """solidharm.harmonic_matrix's packed rows (f64) with the entries
    outside k1_support, and the f64 noise within it, set to 0 (_drop_noise).
    Symmetry makes the entries outside k1_support 0, and the fit leaves
    noise there only from lmax 10 on (167 entries, under 3e-14 of their
    row's largest; 3e-12 of |Y|), which would break the parity structure
    the kernels unroll."""
    from exp_tpu_torch.ops.solidharm import harmonic_matrix

    return _drop_noise(np.where(
        k1_support(lmax), harmonic_matrix(lmax, tuple(packed_rows(lmax))),
        0.0))


def _drop_noise(rows) -> np.ndarray:
    """rows (f64) with the entries under 1e-12 of their row's largest set
    to 0: f64 noise of the fit and of its products M D_j, whose size and
    sign vary with the BLAS's summation order (13 entries of the stack at
    lmax 10, near 1e-15 of their row; below lmax 10 every nonzero is above
    1e-4 of its row), so that K6's pattern, k6_support, is the same in
    every process."""
    big = np.abs(rows).max(axis=1, keepdims=True)
    return np.where(np.abs(rows) < 1e-12 * big, 0.0, rows)


def poly_matrix(lmax, fac_np=None) -> np.ndarray:
    """M (P, n_mono) f32 with M[p] . mono(u) = fac[l,m] P_lm {cos,sin}(m phi)
    for the packed rows p, rescaled to a custom `fac_np` when given (the
    matrix is linear in fac).  Unpadded: the kernel skips the structural
    zeros itself (exp_tpu's _poly_matrices pads to (C1, NMp))."""
    from exp_tpu_torch.ops.solidharm import standard_fac

    prows = packed_rows(lmax)
    M = _harmonic_rows(lmax)
    if fac_np is not None:
        fac_np = np.asarray(fac_np)
        ratio = np.array([fac_np[l, m] / standard_fac(l, m)
                          for (cs, l, m) in prows])[:, None]
        M = M * ratio
    return np.ascontiguousarray(M, dtype=np.float32)


def poly_support(lmax) -> np.ndarray:
    """(4P, n_mono) bool: the entries of the [M; Mx; My; Mz] stack that
    degree and parity allow.  A value row of degree l is fit on the
    monomials of degree <= l and of l's parity; its gradient rows on
    degree <= l - 1 and the other parity.  A superset of k6_support (886
    entries against 215 at lmax 4)."""
    from exp_tpu_torch.ops.solidharm import monomial_exponents

    deg = np.array([sum(e) for e in monomial_exponents(lmax)])
    ls = np.array([l for (_, l, _) in packed_rows(lmax)])[:, None]
    val = (deg[None, :] <= ls) & ((ls - deg[None, :]) % 2 == 0)
    grad = (deg[None, :] <= ls - 1) & ((ls - 1 - deg[None, :]) % 2 == 0)
    return np.concatenate([val, grad, grad, grad])


def poly_matrix_stack(lmax, fac_np=None) -> np.ndarray:
    """[M; Mx; My; Mz] (4P, n_mono) f32: the value rows of poly_matrix and
    their d/du_j rows M D_j (exp_tpu's _poly_matrices(accel=True),
    unpadded), rescaled to a custom `fac_np` when given.  Raises if any
    entry outside poly_support is nonzero."""
    from exp_tpu_torch.ops.solidharm import derivative_matrices, standard_fac

    prows = packed_rows(lmax)
    M, D = _harmonic_rows(lmax), derivative_matrices(lmax)
    mats = [M] + [_drop_noise(M @ D[j]) for j in range(3)]
    if fac_np is not None:
        fac_np = np.asarray(fac_np)
        ratio = np.array([fac_np[l, m] / standard_fac(l, m)
                          for (cs, l, m) in prows])[:, None]
        mats = [a * ratio for a in mats]
    Ms = np.ascontiguousarray(np.concatenate(mats), dtype=np.float32)
    skipped = np.count_nonzero(Ms[~poly_support(lmax)])
    if skipped:
        raise ValueError(f"poly_matrix_stack: {skipped} nonzero entries lie "
                         "outside poly_support")
    return Ms


#: the header of K6's nonzero pattern under csrc/, written by k6_header
K6_HEADER = "sphere_poly_support.cuh"


def k6_support(lmax) -> np.ndarray:
    """(4P, n_mono) bool: the entries of the [M; Mx; My; Mz] stack that K6
    multiplies, the nonzeros of poly_matrix_stack(lmax) (215 at lmax 4,
    941 at 6).  The pattern is structural: a custom fac rescales whole
    rows.  csrc/sphere_poly_support.cuh holds it (k6_header)."""
    return poly_matrix_stack(lmax) != 0


def k6_header() -> str:
    """The text of csrc/sphere_poly_support.cuh: for each lmax of
    POLY_LMAX, k6_support (PolySupport, K6's pattern) and k1_support
    (CoefSupport, the pattern of K1's split form) as compressed rows (the
    first entry of each row, then each entry's monomial), which the kernels
    unroll at compile time.  `python -m exp_tpu_torch.gen_k6_support`
    writes it."""
    def ints(v, indent):
        items = [f"{int(a)}" for a in v]
        out, line = [], indent
        for k, s in enumerate(items):
            s += "," if k + 1 < len(items) else ""
            if len(line) + len(s) > 88:
                out.append(line.rstrip())
                line = indent
            line += s + " "
        return "\n".join(out + [line.rstrip()])

    def pattern(name, L, sup):
        start = np.concatenate([[0], np.cumsum(sup.sum(axis=1))])
        col = np.nonzero(sup)[1]
        return (f"\ntemplate <>\nstruct {name}<{L}> {{\n"
                f"  static constexpr int kNnz = {len(col)};\n"
                f"  static constexpr int start[{len(start)}] = {{\n"
                f"{ints(start, '      ')}}};\n"
                f"  static constexpr int col[{len(col)}] = {{\n"
                f"{ints(col, '      ')}}};\n}};\n")

    parts = [
        "// The nonzero patterns of K6's [M; Mx; My; Mz] stack "
        "(PolySupport,\n"
        "// csrc/sphere_accel_poly.cu) and of K1's M (CoefSupport, the split "
        "form of\n"
        "// csrc/sphere_coef.cu), per lmax: the first entry of each row, then "
        "each\n"
        "// entry's monomial, in row-major order.  Generated from\n"
        "// ops/sphere_kernels.k6_support and k1_support by `python -m\n"
        "// exp_tpu_torch.gen_k6_support`; do not edit.\n"
        "#pragma once\n\nnamespace sphere {\n\ntemplate <int L>\n"
        "struct PolySupport;\n"]
    parts += [pattern("PolySupport", L, k6_support(L)) for L in POLY_LMAX]
    parts.append("\ntemplate <int L>\nstruct CoefSupport;\n")
    parts += [pattern("CoefSupport", L, k1_support(L)) for L in POLY_LMAX]
    parts.append("\n}  // namespace sphere\n")
    return "".join(parts)


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


def contract_coef_table(coef, tabc, prows):
    """The hat interpolation's pot table (numr_c, F) contracted with the
    coefficients -> twT (P, numr_c) f32, the force kernels' one-block
    table (exp_tpu's contract_coef_table_jit).  TF32 off on CUDA, as for
    contract_coef_table2."""
    return (tabc.to(torch.float32) @ expand_coef_matrix(coef, prows)).T.contiguous()


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
    arguments): nc radial nodes over [xmin, xmin + (nc-1) dxc] in xi, mass
    support rmin <= r/scale <= rmax, radial map (cmap, rmap), and the
    interpolation, 'spline' or 'hat'."""

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
    interp: str

    @property
    def rows(self):
        """Radial table rows: nc + 2 ghosted spline coefficients, or nc
        node values for 'hat'."""
        return self.nc + 2 if self.interp == "spline" else self.nc


# ---------------------------------------------------------------------------
# plain PyTorch versions (the same math in tensor ops)
# ---------------------------------------------------------------------------

def _ximap(rs, prm):
    if prm.cmap == 1:
        xs = _build.div_f32(rs, prm.rmap)
        return (xs - 1.0) / (xs + 1.0)
    return rs


def _grid_t(xi, prm):
    return torch.clamp(_build.div_f32(xi - prm.xmin, prm.dxc), 0.0,
                       prm.nc - 1.0)


def _weight_matrix(xi, prm):
    """Dense (n, rows) radial weights: the quadratic B-spline
    b2(j - 1 - t) against the nc + 2 ghosted rows, or the hat
    max(0, 1 - |j - t|) against the nc node rows (_spline_rows,
    _hat_rows)."""
    t = _grid_t(xi, prm)
    j = torch.arange(prm.rows, dtype=xi.dtype, device=xi.device)
    if prm.interp == "spline":
        return b2(j[None, :] - 1.0 - t[:, None])
    return torch.clamp(1.0 - torch.abs(j[None, :] - t[:, None]), min=0.0)


def _hat_cell(xi, prm):
    """The hat cell j0 = clip(floor t, 0, nc - 2) (int64) and the weights
    max(0, 1 - |j - t|) at its nodes j0, j0 + 1 (every other node weighs
    0); the cell also carries the derivative, +-1/dxc at j0 + 1 and j0
    (_hat_rows)."""
    t = _grid_t(xi, prm)
    fl = torch.clamp(torch.floor(t), 0.0, prm.nc - 2.0)
    w0 = torch.clamp(1.0 - torch.abs(fl - t), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs((fl + 1.0) - t), min=0.0)
    return fl.long(), w0, w1


def _interp_rows(xi, twT, prm):
    """(pc, dpc) (n, P) each: twT interpolated at xi, dpc the raw d/dxi.
    'spline': the dense weights against the pot and the tabulated
    derivative rows.  'hat': the two nodes of the cell, and their
    difference over dxc with each product rounded on its own, as the
    kernels round it (T1/dxc and T0/dxc nearly cancel, so a dense product
    that rounds them in another order moves dpc by ~1e-5 of itself)."""
    if prm.interp == "spline":
        P = twT.shape[0] // 2
        pcd = _weight_matrix(xi, prm) @ twT.T                 # (n, 2P)
        return pcd[:, :P], pcd[:, P:]
    j0, w0, w1 = _hat_cell(xi, prm)
    t0, t1 = twT.T[j0], twT.T[j0 + 1]                        # (n, P)
    idx = float(np.float32(1.0) / np.float32(prm.dxc))
    return (w0[:, None] * t0 + w1[:, None] * t1,
            t0 * -idx + t1 * idx)


def _radius(x0, x1, x2):
    return torch.sqrt(x0 * x0 + x1 * x1 + x2 * x2) + 1e-10


def _trig_lists(lmax, cphi, sphi):
    """cos(m phi), sin(m phi) for m = 0..lmax by angle addition
    (_trig_rows)."""
    cm, sm = [torch.ones_like(cphi)], [torch.zeros_like(sphi)]
    for _ in range(lmax):
        cm.append(cm[-1] * cphi - sm[-1] * sphi)
        sm.append(sm[-1] * cphi + cm[-2] * sphi)
    return cm, sm


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


def _coef_plain(x, mass, tab, prm, angular, chunk):
    """The coefficient pass with the angular rows Y (n, P) from
    `angular(xs, r, w)`: S = sum_i Y_i W_i, then the table contraction."""
    lmax, nmax = prm.lmax, prm.nmax
    prows = packed_rows(lmax)
    YW = torch.zeros((len(prows), prm.rows), dtype=torch.float32,
                     device=x.device)
    for s in range(0, x.shape[0], chunk):
        xs = x[s:s + chunk].to(torch.float32)
        m = mass[s:s + chunk].to(torch.float32)
        r = _radius(xs[:, 0], xs[:, 1], xs[:, 2])
        rs = _build.div_f32(r, prm.scale)
        w = torch.where((rs >= prm.rmin) & (rs <= prm.rmax), m,
                        torch.zeros_like(m))
        Y = angular(xs, r, w)                                 # (n, P)
        YW += Y.T @ _weight_matrix(_ximap(rs, prm), prm)
    big = YW @ tab.to(torch.float32)                          # (P, F)
    out = torch.zeros((2, lmax + 1, lmax + 1, nmax), dtype=torch.float32,
                      device=x.device)
    for p, (cs, l, mm) in enumerate(prows):
        out[cs, l, mm] = big[p, l * nmax:(l + 1) * nmax]
    return -4.0 * math.pi * out


def sphere_coef_plain(x, mass, tab, M, prm: SphereKernelParams,
                      chunk: int = 65536):
    """Plain version of K1: coefficients (2, L+1, L+1, nmax) f32 of
    particles x (N, 3), mass (N,) against the radial table tab (rows, F)
    and the monomial matrix M (P, n_mono)."""
    def angular(xs, r, w):
        u = xs * (1.0 / r)[:, None]
        mono = _monomials(prm.lmax, u[:, 0], u[:, 1], u[:, 2])
        return (mono @ M.T) * w[:, None]

    return _coef_plain(x, mass, tab, prm, angular, chunk)


def sphere_coef_rec_plain(x, mass, tab, fac, prm: SphereKernelParams,
                          chunk: int = 65536):
    """Plain version of K3: K1's coefficients with the angular rows
    w fac[l,m] P_lm(cos th) {cos, sin}(m phi) from the Legendre and trig
    recurrences; fac (L+1, L+1)."""
    from exp_tpu_torch.ops.special import _legendre_lists

    fac = fac.to(torch.float32)
    prows = packed_rows(prm.lmax)

    def angular(xs, r, w):
        x0, x1, x2 = xs[:, 0], xs[:, 1], xs[:, 2]
        R = torch.sqrt(x0 * x0 + x1 * x1) + 1e-10
        Pl = _legendre_lists(prm.lmax, x2 / r)
        cm, sm = _trig_lists(prm.lmax, x0 / R, x1 / R)
        return torch.stack([w * fac[l, mm] * Pl[l][mm]
                            * (cm[mm] if cs == 0 else sm[mm])
                            for cs, l, mm in prows], dim=1)

    return _coef_plain(x, mass, tab, prm, angular, chunk)


def _chunked_accel(chunk_fn, x, chunk):
    accs, pots = [], []
    for s in range(0, x.shape[0], chunk):
        a, p = chunk_fn(x[s:s + chunk].to(torch.float32))
        accs.append(a)
        pots.append(p)
    if not accs:
        return (torch.empty((0, 3), dtype=torch.float32, device=x.device),
                torch.empty((0,), dtype=torch.float32, device=x.device))
    return torch.cat(accs), torch.cat(pots)


def _radial_geometry(xs, prm):
    """r, rs, outside r_b, xi at min(rs, rmax) and d xi / dr."""
    r = _radius(xs[:, 0], xs[:, 1], xs[:, 2])
    rs = _build.div_f32(r, prm.scale)
    outside = r > prm.rmax * prm.scale
    xi = _ximap(torch.clamp(rs, max=prm.rmax), prm)
    if prm.cmap == 1:
        dxidr = 0.5 * (1.0 - xi) * (1.0 - xi) / prm.rmap
    else:
        dxidr = torch.ones_like(xi)
    return r, rs, outside, xi, dxidr


def sphere_accel_plain(x, twT, fac, prm: SphereKernelParams,
                       chunk: int = 65536):
    """Plain version of K2: (acc (N, 3), pot (N,)) f32 at x (N, 3) from the
    coefficient-contracted table twT ((2P, nc + 2) 'spline', (P, nc)
    'hat') and fac (L+1, L+1)."""
    return _chunked_accel(
        lambda xs: _accel_chunk_plain(xs, twT, fac.to(torch.float32), prm),
        x, chunk)


def _accel_chunk_plain(xs, twT, fac, prm):
    from exp_tpu_torch.ops.special import _legendre_lists

    lmax = prm.lmax
    prows = packed_rows(lmax)
    eps = 1e-10
    x, y, z = xs[:, 0], xs[:, 1], xs[:, 2]
    r, rs, outside, xi, dxidr = _radial_geometry(xs, prm)
    R = torch.sqrt(x * x + y * y) + eps
    costh, cphi, sphi = z / r, x / R, y / R
    rb = prm.rmax * prm.scale

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
    cm, sm = _trig_lists(lmax, cphi, sphi)

    pc, dpc = _interp_rows(xi, twT, prm)
    dpc = dpc * dxidr[:, None]

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


def sphere_accel_poly_plain(x, twT, Ms, prm: SphereKernelParams,
                            chunk: int = 65536):
    """Plain version of K6: (acc (N, 3), pot (N,)) f32 at x (N, 3) from
    K2's table twT and the stack Ms (4P, n_mono) of poly_matrix_stack:
    [Y; Gx; Gy; Gz] = Ms mono(u), the radial rows g, dg with the
    (r_b/r)^(l+1) continuation, and acc = -(u R / scale^2 + (T - u (u.T))
    / (r scale))."""
    return _chunked_accel(
        lambda xs: _accel_poly_chunk_plain(xs, twT, Ms, prm), x, chunk)


def _accel_poly_chunk_plain(xs, twT, Ms, prm):
    lmax = prm.lmax
    P = (lmax + 1) ** 2
    r, rs, outside, xi, dxidr = _radial_geometry(xs, prm)
    pc, dpc = _interp_rows(xi, twT, prm)
    dpc = dpc * dxidr[:, None]

    rb = prm.rmax * prm.scale
    base = torch.where(outside, rb / r, torch.ones_like(r))
    att = [base]
    for _ in range(lmax):
        att.append(att[-1] * base)
    row_l = [l for (_, l, _) in packed_rows(lmax)]
    attC = torch.stack([att[l] for l in row_l], dim=1)          # (n, P)
    attD = torch.stack([(l + 1.0) * att[l] for l in row_l], dim=1)
    g = pc * attC
    dg = torch.where(outside[:, None], -pc * attD / rs[:, None], dpc * attC)

    rinv = 1.0 / r
    ux, uy, uz = xs[:, 0] * rinv, xs[:, 1] * rinv, xs[:, 2] * rinv
    YG = _monomials(lmax, ux, uy, uz) @ Ms.T                    # (n, 4P)
    Y = YG[:, :P]
    potl = (Y * g).sum(1)
    Tx = (YG[:, P:2 * P] * g).sum(1)
    Ty = (YG[:, 2 * P:3 * P] * g).sum(1)
    Tz = (YG[:, 3 * P:] * g).sum(1)
    R = (Y * dg).sum(1)

    uT = ux * Tx + uy * Ty + uz * Tz
    s2inv = 1.0 / (prm.scale * prm.scale)
    rsinv = rinv / prm.scale
    ax = -(ux * R * s2inv + (Tx - ux * uT) * rsinv)
    ay = -(uy * R * s2inv + (Ty - uy * uT) * rsinv)
    az = -(uz * R * s2inv + (Tz - uz * uT) * rsinv)
    return torch.stack([ax, ay, az], dim=1), potl / prm.scale


def hat_node_points(prm: SphereKernelParams, nodes, window=256):
    """Points (len(nodes), 3) f32 on the x axis whose grid position t is
    exactly a hat node, as the plain versions (and the kernels, which round
    t step by step alike) compute it: for each of `nodes`, the first node
    from it up that some f32 radius within `window` ulps hits.  At a node
    the hat cell, and with it the derivative, changes: the points hold both
    rounding paths to the same cell."""
    def hit(k):
        xi = prm.xmin + k * prm.dxc
        rs = prm.rmap * (1.0 + xi) / (1.0 - xi) if prm.cmap == 1 else xi
        up = down = np.float32(rs * prm.scale)
        cand = [up]
        for _ in range(window):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(0.0))
            cand += [up, down]
        xs = torch.tensor(np.array(cand, dtype=np.float32))
        zero = torch.zeros_like(xs)
        rs = _build.div_f32(_radius(xs, zero, zero), prm.scale)
        t = _grid_t(_ximap(rs, prm), prm)
        on = torch.nonzero(t == float(k)).flatten()
        return float(xs[on[0]]) if on.numel() else None

    pts = []
    for k in nodes:
        r = next((r for kk in range(k, prm.nc) if (r := hit(kk)) is not None),
                 None)
        if r is None:
            raise ValueError(f"no f32 radius puts t exactly on a node >= {k}")
        pts.append([r, 0.0, 0.0])
    return np.array(pts, dtype=np.float32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

_KERNEL_LMAX = {"sphere_coef": POLY_LMAX, "sphere_accel_poly": POLY_LMAX,
                "sphere_coef_rec": REC_LMAX, "sphere_accel": REC_LMAX}


def check_params(prm: SphereKernelParams, name: str) -> None:
    """Raise ValueError for a setting kernel `name` is not built for: lmax
    outside its range, a map other than cmap 0 and 1, an interpolation
    other than 'spline' and 'hat'."""
    lr = _KERNEL_LMAX[name]
    if prm.lmax not in lr:
        raise ValueError(f"lmax={prm.lmax}: {name} is built for lmax "
                         f"{lr.start}..{lr.stop - 1}")
    if prm.cmap not in (0, 1):
        raise ValueError(f"cmap={prm.cmap}: the sphere kernels take the "
                         "identity (0) and algebraic (1) maps")
    if prm.interp not in ("spline", "hat"):
        raise ValueError(f"interp={prm.interp!r}: the sphere kernels take "
                         "'spline' and 'hat'")


def _twt_rows(prm):
    return 2 * (prm.lmax + 1) ** 2 if prm.interp == "spline" else (prm.lmax + 1) ** 2


def _geometry_args(prm):
    return (prm.lmax, prm.nmax, prm.nc, prm.cmap, prm.xmin, prm.dxc, prm.rmin,
            prm.rmax, prm.rmap, prm.scale)


_GEOM = [_I, _I, _I, _I, _F, _F, _F, _F, _F, _F]


def _launch(name, argtypes, args, dev):
    fn, err = _build.bind(name, argtypes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*args, stream)
    _build.raise_on(code, err, name)
    launch_counts[name] += 1


def _coef_inputs(x, mass, tab, prm, name):
    check_params(prm, name)
    n, dev = x.shape[0], x.device
    _build.check_tensor(x, "x", (n, 3), dev)
    _build.check_tensor(mass, "mass", (n,), dev)
    _build.check_tensor(tab, "tab", (prm.rows, (prm.lmax + 1) * prm.nmax), dev)
    return n, dev


def k1_support(lmax) -> np.ndarray:
    """(P, n_mono) bool: the entries of M that K1 multiplies.  Row (cs, l,
    m) of M is fit on the monomials of degree <= l, and the harmonic is
    even or odd under x -> -x, y -> -y and z -> -z, so its monomials
    x^i y^j z^k have i = m + cs, j = cs and k = l + m (mod 2)."""
    return _k1_support(lmax).copy()


@functools.lru_cache(maxsize=None)
def _k1_support(lmax) -> np.ndarray:
    from exp_tpu_torch.ops.solidharm import monomial_exponents

    rows = packed_rows(lmax)
    sup = np.zeros((len(rows), len(monomial_exponents(lmax))), dtype=bool)
    for p, (cs, l, m) in enumerate(rows):
        for k, (i, j, kz) in enumerate(monomial_exponents(lmax)):
            sup[p, k] = (i + j + kz <= l and (i - m - cs) % 2 == 0
                         and (j - cs) % 2 == 0 and (kz - l - m) % 2 == 0)
    return sup


@dataclass(frozen=True)
class SphereCoefPlan:
    """K1's launch: `nblocks` blocks of `nw` warps and `smem` bytes of
    shared memory a block.  With no `qstart`, the one-accumulator form:
    one block writes the coefficients itself, several write partials that
    a second kernel sums.  With `qstart`, the split form: the packed rows
    [qstart[g], qstart[g + 1]) go to group g of nblocks blocks, and the
    partials of every group and block to a second kernel of
    `finish_threads` threads (its table slice staged when
    `finish_staged`), unless one block holds all the rows."""

    nw: int
    nblocks: int
    smem: int
    qstart: tuple = ()
    finish_threads: int = 0
    finish_staged: bool = False


#: K1's warps a block, and the threads a block of its second kernel
#: (csrc/sphere_coef.cu)
K1_WARPS = 16
K1_FINISH_THREADS = 1024


def k1_smem(prm: SphereKernelParams, nw: int) -> int:
    """K1's shared memory a block of nw warps, as csrc/sphere_coef.cu lays
    it out in its one-accumulator form: each warp's stage (32 x (4 weights
    + P rows, P rounded up to odd)), the block's (P, rows | 1) i32
    accumulator and nw f32 sums.  The split form: k1_split_smem."""
    P = (prm.lmax + 1) ** 2
    return 4 * (nw * 32 * (4 + (P | 1)) + P * (prm.rows | 1) + nw)


def k1_split_smem(prm: SphereKernelParams, nw: int, R: int) -> int:
    """The shared memory of K1's split form, a block of nw warps whose
    group has R rows: K3's layout (k3_smem) and each lane's unit vector
    and mass (a float4), which the rows of each chunk of 32 are made
    from."""
    return k3_smem(prm, nw, R) + 16 * 32 * nw


@functools.lru_cache(maxsize=1024)
def k1_plan(n, prm: SphereKernelParams, sm_count, smem_optin,
            smem_per_sm) -> SphereCoefPlan:
    """K1's launch plan for n rows.  At lmax 0..6 (K1_ONE_LMAX), where one
    warp's stage and the (P, rows) accumulator fit a block: blocks of
    K1_WARPS warps (fewer when their shared memory, k1_smem, does not fit
    smem_optin), as many a SM as smem_per_sm holds (at most 2); warp tiles
    of 32 rows go to blocks by the row index alone, tile t to block (t //
    nw) mod (blocks a SM x sm_count), so the grid is the blocks that rows
    reach, at most that, and rows after the live ones move no live tile.
    Otherwise the split form, whose groups, warps and second kernel follow
    K3's rule (k3_plan) in the packed rows' order, on its shared memory
    (k1_split_smem).  Raises ValueError when not even one row of the table
    fits a block.  Cached: each launch asks for it."""
    if prm.lmax in K1_ONE_LMAX:
        nw = next((w for w in range(K1_WARPS, 0, -1)
                   if k1_smem(prm, w) <= smem_optin), 0)
        finish = 4 * (prm.rows * (1 + prm.nmax) + K1_FINISH_THREADS
                      + 4 * prm.nmax)
        if nw and finish <= smem_optin:
            smem = k1_smem(prm, nw)
            # the card keeps 1 KB of an SM's shared memory for each block
            per_sm = max(1, min(2, smem_per_sm // (smem + 1024)))
            tiles = -(-n // 32)
            nblocks = max(1, min(-(-tiles // nw), per_sm * sm_count))
            return SphereCoefPlan(nw, nblocks, smem)
    qstart, nw, nblocks, smem, threads, staged = _split_plan(
        n, prm, sm_count, smem_optin, smem_per_sm, "sphere_coef",
        k1_split_smem)
    return SphereCoefPlan(nw, nblocks, smem, qstart, threads, staged)


def k1_row_bounds(Mh, lmax) -> np.ndarray:
    """(P,) f32 bounds of |Y_p| = |M[p] . mono(u)| on the unit sphere, which
    set K1's fixed-point scales.  A row that is the standard harmonic's
    times a factor (poly_matrix, any fac) is a real harmonic times that
    factor: |Y_lm| <= sqrt((2l + 1) / 4 pi), sqrt 2 more for m > 0 (the
    addition theorem), with 1% to spare for f32 rounding.  Any other row
    gets sum_k |M[p, k]|."""
    from exp_tpu_torch.ops.solidharm import harmonic_matrix

    prows = packed_rows(lmax)
    std = harmonic_matrix(lmax, tuple(prows))
    out = np.abs(Mh).sum(axis=1).astype(np.float64)
    for p, (cs, l, m) in enumerate(prows):
        k = int(np.argmax(np.abs(std[p])))
        ratio = Mh[p, k] / std[p, k]
        if np.allclose(Mh[p], ratio * std[p], rtol=1e-5, atol=1e-7 * out[p]):
            cap = abs(ratio) * math.sqrt((2 * l + 1) / (4 * math.pi)
                                         * (2.0 if m else 1.0))
            out[p] = min(out[p], 1.01 * cap + 1e-6 * out[p])
    return out.astype(np.float32)


def _on_host(cache, t, build):
    """build(t as a contiguous f32 host array), computed once per tensor and
    version: `cache` maps id(t) to (a weak reference to t, its version, the
    result), and drops the entries of tensors that are gone."""
    hit = cache.get(id(t))
    if hit is not None and hit[0]() is t and hit[1] == t._version:
        return hit[2]
    out = build(np.ascontiguousarray(t.detach().cpu().numpy(),
                                     dtype=np.float32))
    for k in [k for k, v in cache.items() if v[0]() is None]:
        del cache[k]
    cache[id(t)] = (weakref.ref(t), t._version, out)
    return out


#: host copies of the M given to sphere_coef and the fac given to
#: sphere_coef_rec (_on_host's caches)
_host_m: dict = {}
_host_fac: dict = {}


def _m_on_host(M, lmax):
    """(dense, packed): M's k1_row_bounds after M (P, n_mono), for K1's
    one-accumulator form, and after M's k1_support entries (row-major),
    for its split form; each a contiguous f32 host array for K1's launch
    parameters, read from the device once per tensor and version.  Raises
    ValueError when M has nonzero entries outside k1_support."""
    def build(Mh):
        sup = k1_support(lmax)
        outside = np.count_nonzero(Mh[~sup])
        if outside:
            raise ValueError(f"sphere_coef: M has {outside} nonzero entries "
                             "outside the support K1 multiplies")
        bound = k1_row_bounds(Mh, lmax)
        return (np.concatenate([Mh.ravel(), bound]),
                np.concatenate([Mh[sup], bound]))

    return _on_host(_host_m, M, build)


def sphere_coef(x, mass, tab, M, prm: SphereKernelParams):
    """K1: sphere coefficients (2, L+1, L+1, nmax) f32.

    x (N, 3), mass (N,), tab (rows, F) radial table (prm.rows: nc + 2
    'spline', nc 'hat'), M (P, n_mono); all f32.  CPU tensors take
    sphere_coef_plain; CUDA tensors launch csrc/sphere_coef.cu with the
    plan of k1_plan (M is read back to the host once, for the launch
    parameters)."""
    if x.device.type == "cpu":
        return sphere_coef_plain(x, mass, tab, M, prm)
    if x.device.type != "cuda":
        raise ValueError(f"sphere_coef: unsupported device {x.device}")
    n, dev = _coef_inputs(x, mass, tab, prm, "sphere_coef")
    lmax, nmax = prm.lmax, prm.nmax
    P = (lmax + 1) ** 2
    _build.check_tensor(M, "M",
                        (P, (lmax + 1) * (lmax + 2) * (lmax + 3) // 6), dev)
    props = torch.cuda.get_device_properties(dev)
    plan = k1_plan(n, prm, props.multi_processor_count,
                   props.shared_memory_per_block_optin,
                   props.shared_memory_per_multiprocessor)
    dense, packed = _m_on_host(M, lmax)
    ngroups = len(plan.qstart) - 1 if plan.qstart else 0
    qstart = np.asarray(plan.qstart, dtype=np.int32) if ngroups else None
    partial = None
    if plan.nblocks > 1 or ngroups > 1:
        partial = torch.empty((plan.nblocks, P, prm.rows),
                              dtype=torch.float32, device=dev)
    coef = torch.empty((2, lmax + 1, lmax + 1, nmax), dtype=torch.float32,
                       device=dev)
    _launch("sphere_coef",
            [_P, _P, _LL, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, *_GEOM, _I,
             _P],
            (x.data_ptr(), mass.data_ptr(), n,
             (packed if ngroups else dense).ctypes.data,
             None if qstart is None else qstart.ctypes.data, ngroups,
             tab.data_ptr(),
             None if partial is None else partial.data_ptr(),
             plan.nblocks, plan.nw, plan.finish_threads,
             int(plan.finish_staged), coef.data_ptr(),
             *_geometry_args(prm), int(prm.interp == "hat")), dev)
    return coef


#: K3's most warps a block (kMaxThreads of csrc/sphere_coef_rec.cu)
K3_WARPS = 16


def k3_smem(prm: SphereKernelParams, nw: int, R: int) -> int:
    """K3's shared memory a block of nw warps whose group has R rows, as
    csrc/sphere_coef_rec.cu (and K1's split form) lays it out: each warp's 32 weight records
    (float4) and its stage of 32 particles x (min(32, R) | 1) rows (a
    chunk of up to 32 rows, odd stride), the group's (R, rows | 1) i32
    sums, and a packed row and scale exponent a group row."""
    return 4 * (nw * 32 * 4 + nw * 32 * (min(32, R) | 1)
                + R * (prm.rows | 1) + R)


def k3_groups(prm: SphereKernelParams, smem_optin,
              name="sphere_coef_rec", smem=None) -> tuple:
    """K3's groups of rows, as their boundaries (0, ..., P) in the order
    the rows are made (m outer, l inner, cos then sin; K1's split form:
    the packed order): one group wherever the (P, rows) accumulator and
    one warp's stage fit a block, else the fewest groups that fit, of
    balanced sizes; `smem` (prm, warps, rows) is the kernel's shared
    memory, k3_smem by default.  Raises ValueError, naming kernel `name`,
    when not even one row fits."""
    smem = smem or k3_smem
    P = (prm.lmax + 1) ** 2
    if smem(prm, 1, P) <= smem_optin:
        return (0, P)
    rmax = max((R for R in range(1, P)
                if smem(prm, 1, R) <= smem_optin), default=0)
    if not rmax:
        raise ValueError(f"{name}: one row of a {prm.rows}-row table and a "
                         f"warp's stage take {smem(prm, 1, 1)} bytes of "
                         f"shared memory, more than a block's {smem_optin}")
    ng = -(-P // rmax)
    return tuple(g * P // ng for g in range(ng + 1))


@dataclass(frozen=True)
class SphereCoefRecPlan:
    """K3's launch: a grid of `nblocks` x len(qstart) - 1 blocks of `nw`
    warps and `smem` bytes of shared memory, group g of blocks owning the
    rows [qstart[g], qstart[g + 1]); one block writes the coefficients
    itself, several write partials that a second kernel of
    `finish_threads` threads sums, its table slice staged in shared memory
    when `finish_staged`."""

    qstart: tuple
    nw: int
    nblocks: int
    smem: int
    finish_threads: int
    finish_staged: bool


def k3_finish(prm: SphereKernelParams, smem_optin, name="sphere_coef_rec"):
    """(threads, staged) of K3's second kernel (coef_reduce_slots,
    csrc/sphere_coef_sums.cuh, which K1's split form shares):
    K1_FINISH_THREADS threads with the table's (rows, nmax) slice staged in
    shared memory where that fits, else the slice read from device memory,
    with the most threads (1024, 512, 256, 128) whose sums fit.  Raises
    ValueError, naming kernel `name`, when none fits."""
    for staged in (True, False):
        for t in (K1_FINISH_THREADS, 512, 256, 128):
            if 4 * (prm.rows * (1 + (prm.nmax if staged else 0)) + t
                    + 4 * prm.nmax) <= smem_optin:
                return t, staged
    raise ValueError(f"{name}: the second kernel's {prm.rows} "
                     "table rows exceed a block's shared memory")


def _split_plan(n, prm, sm_count, smem_optin, smem_per_sm, name,
                smem=k3_smem):
    """(qstart, nw, nblocks, smem, finish_threads, finish_staged) of a
    coefficient pass whose rows split into groups (K3, K1's split form):
    the groups of k3_groups; blocks of nw <= K3_WARPS warps whose shared
    memory fits smem_optin, as many a SM as smem_per_sm holds (at most 2),
    nw the most warps an SM (the larger nw of a tie); warp tiles of 32
    rows go to blocks by the row index alone, tile t to block (t // nw)
    mod (blocks a SM x sm_count), so the grid is the blocks that rows
    reach, at most that, and rows after the live ones move no live tile
    (k1_plan's rule); the second kernel of k3_finish.  `smem` (prm, warps,
    rows) is the kernel's shared memory."""
    qstart = k3_groups(prm, smem_optin, name, smem)
    R = max(b - a for a, b in zip(qstart, qstart[1:]))

    best = (0, 0, 0)                 # (warps an SM, warps, blocks an SM)
    for w in range(1, K3_WARPS + 1):
        b = smem(prm, w, R)
        if b <= smem_optin:
            per_sm = max(1, min(2, smem_per_sm // (b + 1024)))
            best = max(best, (per_sm * w, w, per_sm))
    _, nw, per_sm = best
    tiles = -(-n // 32)
    nblocks = max(1, min(-(-tiles // nw), per_sm * sm_count))
    return (qstart, nw, nblocks, smem(prm, nw, R),
            *k3_finish(prm, smem_optin, name))


@functools.lru_cache(maxsize=1024)
def k3_plan(n, prm: SphereKernelParams, sm_count, smem_optin,
            smem_per_sm) -> SphereCoefRecPlan:
    """K3's launch plan for n rows (_split_plan).  Cached: each launch
    asks for it."""
    return SphereCoefRecPlan(*_split_plan(n, prm, sm_count, smem_optin,
                                          smem_per_sm, "sphere_coef_rec"))


def k3_row_bounds(fac, lmax) -> np.ndarray:
    """(P,) f32 bounds of |Y_p| / w = |fac[l,m] P_lm(cos th) {cos, sin}(m
    phi)| on the sphere, packed rows, which set K3's fixed-point scales:
    |P_lm| <= sqrt((l+m)!/(l-m)!), over sqrt 2 for m > 0 (the addition
    theorem: sum_m |Y_l^m|^2 = (2l+1)/4 pi), times |fac[l,m]|, with 1% to
    spare for the f32 recurrences."""
    fac = np.asarray(fac, dtype=np.float64)
    out = []
    for cs, l, m in packed_rows(lmax):
        pb = math.sqrt(math.factorial(l + m) / math.factorial(l - m)
                       / (2.0 if m else 1.0))
        out.append(1.01 * abs(fac[l, m]) * pb)
    return np.asarray(out, dtype=np.float32)


def _fac_on_host(fac, lmax):
    """fac ((lmax+1)^2) and its k3_row_bounds (P) as one contiguous f32
    host array for K3's launch parameters, read from the device once per
    tensor and version."""
    return _on_host(_host_fac, fac, lambda fh: np.concatenate(
        [fh.ravel(), k3_row_bounds(fh, lmax)]))


def sphere_coef_rec(x, mass, tab, fac, prm: SphereKernelParams):
    """K3: sphere coefficients (2, L+1, L+1, nmax) f32 from the recurrences.

    x (N, 3), mass (N,), tab (rows, F) as for sphere_coef, fac (L+1, L+1);
    all f32.  CPU tensors take sphere_coef_rec_plain; CUDA tensors launch
    csrc/sphere_coef_rec.cu with the plan of k3_plan (fac is read back to
    the host once, for the launch parameters)."""
    if x.device.type == "cpu":
        return sphere_coef_rec_plain(x, mass, tab, fac, prm)
    if x.device.type != "cuda":
        raise ValueError(f"sphere_coef_rec: unsupported device {x.device}")
    n, dev = _coef_inputs(x, mass, tab, prm, "sphere_coef_rec")
    lmax, nmax = prm.lmax, prm.nmax
    _build.check_tensor(fac, "fac", (lmax + 1, lmax + 1), dev)
    props = torch.cuda.get_device_properties(dev)
    plan = k3_plan(n, prm, props.multi_processor_count,
                   props.shared_memory_per_block_optin,
                   props.shared_memory_per_multiprocessor)
    consts = _fac_on_host(fac, lmax)
    qstart = np.asarray(plan.qstart, dtype=np.int32)
    ngroups = len(plan.qstart) - 1
    partial = None
    if plan.nblocks > 1 or ngroups > 1:
        partial = torch.empty((plan.nblocks, (lmax + 1) ** 2, prm.rows),
                              dtype=torch.float32, device=dev)
    coef = torch.empty((2, lmax + 1, lmax + 1, nmax), dtype=torch.float32,
                       device=dev)
    _launch("sphere_coef_rec",
            [_P, _P, _LL, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, *_GEOM, _I,
             _P],
            (x.data_ptr(), mass.data_ptr(), n, consts.ctypes.data,
             qstart.ctypes.data, ngroups, tab.data_ptr(),
             None if partial is None else partial.data_ptr(),
             plan.nblocks, plan.nw, plan.finish_threads,
             int(plan.finish_staged), coef.data_ptr(),
             *_geometry_args(prm), int(prm.interp == "hat")), dev)
    return coef


#: K2's threads a block, and the threads a SM up to which a bucket runs a
#: particle on a group of lanes (csrc/sphere_accel.cu); past it, a thread
#: a particle
K2_THREADS = 256
K2_THREADS_PER_SM = 768


def k2_lanes(lmax):
    """K2's lanes a particle: the power of 2 >= 1 + ceil(lmax / 2), lane 0
    holding column m = 0 of the (l, m) triangle and lane k >= 1 the
    columns k and lmax + 1 - k (lmax + 1 entries each)."""
    lanes = 1
    while lanes < 1 + (lmax + 1) // 2:
        lanes *= 2
    return lanes


def k2_columns(lmax):
    """The columns m of each of K2's lanes (k2_lanes), in the order the
    lane sums them: [[0], [1, lmax], [2, lmax - 1], ..., [], ...]."""
    h = (lmax + 1) // 2
    out = [[0]] + [sorted({k, lmax + 1 - k}) for k in range(1, h + 1)]
    return out + [[] for _ in range(k2_lanes(lmax) - len(out))]


@dataclass(frozen=True)
class SphereAccelPlan:
    """K2's launch: `threads` threads a particle (1, or its k2_lanes lanes
    each on a thread), `blocks` blocks of K2_THREADS threads and `smem`
    bytes of shared memory a block (fac and the reciprocals 1/d; the table
    is read through L1)."""

    threads: int
    blocks: int
    smem: int


def k2_plan(n, prm: SphereKernelParams, sm_count, smem_optin,
            threads=None) -> SphereAccelPlan:
    """K2's launch plan for n rows on a device of `sm_count` SMs and
    `smem_optin` bytes of shared memory a block: a particle on its
    k2_lanes lanes while the n particles' lanes fit K2_THREADS_PER_SM
    threads a SM, else a thread a particle (`threads` sets it instead: 1
    or the lanes).  Both give the same bits.  The blocks cover the rows."""
    lanes = k2_lanes(prm.lmax)
    if threads is None:
        threads = lanes if n * lanes <= K2_THREADS_PER_SM * sm_count else 1
    if threads not in (1, lanes):
        raise ValueError(f"sphere_accel: 1 or {lanes} threads a particle at "
                         f"lmax {prm.lmax}, not {threads}")
    L1 = prm.lmax + 1
    smem = 4 * (L1 * L1 + L1)
    if smem > smem_optin:
        raise ValueError(f"sphere_accel: {smem} bytes of shared memory "
                         f"exceed a block's {smem_optin}")
    return SphereAccelPlan(threads, -(-n * threads // K2_THREADS), smem)


def _accel_inputs(x, twT, prm, name):
    check_params(prm, name)
    n, dev = x.shape[0], x.device
    _build.check_tensor(x, "x", (n, 3), dev)
    _build.check_tensor(twT, "twT", (_twt_rows(prm), prm.rows), dev)
    return dev


def sphere_accel(x, twT, fac, prm: SphereKernelParams, plan=None):
    """K2: sphere force (acc (N, 3), pot (N,)) f32 from the recurrences.

    x (N, 3), twT ((2P, nc + 2) from contract_coef_table2 for 'spline',
    (P, nc) from contract_coef_table for 'hat'), fac (L+1, L+1); all f32.
    CPU tensors take sphere_accel_plain; CUDA tensors launch
    csrc/sphere_accel.cu with `plan`, by default k2_plan's."""
    if x.device.type == "cpu":
        return sphere_accel_plain(x, twT, fac, prm)
    if x.device.type != "cuda":
        raise ValueError(f"sphere_accel: unsupported device {x.device}")
    dev = _accel_inputs(x, twT, prm, "sphere_accel")
    _build.check_tensor(fac, "fac", (prm.lmax + 1, prm.lmax + 1), dev)
    n = x.shape[0]
    if plan is None:
        props = torch.cuda.get_device_properties(dev)
        plan = k2_plan(n, prm, props.multi_processor_count,
                       props.shared_memory_per_block_optin)
    acc = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pot = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch("sphere_accel",
            [_P, _LL, _P, _P, _P, _P, _I, _I, _I, *_GEOM, _F, _I, _P],
            (x.data_ptr(), n, twT.data_ptr(), fac.data_ptr(), acc.data_ptr(),
             pot.data_ptr(), plan.threads, plan.blocks, plan.smem,
             *_geometry_args(prm), prm.rmax * prm.scale,
             int(prm.interp == "hat")), dev)
    return acc, pot


#: K6's threads a block (at most; csrc/sphere_accel_poly.cu)
K6_THREADS = 256


@dataclass(frozen=True)
class SphereAccelPolyPlan:
    """K6's launch: `blocks` blocks of `threads` threads, a thread a row."""

    threads: int
    blocks: int


def k6_plan(n, prm: SphereKernelParams, sm_count) -> SphereAccelPolyPlan:
    """K6's launch plan for n rows on a device of `sm_count` SMs: blocks
    of K6_THREADS threads, or, when those would leave SMs without a block,
    of the fewest threads (a multiple of 32) that still give every SM one;
    the blocks cover the rows, a thread each."""
    check_params(prm, "sphere_accel_poly")
    threads = K6_THREADS
    while threads > 32 and -(-n // threads) < sm_count:
        threads //= 2
    return SphereAccelPolyPlan(threads, -(-n // threads))


#: host copies of the Ms given to sphere_accel_poly (_on_host's cache)
_host_ms: dict = {}


def _ms_on_host(Ms, lmax):
    """The nonzeros of Ms (k6_support, row-major) as one contiguous f32
    host array for K6's launch parameters, read from the device once per
    tensor and version; raises ValueError when Ms has nonzero entries
    outside k6_support."""
    def build(Mh):
        sup = k6_support(lmax)
        outside = np.count_nonzero(Mh[~sup])
        if outside:
            raise ValueError(f"sphere_accel_poly: Ms has {outside} nonzero "
                             "entries outside the support K6 multiplies")
        return np.ascontiguousarray(Mh[sup])

    return _on_host(_host_ms, Ms, build)


def sphere_accel_poly(x, twT, Ms, prm: SphereKernelParams):
    """K6: sphere force (acc (N, 3), pot (N,)) f32 from the polynomial
    harmonics.

    x (N, 3), twT as for sphere_accel, Ms (4P, n_mono) from
    poly_matrix_stack; all f32.  CPU tensors take sphere_accel_poly_plain;
    CUDA tensors launch csrc/sphere_accel_poly.cu with the plan of k6_plan
    (Ms is read back to the host once, for the launch parameters)."""
    if x.device.type == "cpu":
        return sphere_accel_poly_plain(x, twT, Ms, prm)
    if x.device.type != "cuda":
        raise ValueError(f"sphere_accel_poly: unsupported device {x.device}")
    dev = _accel_inputs(x, twT, prm, "sphere_accel_poly")
    L = prm.lmax
    _build.check_tensor(Ms, "Ms", (4 * (L + 1) ** 2,
                                   (L + 1) * (L + 2) * (L + 3) // 6), dev)
    n = x.shape[0]
    plan = k6_plan(n, prm, torch.cuda.get_device_properties(dev)
                   .multi_processor_count)
    Mnz = _ms_on_host(Ms, L)
    acc = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pot = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch("sphere_accel_poly",
            [_P, _LL, _P, _P, _P, _P, _I, _I, *_GEOM, _F, _I, _P],
            (x.data_ptr(), n, twT.data_ptr(), Mnz.ctypes.data, acc.data_ptr(),
             pot.data_ptr(), plan.threads, plan.blocks, *_geometry_args(prm),
             prm.rmax * prm.scale, int(prm.interp == "hat")), dev)
    return acc, pot
