"""Real spherical harmonics as polynomials in the unit vector (a jax-free
copy of exp_tpu/ops/solidharm.py; host-side NumPy).

r^l Y_lm(theta, phi) is a homogeneous degree-l polynomial in (x, y, z), so
on the unit sphere every packed harmonic row
    Y_row = fac[l, m] * P_lm(cos th) * {cos, sin}(m phi)
is an exact polynomial in u = (ux, uy, uz) of degree l.  Stacking the
polynomial coefficients into a static matrix M (rows, n_mono) turns the
angular build of the sphere coefficient kernel into M @ mono(u) (35
monomials at lmax=4).  Gradient matrices M @ D_j give the tangential
derivatives.  Everything here is computed once per lmax and cached.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def monomial_exponents(lmax: int):
    """All 3-var monomial exponent triples with degree <= lmax, ordered by
    degree then lexicographically: [(0,0,0), (1,0,0), (0,1,0), ...].
    Count = (lmax+1)(lmax+2)(lmax+3)/6 (35 at lmax=4)."""
    out = []
    for deg in range(lmax + 1):
        for i in range(deg, -1, -1):
            for j in range(deg - i, -1, -1):
                out.append((i, j, deg - i - j))
    return tuple(out)


def _eval_monomials(exps, u):
    """u (npts, 3) -> (npts, n_mono)."""
    out = np.empty((u.shape[0], len(exps)))
    for k, (i, j, kz) in enumerate(exps):
        out[:, k] = u[:, 0] ** i * u[:, 1] ** j * u[:, 2] ** kz
    return out


def _assoc_legendre(lmax, x):
    """P_lm(x) without Condon-Shortley handled the same way as the kernel
    recurrences (matches the sphere kernels' recurrences)."""
    n = x.shape[0]
    p = {(0, 0): np.ones(n)}
    if lmax > 0:
        somx2 = np.sqrt(np.maximum((1.0 - x) * (1.0 + x), 0.0))
        pll = p[(0, 0)]
        fact = 1.0
        for mm in range(1, lmax + 1):
            pll = pll * (-fact) * somx2
            p[(mm, mm)] = pll
            fact += 2.0
    for mm in range(lmax):
        pl2 = p[(mm, mm)]
        pl1 = x * (2 * mm + 1) * pl2
        p[(mm + 1, mm)] = pl1
        for ll in range(mm + 2, lmax + 1):
            pnew = (x * (2 * ll - 1) * pl1 - (ll + mm - 1) * pl2) / (ll - mm)
            p[(ll, mm)] = pnew
            pl2, pl1 = pl1, pnew
    return p


def standard_fac(l: int, m: int) -> float:
    """The real-Ylm normalization baked into harmonic_matrix (the scalar
    twin of ops/special.real_ylm_norm)."""
    v = math.sqrt((2 * l + 1) / (4 * math.pi)
                  * math.factorial(l - m) / math.factorial(l + m))
    return v * (math.sqrt(2) if m else 1.0)


@lru_cache(maxsize=None)
def harmonic_matrix(lmax: int, rows: tuple, with_fac: bool = True):
    """M (n_rows, n_mono) f64 with
        M[row] . mono(u) == fac[l, m] * P_lm(uz) * {cos, sin}(m phi)
    for rows (cs, l, m) (cs=0 cos, cs=1 sin), exactly on |u| = 1.

    Fit by least squares on an overdetermined random-point Vandermonde,
    restricted to the homogeneous degree-l (+ lower, same parity) block —
    exact for polynomials; the residual is checked to ~1e-10."""
    exps = monomial_exponents(lmax)
    rng = np.random.default_rng(12345)
    npts = 40 * len(exps)
    u = rng.normal(size=(npts, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    V = _eval_monomials(exps, u)

    costh = u[:, 2]
    phi = np.arctan2(u[:, 1], u[:, 0])
    P = _assoc_legendre(lmax, costh)

    def fac(l, m):
        if not with_fac:
            return 1.0
        return standard_fac(l, m)

    M = np.zeros((len(rows), len(exps)))
    for r, (cs, l, m) in enumerate(rows):
        target = fac(l, m) * P[(l, m)] * (
            np.cos(m * phi) if cs == 0 else np.sin(m * phi))
        # restrict to monomials of degree <= l with parity == l (adding
        # (|u|^2 - 1) multiples maps degree d -> d + 2, same parity)
        cols = [k for k, e in enumerate(exps)
                if sum(e) <= l and (sum(e) - l) % 2 == 0]
        sol, res, _, _ = np.linalg.lstsq(V[:, cols], target, rcond=None)
        err = np.abs(V[:, cols] @ sol - target).max()
        if err > 1e-8:
            raise RuntimeError(
                f"harmonic fit failed for row (cs={cs}, l={l}, m={m}): "
                f"residual {err:.2e}")
        M[r, cols] = sol
    M[np.abs(M) < 1e-12] = 0.0
    return M


@lru_cache(maxsize=None)
def derivative_matrices(lmax: int):
    """D_j (n_mono, n_mono), j = 0, 1, 2:  d(mono_a)/du_j = sum_b
    D_j[a, b] mono_b."""
    exps = monomial_exponents(lmax)
    index = {e: k for k, e in enumerate(exps)}
    D = np.zeros((3, len(exps), len(exps)))
    for a, e in enumerate(exps):
        for j in range(3):
            if e[j] == 0:
                continue
            de = list(e)
            de[j] -= 1
            D[j, a, index[tuple(de)]] = e[j]
    return D


def harmonic_and_gradient_matrices(lmax: int, rows: tuple):
    """(M, Mx, My, Mz) all (n_rows, n_mono) f64: value rows and the three
    d/du_j rows (polynomial-extension gradients; project tangentially
    after the matmul)."""
    M = harmonic_matrix(lmax, rows)
    D = derivative_matrices(lmax)
    return M, M @ D[0], M @ D[1], M @ D[2]


def monomial_build_plan(lmax: int):
    """Selection index pairs to build mono(u) (n_mono, B) from u rows with
    degree-at-a-time Hadamards:  deg-d block = mono[src1] * u[src2].
    Returns list over degrees d >= 2 of (dst_indices, src_mono_indices,
    src_u_indices); degree-1 block is u itself (indices 1, 2, 3)."""
    exps = monomial_exponents(lmax)
    index = {e: k for k, e in enumerate(exps)}
    plan = []
    for deg in range(2, lmax + 1):
        dst, s_mono, s_u = [], [], []
        for k, e in enumerate(exps):
            if sum(e) != deg:
                continue
            # split off one factor: the first axis with a nonzero exponent
            j = next(i for i in range(3) if e[i] > 0)
            le = list(e)
            le[j] -= 1
            dst.append(k)
            s_mono.append(index[tuple(le)])
            s_u.append(j)
        plan.append((np.array(dst), np.array(s_mono), np.array(s_u)))
    return plan
