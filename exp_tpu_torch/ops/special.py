"""Associated Legendre functions and azimuthal harmonics (port of
exp_tpu/ops/special.py).

Unnormalized P_lm(x) with the Condon-Shortley phase (the reference's
Basis::legendre_R / dlegendre_R, src/Basis.cc:14-115), written as
statically unrolled recurrences over particle tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _mineps(dtype):
    """|cos(theta)| clamp for the dP/dx recurrence: 1 - 1e-12 rounds back
    to 1.0 in float32, where 1/(x^2-1) would blow up at the pole."""
    return 1.0e-12 if dtype == torch.float64 else 1.0e-6


def _legendre_lists(lmax, x):
    zero = torch.zeros_like(x)
    p = [[zero for _ in range(lmax + 1)] for _ in range(lmax + 1)]
    p[0][0] = torch.ones_like(x)
    if lmax > 0:
        somx2 = torch.sqrt(torch.clamp((1.0 - x) * (1.0 + x), min=0.0))
        pll = p[0][0]
        fact = 1.0
        for m in range(1, lmax + 1):
            pll = pll * (-fact) * somx2
            p[m][m] = pll
            fact += 2.0
    for m in range(lmax):
        pl2 = p[m][m]
        pl1 = x * (2 * m + 1) * pl2
        p[m + 1][m] = pl1
        for l in range(m + 2, lmax + 1):
            pll = (x * (2 * l - 1) * pl1 - (l + m - 1) * pl2) / (l - m)
            p[l][m] = pll
            pl2, pl1 = pl1, pll
    return p


def _stack(p):
    return torch.stack([torch.stack(row, dim=-1) for row in p], dim=-2)


def legendre_lm(lmax: int, x):
    """P_lm(x): x (...,) -> (..., lmax+1, lmax+1), zero for m > l."""
    return _stack(_legendre_lists(lmax, x))


def dlegendre_lm(lmax: int, x):
    """(P, dP/dx), each (..., lmax+1, lmax+1), from
    (x^2 - 1) dP_lm/dx = l x P_lm - (l + m) P_{l-1,m} with |x| clamped
    away from 1."""
    eps = _mineps(x.dtype)
    xc = torch.clamp(x, -1.0 + eps, 1.0 - eps)
    p = _legendre_lists(lmax, xc)
    inv = 1.0 / (xc * xc - 1.0)
    zero = torch.zeros_like(xc)
    dp = [[zero for _ in range(lmax + 1)] for _ in range(lmax + 1)]
    for l in range(1, lmax + 1):
        for m in range(l + 1):
            if l == m:
                dp[l][m] = inv * (l * xc * p[l][m])
            else:
                dp[l][m] = inv * (l * xc * p[l][m] - (l + m) * p[l - 1][m])
    return _stack(p), _stack(dp)


def sincos_m(lmax: int, phi):
    """cos(m phi), sin(m phi) for m = 0..lmax, each (..., lmax+1)."""
    m = torch.arange(lmax + 1, dtype=phi.dtype, device=phi.device)
    arg = phi[..., None] * m
    return torch.cos(arg), torch.sin(arg)


def real_ylm_norm(lmax: int, dtype=torch.float64, device="cpu"):
    """fac[l, m] = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!) (* sqrt 2 for m > 0),
    zero for m > l (src/SphericalBasis.cc:328-335), as a (lmax+1, lmax+1)
    tensor of `dtype` on `device`."""
    fac = np.zeros((lmax + 1, lmax + 1))
    for l in range(lmax + 1):
        for m in range(l + 1):
            val = math.sqrt((2.0 * l + 1.0) / (4.0 * math.pi)
                            * math.factorial(l - m) / math.factorial(l + m))
            fac[l, m] = val * (math.sqrt(2.0) if m > 0 else 1.0)
    return torch.as_tensor(fac, dtype=dtype, device=device)
