"""Quadratic B-spline helpers for the 'spline' interpolation of the sphere's
radial tables and the cylinder's coarse x tables (copies of `_b2` :66-72
and `prefilter_x` :292-315 of exp_tpu/ops/pallas_cylinder.py).

A table tabulated on nc uniform nodes is prefiltered once on the host into
nc + 2 ghost-extended spline coefficients; a point at grid position t in
[0, nc-1] is then the sum of b2(j - 1 - t) * coef[j] over the three nodes
j with |j - 1 - t| < 1.5.
"""

from __future__ import annotations

import numpy as np
import torch


def b2(u):
    """Quadratic B-spline kernel (support |u| < 1.5), on tensors."""
    au = torch.abs(u)
    inner = 0.75 - au * au
    outer = 0.5 * (1.5 - au) * (1.5 - au)
    return torch.where(au <= 0.5, inner,
                       torch.where(au <= 1.5, outer, torch.zeros_like(au)))


def prefilter_x(table):
    """Quadratic-B-spline prefilter along axis 0 (host-side, once).

    Solves the tridiagonal interpolation system (1/8, 3/4, 1/8) so the
    spline passes through the table values, with ghost rows from linear
    extrapolation (which collapses the boundary conditions to
    s[0] = tab[0], s[-1] = tab[-1]).  Returns (nc + 2, ...) f32 spline
    coefficients."""
    from scipy.linalg import solve_banded

    a = np.asarray(table, np.float64)
    nc = a.shape[0]
    ab = np.zeros((3, nc))
    ab[0, 1:] = 0.125
    ab[1, :] = 0.75
    ab[2, :-1] = 0.125
    ab[1, 0] = 1.0
    ab[0, 1] = 0.0
    ab[1, -1] = 1.0
    ab[2, -2] = 0.0
    s = solve_banded((1, 1), ab, a.reshape(nc, -1)).reshape(a.shape)
    top = 2.0 * s[:1] - s[1:2]
    bot = 2.0 * s[-1:] - s[-2:-1]
    return np.concatenate([top, s, bot], axis=0).astype(np.float32)
