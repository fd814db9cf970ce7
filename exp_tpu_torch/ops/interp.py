"""Uniform-grid table interpolation (port of exp_tpu/ops/interp.py).

Linear interpolation for values and a three-point stencil for first
derivatives (SLGridMP2.cc:767-880 in the reference).  Tables keep the grid
index as the LEADING axis, so a per-particle lookup is a row gather.
"""

from __future__ import annotations

import numpy as np
import torch


def uniform_index(x, xmin: float, dx: float, n: int, lo: int = 0):
    """Cell index + fractional offset for a uniform grid.

    Returns (idx, frac) with idx clipped to [lo, n-2]; frac = (x - x_idx)/dx
    (not clipped, so boundary extrapolation matches the reference)."""
    t = (x - xmin) / dx
    idx = torch.clamp(torch.floor(t).to(torch.int64), lo, n - 2)
    frac = t - idx.to(t.dtype)
    return idx, frac


def _bcast(frac, table):
    return frac.reshape(frac.shape + (1,) * (table.ndim - 1))


def lerp_uniform(table, x, xmin: float, dx: float):
    """Linear interpolation of `table` (numr, ...) at points x (N,) ->
    (N, ...)."""
    idx, frac = uniform_index(x, xmin, dx, table.shape[0])
    w = _bcast(frac, table)
    return table[idx] * (1.0 - w) + table[idx + 1] * w


def lerp_and_deriv3(table, x, xmin: float, dx: float):
    """Value (lerp) and three-point first derivative sharing one gather
    neighbourhood (exp_tpu.ops.interp.lerp_and_deriv3)."""
    idx, frac = uniform_index(x, xmin, dx, table.shape[0], lo=1)
    fm = table[idx - 1]
    f0 = table[idx]
    fp = table[idx + 1]
    w = _bcast(frac, table)
    # lo=1 clips the first cell's idx to 1, making w negative there:
    # interpolate between nodes idx-1, idx instead of extrapolating
    val = torch.where(w < 0, fm * (-w) + f0 * (1.0 + w),
                      f0 * (1.0 - w) + fp * w)
    der = ((w - 0.5) * fm - 2.0 * w * f0 + (w + 0.5) * fp) / dx
    return val, der


def interp(x, xp, fp, left=None, right=None):
    """Piecewise-linear interpolation of (xp, fp) at x on the device, as
    jnp.interp computes it: x and xp in their common dtype, the differences
    of fp in fp's own dtype; `left`/`right` (default fp[0]/fp[-1]) below
    xp[0] and above xp[-1]."""
    dt = torch.promote_types(x.dtype, xp.dtype)
    x, xp = x.to(dt), xp.to(dt)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(
        str(dt).replace("torch.", "")).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    lo = fp[0] if left is None else left
    hi = fp[-1] if right is None else right
    f = torch.where(x < xp[0], lo, f)
    return torch.where(x > xp[-1], hi, f)
