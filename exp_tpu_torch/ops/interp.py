"""Uniform-grid table interpolation (port of exp_tpu/ops/interp.py).

Linear interpolation for values and a three-point stencil for first
derivatives (SLGridMP2.cc:767-880 in the reference).  Tables keep the grid
index as the LEADING axis, so a per-particle lookup is a row gather.
"""

from __future__ import annotations

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
