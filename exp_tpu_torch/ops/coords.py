"""Mapped radial coordinates for basis tables (port of exp_tpu/ops/coords.py).

  cmap = 0 :  xi = r
  cmap = 1 :  xi = (r/rmap - 1)/(r/rmap + 1)      (algebraic; xi in [-1, 1))
  cmap = 2 :  xi = log(r)

Each map works on torch tensors, NumPy arrays and Python floats: the
log/exp/ones_like calls dispatch on the argument's type.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_tensor(a):
    return isinstance(a, torch.Tensor)


def r_to_xi(r, cmap: int, rmap: float):
    if cmap == 1:
        return (r / rmap - 1.0) / (r / rmap + 1.0)
    elif cmap == 2:
        return torch.log(r) if _is_tensor(r) else np.log(r)
    return r


def xi_to_r(xi, cmap: int, rmap: float):
    if cmap == 1:
        return (1.0 + xi) / (1.0 - xi) * rmap
    elif cmap == 2:
        return torch.exp(xi) if _is_tensor(xi) else np.exp(xi)
    return xi


def dxi_dr(xi, cmap: int, rmap: float):
    """d(xi)/dr evaluated at xi."""
    if cmap == 1:
        return 0.5 * (1.0 - xi) * (1.0 - xi) / rmap
    elif cmap == 2:
        return torch.exp(-xi) if _is_tensor(xi) else np.exp(-xi)
    return torch.ones_like(xi) if _is_tensor(xi) else np.ones_like(xi)
