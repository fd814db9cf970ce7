"""No-op force (port of exp_tpu/forces/noforce.py; the reference's NoForce,
src/NoForce.cc): a component whose particles generate no field — they move
only in other components' fields."""

from __future__ import annotations

import torch
from torch import nn


class NoForce(nn.Module):
    """Zero coefficients (2, 1, 1, 1) and zero acceleration and potential,
    on the device of the positions given."""

    def __init__(self, lmax: int = 0, nmax: int = 1, scale: float = 1.0):
        super().__init__()
        self.lmax, self.nmax, self.scale = int(lmax), int(nmax), float(scale)

    @property
    def coef_shape(self):
        return (2, 1, 1, 1)

    def coefficients_local(self, x, mass, accum_dtype=torch.float32):
        return torch.zeros(self.coef_shape, dtype=accum_dtype, device=x.device)

    def coefficients(self, x, mass, accum_dtype=torch.float32):
        return self.coefficients_local(x, mass, accum_dtype)

    def acceleration(self, coef, x):
        return torch.zeros_like(x), torch.zeros(x.shape[:-1], dtype=x.dtype,
                                                device=x.device)

    def density(self, coef, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
