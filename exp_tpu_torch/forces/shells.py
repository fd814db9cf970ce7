"""Spherical-shell monopole force and the fixed halo+bulge profile force
(port of exp_tpu/forces/shells.py; the reference's Shells,
src/Shells.H:11-19, and HaloBulge, src/HaloBulge.cc).

Shells: the monopole field of the component's own mass distribution,
M(<r) r^-2.  The mass is binned onto a static log-spaced radial grid by
`index_add_` (exp_tpu's one-hot matmul, the same floor(tb) bin rule),
prefix-summed, and M(<r) interpolated back; the resolution is set by
nbins instead of exact ranks.  The bin sums agree with exp_tpu's to
rounding, not bit for bit: the adds run in another order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from exp_tpu_torch.ops.interp import interp


class ShellsForce(nn.Module):
    """Coefficients: the cumulative mass M(<edge_b) at the nbins bin edges,
    in the accumulation dtype."""

    def __init__(self, rmax: float = 10.0, nbins: int = 256, lmax: int = 0,
                 nmax: int = 1, scale: float = 1.0):
        super().__init__()
        self.rmax, self.nbins = float(rmax), int(nbins)
        self.lmax, self.nmax, self.scale = int(lmax), int(nmax), float(scale)

    @property
    def coef_shape(self):
        return (self.nbins,)

    def _radial_bin(self, r):
        # log-spaced bins from rmax*1e-4 to rmax
        lo = np.log(self.rmax * 1e-4)
        hi = np.log(self.rmax)
        t = (torch.log(torch.clamp(r, min=self.rmax * 1e-4)) - lo) / (hi - lo)
        return torch.clamp(t * self.nbins, 0.0, self.nbins - 1.0)

    def _bin_edges_r(self, dtype, device):
        lo = np.log(self.rmax * 1e-4)
        hi = np.log(self.rmax)
        # in f64, then the positions' dtype, as exp_tpu computes them
        j = torch.arange(self.nbins, dtype=torch.float64, device=device)
        return torch.exp(lo + (hi - lo) * (j + 1.0) / self.nbins).to(dtype)

    def coefficients(self, x, mass, accum_dtype=torch.float32):
        r = torch.sqrt(torch.sum(x * x, dim=-1)) + 1e-12
        b = torch.floor(self._radial_bin(r)).to(torch.int64)
        bins = torch.zeros(self.nbins, dtype=accum_dtype, device=x.device)
        bins.index_add_(0, b, mass.to(accum_dtype))
        return torch.cumsum(bins, dim=0)

    def acceleration(self, coef, x):
        """M(<r)/r^2 inward; potential by outside-in integration."""
        r = torch.sqrt(torch.sum(x * x, dim=-1)) + 1e-12
        edges = self._bin_edges_r(x.dtype, x.device)
        cum = coef.to(x.dtype)
        Mr = interp(r, edges, cum, left=0.0, right=cum[-1])
        g = -Mr / (r * r)
        acc = (g / r)[:, None] * x
        # potential: Phi(r) = Phi(rmax) - int_r^rmax M(<s)/s^2 ds,
        # Phi(rmax) = -M_tot/rmax (dPhi/dr = M/r^2 integrated inward)
        invs = cum / (edges * edges)
        dr = torch.diff(torch.cat([edges[:1] * 0.0, edges]))
        tail_full = torch.flip(torch.cumsum(torch.flip(invs * dr, (0,)),
                                            dim=0), (0,))
        tail = interp(r, edges, tail_full, left=tail_full[0], right=0.0)
        pot = -cum[-1] / edges[-1] - tail
        # outside the bin range: Keplerian
        pot = torch.where(r > edges[-1], -cum[-1] / r, pot)
        return acc, pot

    def density(self, coef, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


class HaloBulgeForce(nn.Module):
    """Fixed spherical profile force from a model file (HaloBulge.cc):
    particles move in the static field; no self-gravity.  The tables
    (log r, Phi, M) are registered buffers in the force's dtype."""

    def __init__(self, logr_t, pot_tab, mass_tab, lmax: int = 0,
                 nmax: int = 1, scale: float = 1.0):
        super().__init__()
        self.register_buffer("logr_t", logr_t)
        self.register_buffer("pot_tab", pot_tab)
        self.register_buffer("mass_tab", mass_tab)
        self.lmax, self.nmax, self.scale = int(lmax), int(nmax), float(scale)

    @classmethod
    def from_model(cls, model, dtype=torch.float32, device="cpu"):
        def tens(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(tens(np.log(model.r)), tens(model.pot), tens(model.mass))

    @property
    def coef_shape(self):
        return (1,)

    def coefficients(self, x, mass, accum_dtype=torch.float32):
        return torch.zeros((1,), dtype=accum_dtype, device=x.device)

    def acceleration(self, coef, x):
        r = torch.sqrt(torch.sum(x * x, dim=-1)) + 1e-12
        lr = torch.clamp(torch.log(r), self.logr_t[0], self.logr_t[-1])
        M = interp(lr, self.logr_t, self.mass_tab)
        pot = interp(lr, self.logr_t, self.pot_tab)
        pot = torch.where(torch.log(r) > self.logr_t[-1],
                          -self.mass_tab[-1] / r, pot)
        acc = -(M / r ** 3)[:, None] * x
        return acc, pot

    def density(self, coef, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
