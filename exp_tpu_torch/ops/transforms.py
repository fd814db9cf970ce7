"""Integral-transform helpers (port of exp_tpu/ops/transforms.py, host
NumPy / SciPy): quasi-discrete Hankel transform and the real-series FFT
wrapper (the reference's exputil/QDHT.cc and
TransformFFT.cc — used by the 2D disk construction and analysis tools,
not by the force path).
"""

from __future__ import annotations

import numpy as np
from scipy.special import jv, jn_zeros


class QDHT:
    """Quasi-discrete Hankel transform of integer order nu on [0, R]
    (QDHT.cc:11-87): nodes at scaled Bessel zeros, transform matrix
    T_ij = (2/S) J_nu(z_i z_j / S) / (J_{nu+1}(z_i) J_{nu+1}(z_j)),
    which is orthogonal to discretization accuracy (QDHT::check)."""

    def __init__(self, nu: int, N: int, R: float):
        if nu < 0:
            raise ValueError(f"nu ({nu}) must be positive")
        if N < 1:
            raise ValueError(f"N ({N}) must be greater than zero")
        self.nu, self.N, self.R = nu, int(N), float(R)
        zeros = jn_zeros(nu, N + 1)
        self.zeros = zeros[:N]
        self.S = zeros[N]             # total bandwidth R*V
        self.V = self.S / R
        self.r = self.zeros / self.V
        self.k = self.zeros / self.R
        self.Jp = jv(nu + 1, self.zeros)
        zz = np.outer(self.zeros, self.zeros) / self.S
        self.T = 2.0 / self.S * jv(nu, zz) / np.outer(self.Jp, self.Jp)

    def __call__(self, v, forward: bool = True):
        """Transform samples at self.r -> spectrum at self.k (forward) or
        back (QDHT::operator(), QDHT.cc:75-87)."""
        v = np.asarray(v, float)
        if forward:
            return (self.T @ (v / self.Jp * self.R)) * self.Jp / self.V
        return (self.T @ (v / self.Jp * self.V)) * self.Jp / self.R

    def interp(self, r, v):
        """Evaluate the band-limited interpolant of spectrum samples `v`
        at radius r (the pointwise operator(), QDHT.cc:90-98)."""
        r = np.asarray(r, float)
        ker = jv(self.nu, r[..., None] * self.zeros / self.R)
        out = ker @ (2.0 / (self.R * self.R * self.Jp * self.Jp) * v)
        return out if out.ndim else float(out)

    def check(self) -> float:
        """Max |singular value - 1| of T (orthogonality quality)."""
        s = np.linalg.svd(self.T, compute_uv=False)
        return float(np.abs(s - 1.0).max())


class TransformFFT:
    """Real-series Fourier helper (TransformFFT.cc): frequencies, complex
    spectrum and one-sided power from samples with spacing dr."""

    def __init__(self, dr: float, y):
        self.dr = float(dr)
        self.y = np.asarray(y, float)
        self.n = self.y.size
        self.dk = 2.0 * np.pi / (self.dr * self.n)

    def freqs(self):
        return 2.0 * np.pi * np.fft.rfftfreq(self.n, d=self.dr)

    def inverse(self):
        """(freqs, complex spectrum) — TransformFFT::Inverse."""
        return self.freqs(), np.fft.rfft(self.y) * self.dr

    def power(self):
        """(freqs, one-sided power) — TransformFFT::Power."""
        f, w = self.inverse()
        return f, np.abs(w) ** 2 / (self.n * self.dr)
