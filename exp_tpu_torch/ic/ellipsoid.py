"""Triaxial ellipsoid force: exact Chandrasekhar homoeoid potential (port of
exp_tpu/ic/ellipsoid.py's EllipsoidForce, with its mass_inertia and
monopole_quadrupole tables).

The reference's EllipsoidForce (utils/ICs/EllipsoidForce.cc, the engine
behind pst_model's bar): density stratified on similar ellipsoids
m^2 = sum x_k^2/a_k^2 with the powerlaw (rho0 m^{2p}), Ferrers
(rho0 (1-m^2)^p) and exponential (rho0 e^{-a0 m/param}/m) families, and
the potential from Chandrasekhar (1969, ch. 3 eq. 89/93):

    Phi(x) = -pi G a1 a2 a3 int_lambda^inf du/Delta(u)
                                   [psi(1) - psi(m^2(u))]
    psi(m^2) = int_1^{m^2} rho(s) ds,   Delta = sqrt(prod(a_k^2+u))

with lambda = 0 inside and the positive root of m^2(lambda) = 1
outside (exp_tpu's sign-consistent psi convention).

The u-integral is a fixed Gauss-Legendre rule under a rational-square
substitution smooth at both endpoints, the outside lambda comes from
bisection (no gradient) refined by three differentiable Newton steps, and
forces are torch.autograd gradients of the potential.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def _gl_nodes(n):
    u, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (u + 1.0), 0.5 * w


@dataclass(frozen=True)
class EllipsoidForce:
    """Exact potential/density of a triaxial ellipsoid.

    a: semi-axes (a0 >= a1 >= a2); bartype: 'powerlaw' | 'ferrers' |
    'expon'; param: the profile exponent/scale; num: quadrature order."""

    a: tuple = (1.0, 0.5, 0.25)
    mass: float = 1.0
    bartype: str = "ferrers"
    param: float = 1.0
    num: int = 64

    def __post_init__(self):
        a0, a1, a2 = self.a
        if not (a0 >= a1 >= a2 > 0):
            raise ValueError("semi-axes must satisfy a0 >= a1 >= a2 > 0")

    # density amplitude: getDens's rho0/(pi a0 a1 a2) combinations
    # (EllipsoidForce.cc:30-41) so that the volume integral is `mass`
    @property
    def rho0(self):
        p = self.param
        abc = float(np.prod(self.a))
        if self.bartype == "powerlaw":
            return (2.0 * p + 3.0) * self.mass / (4.0 * np.pi * abc)
        if self.bartype == "ferrers":
            return (2.0 * math.exp(math.lgamma(2.5 + p) - math.lgamma(1.5)
                                   - math.lgamma(1.0 + p))
                    * self.mass / (4.0 * np.pi * abc))
        if self.bartype == "expon":
            a0 = self.a[0]
            return (a0 * a0 * self.mass / (4.0 * p * p)
                    / (1.0 - (1.0 + a0 / p) * math.exp(-a0 / p))
                    / (np.pi * abc))
        raise ValueError(f"unknown bartype {self.bartype!r}")

    def _a2s(self, x):
        return torch.tensor([ak * ak for ak in self.a], dtype=x.dtype,
                            device=x.device)

    def density(self, x):
        """rho(x) on the ellipsoidal stratification (getDens)."""
        x = torch.atleast_2d(x)
        m2 = sum(x[:, k] ** 2 / self.a[k] ** 2 for k in range(3))
        p, r0 = self.param, self.rho0
        if self.bartype == "powerlaw":
            rho = r0 * torch.pow(torch.clamp(m2, min=1e-30), p)
        elif self.bartype == "ferrers":
            rho = r0 * torch.pow(torch.clamp(1.0 - m2, min=0.0), p)
        else:
            m = torch.sqrt(torch.clamp(m2, min=1e-30))
            rho = r0 * torch.exp(-self.a[0] * m / p) / m
        return torch.where(m2 > 1.0, torch.zeros_like(rho), rho)

    def _psi_diff(self, m2):
        """psi(1) - psi(m^2) (EllipsoidForce.cc:203-217, sign-consistent)."""
        p, r0 = self.param, self.rho0
        if self.bartype == "powerlaw":
            return r0 / (p + 1.0) * (1.0 - torch.pow(
                torch.clamp(m2, min=1e-30), p + 1.0))
        if self.bartype == "ferrers":
            return r0 / (p + 1.0) * torch.pow(
                torch.clamp(1.0 - m2, min=0.0), p + 1.0)
        k = self.a[0] / p
        m = torch.sqrt(torch.clamp(m2, min=1e-30))
        return 2.0 * r0 / k * (torch.exp(-k * m) - math.exp(-k))

    def _lambda(self, x):
        """Outside points: root of sum x_k^2/(a_k^2+lambda) = 1
        (EllipsoidForce::solve); 0 inside.  60 bisection steps without a
        gradient, then 3 differentiable Newton steps."""
        a2s = self._a2s(x)

        def m2_at(xx, lam):
            return torch.sum(xx * xx / (a2s[None, :] + lam[:, None]), dim=1)

        with torch.no_grad():
            xd = x.detach()
            r2 = torch.sum(xd * xd, dim=1)
            inside = m2_at(xd, torch.zeros_like(r2)) <= 1.0
            hi = torch.clamp(r2 - a2s[2], min=1e-30)
            lo = torch.zeros_like(hi)
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                up = m2_at(xd, mid) - 1.0 > 0
                lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
            lam = 0.5 * (lo + hi)
        for _ in range(3):                     # differentiable polish
            f = m2_at(x, lam) - 1.0
            df = -torch.sum(x * x / (a2s[None, :] + lam[:, None]) ** 2,
                            dim=1)
            lam = lam - f / torch.where(torch.abs(df) > 1e-300, df,
                                        torch.full_like(df, -1e-300))
        return torch.where(inside, torch.zeros_like(lam),
                           torch.clamp(lam, min=0.0))

    def potential(self, x):
        """Phi(x), exact interior+exterior homoeoid integral (getPotl)."""
        x = torch.atleast_2d(x)
        a2s = self._a2s(x)
        lam = self._lambda(x)
        # u = lambda + T (s/(1-s))^2 maps s in (0,1) onto (lambda, inf)
        # with a smooth integrand at BOTH ends, T ~ a0^2 the natural scale
        g, w = (torch.as_tensor(a, dtype=x.dtype, device=x.device)
                for a in _gl_nodes(self.num))
        T = float(self.a[0]) ** 2
        s = g[None, :]
        u = lam[:, None] + T * (s / (1.0 - s)) ** 2
        du = 2.0 * T * s / (1.0 - s) ** 3
        m2 = torch.sum(x[:, None, :] ** 2
                       / (a2s[None, None, :] + u[..., None]), dim=-1)
        delta = torch.sqrt(torch.prod(a2s[None, None, :] + u[..., None],
                                      dim=-1))
        integ = self._psi_diff(m2) * du / delta
        abc = float(np.prod(self.a))
        return -math.pi * abc * torch.sum(w[None, :] * integ, dim=1)

    def acceleration(self, x):
        """Exact force: -grad Phi by autograd (each row's potential depends
        on its own position only, so the gradient of the sum is the
        per-particle gradient)."""
        x = torch.atleast_2d(x)
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            phi = self.potential(xg)
            (g,) = torch.autograd.grad(phi.sum(), xg)
        return -g, phi.detach()

    def _np_eval(self, fn, pts, device):
        """fn (density or potential) at host points, as NumPy, evaluated
        in f64 on `device` (None: CUDA, raising when there is none)."""
        from exp_tpu_torch import resolve_device

        t = torch.as_tensor(np.asarray(pts, np.float64),
                            device=resolve_device(device))
        return fn(t).cpu().numpy()

    def mass_inertia(self, device=None):
        """Total mass and principal inertia by quadrature (MassInertia)."""
        g, w = _gl_nodes(self.num)
        z = [self.a[k] * g for k in range(3)]
        Z0, Z1, Z2 = np.meshgrid(z[0], z[1], z[2], indexing="ij")
        W = (w[:, None, None] * w[None, :, None] * w[None, None, :])
        pts = np.stack([Z0.ravel(), Z1.ravel(), Z2.ravel()], 1)
        dens = self._np_eval(self.density, pts, device).reshape(Z0.shape)
        abc8 = 8.0 * float(np.prod(self.a))
        M = abc8 * np.sum(W * dens)
        I = [abc8 * np.sum(W * dens * (B * B + C * C))
             for B, C in ((Z1, Z2), (Z0, Z2), (Z0, Z1))]
        return float(M), np.asarray(I)

    def monopole_quadrupole(self, numr=200, rmax=None, device=None):
        """Spherically-averaged rho-bar(r) and the U22(r) quadrupole
        amplitude tables (RhoBar/U22, EllipsoidForce.cc:239-280) used by
        bar-amplitude diagnostics."""
        rmax = rmax or 1.5 * self.a[0]
        r = np.linspace(1e-4 * self.a[0], rmax, numr)
        nphi, nth = 64, 32
        phi = np.linspace(0, np.pi, nphi, endpoint=False)
        gc, gw = _gl_nodes(nth)
        cosx = np.asarray(gc)
        sinx = np.sqrt(1 - cosx ** 2)
        P, C = np.meshgrid(phi, cosx, indexing="ij")
        S = np.sqrt(1 - C ** 2)
        dirs = np.stack([S * np.cos(P), S * np.sin(P), C], -1)  # (np,nt,3)
        pts = (r[:, None, None, None] * dirs[None]).reshape(-1, 3)
        pot = self._np_eval(self.potential, pts, device).reshape(
            numr, nphi, nth)
        dens = self._np_eval(self.density, pts, device).reshape(
            numr, nphi, nth)
        wphi = np.pi / nphi
        wth = np.asarray(gw)
        numfac = 0.25 * np.sqrt(15.0 / (2.0 * np.pi))
        u22 = numfac * 4.0 * np.sum(
            pot * (sinx ** 2)[None, None, :] * np.cos(2 * phi)[None, :,
                                                               None]
            * wth[None, None, :] * wphi, axis=(1, 2))
        # mean over the sphere: (1/4pi) * 4 * int_0^pi dphi int_0^1 dcos
        # (z-reflection and phi -> phi+pi symmetry of the stratification)
        rhobar = (1.0 / np.pi) * np.sum(
            dens * wth[None, None, :] * wphi, axis=(1, 2))
        return r, rhobar, u22
