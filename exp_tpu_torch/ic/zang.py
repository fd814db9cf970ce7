"""Zang disk: tapered-Mestel 2D equilibrium ICs (utils/ICs/ZangICs.cc,
exputil/mestel.cc, include/mestel.H; host, NumPy, a copy of
exp_tpu/ic/zang.py: the same seed gives the same sample bit for bit).

The Mestel disk (flat rotation curve v0, Phi = v0^2 ln r) has the exact
2D DF  f(E, L) = F L^q exp(-E/sigma^2),  q = v0^2/sigma^2 - 1
(mestel.cc:59-75).  The Zang/Toomre doubly-tapered variant multiplies
inner/outer angular-momentum tapers

    T_in(L)  = L^nu / ((Ri v0)^nu + L^nu)
    T_out(L) = 1 / (1 + (L / (Ro v0))^mu)

(mestel.cc:98-122) to cut the infinite disk off smoothly — the classic
stability-experiment IC family.  Sampling here: radius from the tapered
surface-density CDF (the taper evaluated at the circular angular
momentum L = r v0, matching TaperedMestelDisk::get_density), then
(vr, vt) by log-space rejection from f at fixed r with the energy
cutoff E < Phi(Rmax) (ZangICs.cc:144-150).
"""

from __future__ import annotations

import math

import numpy as np


class TaperedMestelDF:
    """f(E, L) with the Mestel power-exponential form and Zang tapers."""

    def __init__(self, nu=2.0, mu=2.0, Ri=1.0, Ro=20.0, vrot=1.0,
                 sigma=1.0, rmin=1e-3, rmax=50.0):
        self.nu, self.mu, self.Ri, self.Ro = nu, mu, Ri, Ro
        self.v0 = vrot
        self.rot = vrot * vrot
        self.sig2 = sigma * sigma
        self.q = self.rot / self.sig2 - 1.0
        self.rmin, self.rmax = rmin, rmax
        self.Tifac = (Ri * vrot) ** nu if nu > 0 else 1.0
        self.Tofac = Ro * vrot
        # normalization (mestel.cc:59-68)
        self.F = self.rot / (4.0 * np.pi) / (
            math.sqrt(math.pi)
            * math.exp(math.lgamma(0.5 * (self.q + 1.0))
                       + (2.0 + self.q) * math.log(sigma)
                       + 0.5 * self.q * math.log(2.0)))

    def pot(self, r):
        return self.rot * np.log(r)

    def t_inner(self, L):
        if self.nu <= 0:
            return np.ones_like(np.asarray(L, float))
        f = np.abs(L) ** self.nu
        return f / (self.Tifac + f)

    def t_outer(self, L):
        if self.mu <= 0:
            return np.ones_like(np.asarray(L, float))
        return 1.0 / (1.0 + (np.abs(L) / self.Tofac) ** self.mu)

    def log_f(self, E, L):
        """ln f(E, L) (log space: L^q overflows for cold disks)."""
        L = np.abs(np.asarray(L, float))
        # guard L = 0 before the log so q * log(L) never produces the
        # (masked-out anyway) 0 * -inf = nan warning
        Ls = np.where(L > 0, L, 1.0)
        with np.errstate(divide="ignore"):
            out = (np.log(self.F) + self.q * np.log(Ls) - E / self.sig2
                   + np.log(self.t_inner(Ls)) + np.log(self.t_outer(Ls)))
        return np.where(L > 0, out, -np.inf)

    def distf(self, E, L):
        return np.exp(self.log_f(E, L))

    def surface_density(self, r):
        """Tapered Sigma(r) = v0^2/(2 pi G r) T_in T_out at L = r v0
        (TaperedMestelDisk::get_density)."""
        r = np.asarray(r, float)
        L = r * self.v0
        return self.rot / (2.0 * np.pi * r) * self.t_inner(L) \
            * self.t_outer(L)

    def mass_table(self, n=4000):
        r = np.geomspace(self.rmin, self.rmax, n)
        integ = 2.0 * np.pi * r * self.surface_density(r)
        M = np.concatenate([[0.0],
                            np.cumsum(0.5 * (integ[1:] + integ[:-1])
                                      * np.diff(r))])
        return r, M


def sample_zang_disk(n, nu=2.0, mu=2.0, Ri=1.0, Ro=20.0, vrot=1.0,
                     sigma=1.0, rmin=1e-3, rmax=50.0, seed=0,
                     zero_com=True, zero_cov=True, nrepl=1):
    """Equilibrium tapered-Mestel realization: (x (n,3), v (n,3), mass).

    nrepl > 1 places `nrepl` phase-replicated copies of each sampled
    orbit point at equal azimuthal offsets (ZangICs.cc's Nrepl quiet
    start)."""
    rng = np.random.default_rng(seed)
    df = TaperedMestelDF(nu, mu, Ri, Ro, vrot, sigma, rmin, rmax)
    if nrepl < 1:
        nrepl = 1
    n = (n // nrepl) * nrepl
    nbase = n // nrepl

    rt, Mt = df.mass_table()
    mtot = Mt[-1]
    inv = lambda u: np.interp(u, Mt / mtot, rt)
    r = inv(rng.uniform(0.0, 1.0, nbase))

    # velocity rejection at fixed r: p(vr, vt) ~ f(E, L), E < Phi(rmax)
    Emax = df.pot(rmax)
    pot_r = df.pot(r)
    vcut = np.sqrt(np.maximum(2.0 * (Emax - pot_r), 0.0))
    # per-particle log-envelope over a coarse (vr >= 0, vt > 0) grid
    g = np.linspace(0.0, 1.0, 24)
    VR, VT = np.meshgrid(g, g, indexing="ij")
    E = pot_r[:, None, None] + 0.5 * (VR[None] ** 2 + VT[None] ** 2) \
        * vcut[:, None, None] ** 2
    L = r[:, None, None] * VT[None] * vcut[:, None, None]
    lenv = df.log_f(E, L).reshape(nbase, -1).max(axis=1) + 0.3

    vr = np.empty(nbase)
    vt = np.empty(nbase)
    todo = np.arange(nbase)
    while todo.size:
        rr, pr, vc = r[todo], pot_r[todo], vcut[todo]
        a1 = rng.uniform(-1.0, 1.0, todo.size) * vc
        a2 = rng.uniform(0.0, 1.0, todo.size) * vc
        E = pr + 0.5 * (a1 * a1 + a2 * a2)
        lf = df.log_f(E, rr * a2)
        ok = (E < Emax) & (np.log(rng.uniform(0, 1, todo.size))
                           <= lf - lenv[todo])
        vr[todo[ok]] = a1[ok]
        vt[todo[ok]] = a2[ok]
        todo = todo[~ok]

    phi0 = rng.uniform(0.0, 2.0 * np.pi, nbase)
    dphi = 2.0 * np.pi / nrepl
    phis = (phi0[:, None] + dphi * np.arange(nrepl)[None, :]).ravel()
    rr = np.repeat(r, nrepl)
    vrr = np.repeat(vr, nrepl)
    vtt = np.repeat(vt, nrepl)
    c, s = np.cos(phis), np.sin(phis)
    x = np.stack([rr * c, rr * s, np.zeros(n)], axis=-1)
    v = np.stack([vrr * c - vtt * s, vrr * s + vtt * c,
                  np.zeros(n)], axis=-1)
    mass = np.full(n, mtot / n)
    if zero_com:
        x -= x.mean(axis=0)
    if zero_cov:
        v -= v.mean(axis=0)
    return x, v, mass
