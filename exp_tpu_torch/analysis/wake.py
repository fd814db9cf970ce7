"""Wake analysis over a spherical BFE (port of exp_tpu/analysis/wake.py;
the reference's BiorthWake,
exputil/biorth_wake.cc, biorth_wake_orientation.cc): band-limited
reconstruction of the density/potential response ("wake") excluding the
monopole, and the Euler-angle orientation of a chosen (L, M) multipole.

The reference couples this to an analytic AxiSymBiorth basis; here any
spherical force object (coefficient layout (2, lmax+1, lmax+1, nmax))
works — SphereSL, the analytic CB/Hernquist sets, Bessel — so the wake
evaluation rides the same kernels as the N-body force (K1 and K2 under
`backend: pallas`), on the force's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from exp_tpu_torch.analysis.basis import download, force_device, upload


def lband(coef, L1: int, L2: int):
    """Zero all harmonic orders outside [L1, L2] (the L1/L2 selection in
    BiorthWake::reconstruct, biorth_wake.cc:80-90): a copy of the same
    kind, a tensor on the same device or a NumPy array."""
    c = coef.clone() if isinstance(coef, torch.Tensor) else np.array(coef)
    lmax = c.shape[1] - 1
    for l in range(lmax + 1):
        if l < L1 or l > L2:
            c[:, l, :, :] = 0.0
    return c


def _host(coef):
    """Coefficients as a NumPy array (one download of a tensor)."""
    if isinstance(coef, torch.Tensor):
        return download(coef)
    return np.asarray(coef)


def wigner_d(l: int, beta: float) -> np.ndarray:
    """Wigner small-d matrix d^l_{m',m}(beta), shape (2l+1, 2l+1) indexed
    [l+m', l+m] (the rot_matrix used by the orientation solver,
    exputil/rotmatrix.cc)."""
    out = np.zeros((2 * l + 1, 2 * l + 1))
    cb = math.cos(0.5 * beta)
    sb = math.sin(0.5 * beta)
    lf = [math.lgamma(k + 1) for k in range(2 * l + 1)]

    def f(k):
        return lf[k]

    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = 0.5 * (f(l + m) + f(l - m) + f(l + mp) + f(l - mp))
            s = 0.0
            kmin = max(0, m - mp)
            kmax = min(l + m, l - mp)
            for k in range(kmin, kmax + 1):
                ln = pref - (f(l + m - k) + f(k) + f(l - mp - k)
                             + f(k - m + mp))
                a = 2 * l - 2 * k + m - mp
                b = 2 * k - m + mp
                term = math.exp(ln) * (cb ** a) * (sb ** b)
                s += term if (k - m + mp) % 2 == 0 else -term
            out[l + mp, l + m] = s
    return out


class BiorthWake:
    """Band-limited wake reconstruction + multipole orientation.

    Wraps a spherical force object; coefficients come from the force's own
    projection (BiorthWake::accumulate is force.coefficients here).
    """

    def __init__(self, force):
        self.force = force

    def accumulate(self, x, mass, accum_dtype=torch.float64):
        """Project particles -> coefficients (accumulate_3d analogue), a
        tensor on the force's device."""
        x, m = upload(force_device(self.force), x, mass)
        return self.force.coefficients(x, m, accum_dtype=accum_dtype)

    def reconstruct(self, coef, points, L1: int = 1, L2: int = 10000):
        """(dens0, dens_wake, pot0, pot_wake) at points: the monopole field
        and the band-limited residual wake (reconstruct_3d,
        biorth_wake.cc:245-295)."""
        pts, coef = upload(force_device(self.force), points, coef)
        c0 = lband(coef, 0, 0)
        cw = lband(coef, max(L1, 1), L2)
        dens0 = self.force.density(c0, pts)
        _, pot0 = self.force.acceleration(c0, pts)
        densw = self.force.density(cw, pts)
        _, potw = self.force.acceleration(cw, pts)
        return download((dens0, densw, pot0, potw))

    # -- orientation ------------------------------------------------------

    def _ylm_vector(self, coef, L: int, n: int) -> np.ndarray:
        """Complex Y_{L m} coefficient vector (2L+1,) for radial order n
        (orientation ylm pack, biorth_wake_orientation.cc:40-80;
        Condon-Shortley (-1)^m for the negative-m entries)."""
        c = _host(coef)
        ylm = np.zeros(2 * L + 1, complex)
        fac1 = math.sqrt((0.5 * L + 0.25) / math.pi)
        for m in range(L + 1):
            if m == 0:
                ylm[L] = fac1 * c[0, L, 0, n]
            else:
                fac2 = fac1 * math.sqrt(
                    math.exp(math.lgamma(L - m + 1) - math.lgamma(L + m + 1)))
                ylm[L + m] = fac2 * (c[0, L, m, n] + 1j * c[1, L, m, n])
                ylm[L - m] = fac2 * ((-1.0) ** m) * (c[0, L, m, n]
                                                     - 1j * c[1, L, m, n])
        nrm = math.sqrt(abs(np.vdot(ylm, ylm))) + 1e-10
        return ylm / nrm

    def orientation(self, coef, L: int, M: int):
        """Euler angles (phi, theta, psi) aligning the (L, M) multipole,
        per radial order n: minimize -(Re a'_{LM})^2 - (Re a'_{L,-M})^2
        over rotations (BiorthWake::orientation + energy,
        biorth_wake_orientation.cc:17-133; scipy simplex replaces amoeba).

        Returns dict with (nmax,) arrays phi/theta/psi/cost."""
        from scipy.optimize import minimize

        c = coef = _host(coef)
        lmax, nmax = c.shape[1] - 1, c.shape[3]
        if L > lmax or abs(M) > L:
            raise ValueError("orientation: (L, M) out of bounds")
        ms = np.arange(-L, L + 1)
        out = {k: np.zeros(nmax) for k in ("phi", "theta", "psi", "cost")}
        for n in range(nmax):
            ylm = self._ylm_vector(coef, L, n)

            def energy(p):
                d = wigner_d(L, p[1])
                rot = np.exp(-1j * p[2] * ms) * ylm
                ap = np.exp(-1j * p[0] * M) * np.sum(d[L + M] * rot)
                e = ap.real ** 2
                if M != 0:
                    am = np.exp(1j * p[0] * M) * np.sum(d[L - M] * rot)
                    e += am.real ** 2
                return -e

            best = None
            for x0 in ([0.3, 0.8, 0.3], [2.0, 2.0, 1.0], [1.0, 0.3, 2.5]):
                r = minimize(energy, x0, method="Nelder-Mead",
                             options={"xatol": 1e-10, "fatol": 1e-12,
                                      "maxiter": 2000})
                if best is None or r.fun < best.fun:
                    best = r
            p = np.mod(best.x, 2.0 * np.pi)
            out["phi"][n], out["theta"][n], out["psi"][n] = p
            out["cost"][n] = best.fun
        return out
