"""Disk initial conditions (a copy of exp_tpu/ic/disk.py, NumPy on the
host): an exponential/sech^2 disk sample and rotating velocities with
epicyclic dispersions.  The same seed gives the same samples as the JAX
package."""

from __future__ import annotations

import numpy as np


def sample_exponential_disk(n, acyl=0.01, hcyl=0.002, mass=1.0, seed=0):
    """Positions + masses for a radially-exponential, sech^2-vertical disk."""
    rng = np.random.default_rng(seed)
    R = -acyl * (np.log(rng.uniform(size=n)) + np.log(rng.uniform(size=n)))
    z = hcyl * np.arctanh(rng.uniform(-1, 1, n) * 0.9999999)
    phi = rng.uniform(0, 2 * np.pi, n)
    x = np.stack([R * np.cos(phi), R * np.sin(phi), z], axis=-1)
    m = np.full(n, mass / n)
    return x, m


def disk_velocities(x, vc_of_R, acyl=0.01, sigma0=None, Q: float = 1.2,
                    seed=0, Mdisk=None, hcyl=None):
    """Assign rotating velocities with epicyclic dispersions.

    Args:
      vc_of_R: callable R -> circular speed from the TOTAL potential.
      sigma0: central radial dispersion.  Default: when Mdisk is given,
        from Toomre Q at R = 2a (sigma_R = Q 3.36 G Sigma / kappa with
        the exponential Sigma(R) = Mdisk e^{-R/a} / 2 pi a^2 and kappa
        from the rotation curve); else the 0.3 max(vc) rule of thumb
        (Q then has no effect).
    """
    rng = np.random.default_rng(seed + 1)
    R = np.hypot(x[:, 0], x[:, 1]) + 1e-12
    phi = np.arctan2(x[:, 1], x[:, 0])
    vc = vc_of_R(R)

    # radial dispersion ~ exp(-R/2a) profile
    if sigma0 is None and Mdisk is not None:
        R0 = 2.0 * acyl

        def _vc(r):
            return float(np.ravel(vc_of_R(np.asarray([r])))[0])

        vc0 = _vc(R0)
        dv = (_vc(1.01 * R0) - _vc(0.99 * R0)) / (0.02 * R0)
        kappa = np.sqrt(max(2.0 * vc0 / R0 * (vc0 / R0 + dv), 1e-30))
        Sigma0 = Mdisk / (2.0 * np.pi * acyl ** 2) * np.exp(-R0 / acyl)
        # target sigma_R AT R0, lifted back to the central amplitude of
        # the exp(-R/2a) profile
        sigma0 = Q * 3.36 * Sigma0 / kappa * np.exp(R0 / (2.0 * acyl))
    elif sigma0 is None:
        sigma0 = 0.3 * np.max(vc)
    sigR = sigma0 * np.exp(-R / (2.0 * acyl))
    sigp = sigR / np.sqrt(2.0)            # epicyclic ratio (flat curve)
    if Mdisk is not None and hcyl is not None:
        # vertical equilibrium of the sech^2 slab (Spitzer):
        # sigz^2 = pi G Sigma(R) hcyl
        Sigma = Mdisk / (2.0 * np.pi * acyl ** 2) * np.exp(-R / acyl)
        sigz = np.sqrt(np.pi * Sigma * hcyl)
    else:
        sigz = sigR / np.sqrt(2.0)

    # asymmetric drift (Jeans): va^2 = vc^2 + sigR^2 [dln(Sigma sigR^2)/
    # dlnR + 1 - sigp^2/sigR^2] with Sigma, sigR^2 ~ e^{-R/a} and
    # sigp^2/sigR^2 = 1/2  ->  va^2 = vc^2 - sigR^2 (2R/a - 1/2)
    va2 = vc**2 - sigR**2 * (2.0 * R / acyl - 0.5)
    va = np.sqrt(np.maximum(va2, 0.0))

    vR = rng.normal(0, 1, len(R)) * sigR
    vP = va + rng.normal(0, 1, len(R)) * sigp
    vz = rng.normal(0, 1, len(R)) * sigz

    vx = vR * np.cos(phi) - vP * np.sin(phi)
    vy = vR * np.sin(phi) + vP * np.cos(phi)
    return np.stack([vx, vy, vz], axis=-1)
