"""Periodic-cube initial conditions (port of exp_tpu/ic/cubeics.py, the
reference's utils/ICs/cubeics).  Host NumPy: the same seed gives the same
arrays as the JAX package's sampler, bit for bit."""

from __future__ import annotations

import numpy as np


def sample_cube(n: int, mass: float = 1.0, sigma: float = 1.0,
                pert_k=None, pert_amp: float = 0.0, seed: int = 0):
    """Uniform unit-box realization with isotropic Maxwellian velocities.

    Optional single-mode density perturbation 1 + amp cos(2 pi k.x) via
    rejection (for cube regression tests).
    Returns (x, v, m) numpy arrays.
    """
    rng = np.random.default_rng(seed)
    if pert_k is None or pert_amp == 0.0:
        x = rng.uniform(0.0, 1.0, (n, 3))
    else:
        k = np.asarray(pert_k, dtype=np.float64)
        xs = rng.uniform(0.0, 1.0, (4 * n, 3))
        w = 1.0 + pert_amp * np.cos(2.0 * np.pi * xs @ k)
        keep = rng.uniform(0.0, 1.0 + abs(pert_amp), 4 * n) <= w
        x = xs[keep][:n]
        if len(x) < n:
            x = np.concatenate([x, rng.uniform(0, 1, (n - len(x), 3))])
    v = rng.normal(0.0, sigma, (n, 3))
    v -= v.mean(axis=0)
    m = np.full(n, mass / n)
    return x, v, m
