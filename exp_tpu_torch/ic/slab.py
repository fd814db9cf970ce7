"""Periodic-slab initial conditions (the sampler of exp_tpu/cli/genslab.py,
after the reference's utils/ICs/genslab.cc): uniform in (x, y) on
[0, L)^2, an isothermal Spitzer sheet in z (rho ~ sech^2(z/z0),
sigma_z^2 = pi G Sigma z0, G = 1)."""

from __future__ import annotations

import numpy as np


def sample_slab(n, L=1.0, z0=0.02, mass=1.0, sigmaxy=None, seed=11):
    """(x (n, 3), v (n, 3), m (n,)) f64 arrays, drawn in genslab's order
    from default_rng(seed), with genslab's defaults: the same seed gives
    the same arrays as the file genslab writes.  x, y in [0, L), z
    centred on 0; sigmaxy defaults to sigma_z."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, L, (n, 2))
    z = z0 * np.arctanh(rng.uniform(-1, 1, n) * 0.9999999)
    pos = np.concatenate([xy, z[:, None]], axis=1)
    sigma = mass / L ** 2                          # surface density
    sz = np.sqrt(np.pi * sigma * z0)               # Spitzer sheet, G = 1
    sxy = sigmaxy if sigmaxy is not None else sz
    v = np.stack([rng.normal(0, sxy, n), rng.normal(0, sxy, n),
                  rng.normal(0, sz, n)], axis=1)
    m = np.full(n, mass / n)
    return pos, v, m
