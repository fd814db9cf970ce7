"""Analysis utilities (pyEXP `util` submodule).

A host-side NumPy copy of exp_tpu/analysis/util.py (the port imports
nothing of exp_tpu).

centerOfMass / getDensityCenter (expui/Centering.cc, KDdensity.H: KD-tree
kNN density-weighted center) and a small k-means (expui/KMeans.cc).
"""

from __future__ import annotations

import numpy as np


def centerOfMass(x, mass=None):
    x = np.asarray(x)
    if mass is None:
        return x.mean(axis=0)
    m = np.asarray(mass)
    return np.average(x, axis=0, weights=m)


def getDensityCenter(x, mass=None, k: int = 32, Nsort: int = 0,
                     subsample: int = 0):
    """Density-weighted center: kNN density estimate per particle, center =
    sum(rho_i x_i)/sum(rho_i) (the reference's getDensityCenter,
    expui/Centering.cc with KDdensity).

    Nsort > 0 restricts the average to the Nsort DENSEST particles (the
    reference's Nsort cusp-tracking selection); subsample > 0 randomly
    thins the input first (a speed knob, not in the reference)."""
    from scipy.spatial import cKDTree

    x = np.asarray(x, dtype=np.float64)
    m = np.ones(len(x)) if mass is None else np.asarray(mass, dtype=np.float64)
    n = len(x)
    if subsample and n > subsample:
        idx = np.random.default_rng(0).choice(n, subsample, replace=False)
        x, m = x[idx], m[idx]
        n = subsample
    k = min(k, n - 1)
    tree = cKDTree(x)
    d, _ = tree.query(x, k=k + 1)
    rk = d[:, -1]
    vol = 4.0 / 3.0 * np.pi * np.maximum(rk, 1e-30) ** 3
    rho = k * m / vol
    if Nsort and Nsort < n:
        keep = np.argpartition(rho, -Nsort)[-Nsort:]
        x, rho, m = x[keep], rho[keep], m[keep]
    w = rho * m
    return np.average(x, axis=0, weights=w)


def kmeans(x, k: int, iters: int = 50, seed: int = 0):
    """Plain k-means (expui/KMeans.cc): returns (centers, labels)."""
    x = np.asarray(x, dtype=np.float64)
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), k, replace=False)]
    labels = np.zeros(len(x), dtype=int)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new = d.argmin(axis=1)
        if np.array_equal(new, labels):
            break
        labels = new
        for j in range(k):
            sel = labels == j
            if sel.any():
                centers[j] = x[sel].mean(axis=0)
    return centers, labels


def getVersionInfo():
    from exp_tpu_torch import __version__

    return {"version": __version__, "framework": "exp_tpu_torch"}
