"""Coefficient noise suppression: subsample variance + Hall smoothing (port
of exp_tpu/nbody/pca.py).

The analogue of the reference's AxisymmetricBasis PCA machinery
(AxisymmetricBasis.H:20-43: npca, pcavar, tk_type Hall/VarianceCut/
CumulativeCut; pca_hall in SphericalBasis.cc; OutSamp/expui Covariance):
estimate per-coefficient sampling noise by splitting particles into T
subsamples, and shrink each coefficient by its signal/(signal+noise) factor
(Hall 1981 smoothing) or cut low-S/N channels.

The subsamples are `nsamples` calls of the force's own `coefficients` on
round-robin masked masses, on the particles' device: on the 'pallas'
backend, `nsamples` launches of the coefficient kernel, whose zero-mass
gate makes every masked row add exactly 0.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def subsample_coefficients(force, x, mass, nsamples: int = 8,
                           accum_dtype=torch.float32, world=None):
    """Per-subsample coefficient estimates (nsamples, *coef_shape).

    Particles are assigned round-robin by row (the reference uses
    indx % sampT, SphericalBasis.cc:506).  Each subsample is scaled by
    nsamples so every estimate is an unbiased full-mass estimator.  On a
    World of several ranks the row is the global one (this rank's rows
    follow the lower ranks' rows) and each estimate is summed over the
    ranks.
    """
    from exp_tpu_torch.parallel.distributed import (sum_host,
                                                    world_coefficients)

    n = x.shape[0]
    first = 0
    if world is not None and world.size > 1:
        rows = np.zeros(world.size, np.int64)
        rows[world.rank] = n
        first = int(sum_host(rows, world)[:world.rank].sum())
    idx = (torch.arange(n, device=x.device) + first) % nsamples
    outs = []
    for t in range(nsamples):
        w = torch.where(idx == t, mass * nsamples, torch.zeros_like(mass))
        outs.append(world_coefficients(force, x, w, world,
                                       accum_dtype=accum_dtype))
    return torch.stack(outs)


def _mean_var(coef_sub):
    """Mean over the subsample axis and the sample variance (ddof 1) of
    the MEAN estimate (sample variance / T), as exp_tpu computes them."""
    T = coef_sub.shape[0]
    mean = torch.mean(coef_sub, dim=0)
    dev = coef_sub - mean
    var = torch.sum(dev * dev, dim=0) / (T - 1) / T
    return mean, var


def hall_factors(coef_sub, floor: float = 1e-30):
    """Hall smoothing factors b = s^2/(s^2 + var(mean)) per coefficient.

    coef_sub: (T, ...) subsample estimates.  Returns (factors, mean, var)
    with var = variance of the MEAN estimate (sample var / T).
    """
    mean, var = _mean_var(torch.as_tensor(coef_sub))
    s2 = mean * mean
    b = s2 / (s2 + var + floor)
    return b, mean, var


def smoothing_weights(mean, var, tk_type: str = "Hall",
                      tksmooth: float = 3.0, tkcum: float = 0.95):
    """Per-coefficient smoothing weights for the reference's tk_type
    policies (AxisymmetricBasis.cc:482-503; defaults tksmooth=3, tkcum=0.95
    from :58-59):

    Hall             — b = s^2/(s^2 + var) (signal fraction).
    VarianceCut      — zero channels with tksmooth*var > s^2.
    CumulativeCut    — keep leading radial channels until the cumulative
                       signal fraction exceeds tkcum (always keep n=0).
    VarianceWeighted — w = 1/(1 + var/s^2).
    None             — unity.
    """
    mean = torch.as_tensor(mean)
    var = torch.as_tensor(var)
    s2 = mean * mean
    if tk_type == "Hall":
        return s2 / (s2 + var + 1e-30)
    if tk_type == "VarianceCut":
        return (tksmooth * var <= s2).to(mean.dtype)
    if tk_type == "CumulativeCut":
        tot = torch.sum(s2, dim=-1, keepdim=True) + 1e-30
        cuml = torch.cumsum(s2, dim=-1) / tot
        first = torch.arange(s2.shape[-1], device=s2.device) == 0
        return ((cuml <= tkcum) | first).to(mean.dtype)
    if tk_type == "VarianceWeighted":
        return 1.0 / (1.0 + var / (s2 + 1e-14))
    return torch.ones_like(mean)


def eof_smoothing_matrix(coef_sub, tk_type: str = "Hall",
                         tksmooth: float = 3.0, tkcum: float = 0.95):
    """pcaeof smoothing (AxisymmetricBasis.H:27 `pcaeof`): rotate the
    radial (n) channels per harmonic into the subsample-covariance
    eigenbasis, apply the tk_type weights THERE, rotate back (NumPy f64 on
    the host).

    coef_sub: (T, ..., nmax) subsample estimates.
    Returns S (..., nmax, nmax) with smoothed = S @ coef; when the
    covariance is diagonal this reduces to the elementwise weights."""
    if isinstance(coef_sub, torch.Tensor):
        coef_sub = coef_sub.detach().cpu().numpy()
    cs = np.asarray(coef_sub, np.float64)
    T = cs.shape[0]
    mean = cs.mean(axis=0)
    dev = cs - mean
    # covariance of the MEAN estimator: sample covariance / T
    C = np.einsum("t...i,t...j->...ij", dev, dev) / max(T - 1, 1) / T
    lam, Q = np.linalg.eigh(C)                      # (..., n), (..., n, n)
    mproj = np.einsum("...ij,...i->...j", Q, mean)  # Q^T mean
    # order eigen-channels by DESCENDING signal power: eigh returns
    # ascending noise eigenvalues, but the order-dependent policies
    # (CumulativeCut's leading-channel cumsum, the always-kept channel 0)
    # expect dominant-first
    order = np.argsort(-(mproj ** 2), axis=-1)
    lam = np.take_along_axis(lam, order, axis=-1)
    mproj = np.take_along_axis(mproj, order, axis=-1)
    Q = np.take_along_axis(Q, order[..., None, :], axis=-1)
    w = smoothing_weights(torch.from_numpy(mproj),
                          torch.from_numpy(np.maximum(lam, 0.0)),
                          tk_type=tk_type, tksmooth=tksmooth,
                          tkcum=tkcum).numpy()
    return np.einsum("...ik,...k,...jk->...ij", Q, w, Q)


def apply_hall(coef, w):
    """Apply smoothing weights to one coefficient tensor: elementwise for
    diagonal (same-shape) weights, radial matrix contraction for pcaeof
    (trailing (n, n)) weights."""
    if w.ndim == coef.ndim + 1:
        return torch.einsum("...nm,...m->...n", w, coef)
    return coef * w


def smooth_coefficients(coef, factors, tk_type: str = "Hall",
                        tksmooth: float = 3.0):
    """Apply precomputed Hall factors with a policy (legacy helper; use
    smoothing_weights for the full reference tk_type set)."""
    if tk_type == "Hall":
        return coef * factors
    elif tk_type == "VarianceCut":
        keep = factors > 1.0 / (1.0 + tksmooth)
        return torch.where(keep, coef, torch.zeros_like(coef))
    return coef


def write_covariance_h5(path, time, coef_sub, name=""):
    """OutSamp analogue: dump subsample mean/variance to HDF5
    (PotAccel.H:116-137, expui/Covariance.cc)."""
    import h5py

    if isinstance(coef_sub, torch.Tensor):
        coef_sub = coef_sub.detach().cpu().numpy()
    cs = np.asarray(coef_sub)
    mean = cs.mean(axis=0)
    var = cs.var(axis=0, ddof=1)
    mode = "a" if os.path.exists(path) else "w"
    with h5py.File(path, mode) as f:
        if "name" not in f.attrs:
            f.attrs["name"] = name
            f.attrs["nsamples"] = cs.shape[0]
        g = f.create_group(f"snap{len(f.keys()):08d}")
        g.attrs["Time"] = float(time)
        g.create_dataset("mean", data=mean)
        g.create_dataset("variance", data=var)
