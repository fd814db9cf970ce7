"""Basis cross-validation (port of exp_tpu/analysis/crossval.py;
utils/Analysis/cross_validation_{sph,cyl}*): quantify BFE truncation error
by comparing the expansion field against the direct softened N-body sum on
a particle subsample, binned in radius.

The projection and the field run on the force's device (under `backend:
pallas` one launch each of the coefficient and the force kernel); the
direct sum is exp_tpu's host NumPy.
"""

from __future__ import annotations

import numpy as np
import torch

from exp_tpu_torch.analysis.basis import download, force_device, upload


def cross_validate(force, x, mass, ntest: int = 512, eps: float = 1e-3,
                   nbins: int = 12, seed: int = 0,
                   accum_dtype=torch.float64):
    """Returns dict with per-bin radii and relative force/potential errors.

    The direct sum is the ground truth (same particles, Plummer softening
    eps); the BFE error combines basis truncation and discreteness of the
    coefficient estimate.
    """
    x = np.asarray(x)
    mass = np.asarray(mass)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(x), size=min(ntest, len(x)), replace=False)
    pts = x[idx]

    xd, md = upload(force_device(force), x, mass)
    coef = force.coefficients(xd, md, accum_dtype=accum_dtype)
    acc_b, pot_b = download(force.acceleration(
        coef, xd[torch.as_tensor(idx, device=xd.device)]))

    # direct sum excluding self-interaction, chunked over sources so the
    # (ntest, chunk, 3) displacement tensor stays ~MBs at any N
    pot_d = np.zeros(len(pts))
    acc_d = np.zeros((len(pts), 3))
    chunk = max(1, 32_000_000 // max(len(pts), 1))
    for s0 in range(0, len(x), chunk):
        xs = x[s0:s0 + chunk]
        ms = mass[s0:s0 + chunk]
        d = pts[:, None, :] - xs[None, :, :]
        r2 = (d ** 2).sum(-1) + eps * eps
        self_mask = r2 < (0.5 * eps) ** 2 + eps * eps * 1.0000001
        rinv = 1.0 / np.sqrt(r2)
        w = np.where(self_mask, 0.0, ms[None, :])
        pot_d -= (w * rinv).sum(1)
        acc_d -= (w[:, :, None] * d * (rinv ** 3)[:, :, None]).sum(1)

    r = np.linalg.norm(pts, axis=1)
    scale = np.linalg.norm(acc_d, axis=1) + 1e-30
    ferr = np.linalg.norm(acc_b - acc_d, axis=1) / scale
    perr = np.abs(pot_b - pot_d) / (np.abs(pot_d) + 1e-30)

    edges = np.geomspace(max(r.min(), 1e-6), r.max() * 1.0001, nbins + 1)
    bid = np.clip(np.digitize(r, edges) - 1, 0, nbins - 1)
    rows = []
    for b in range(nbins):
        sel = bid == b
        if not sel.any():
            continue
        rows.append((np.sqrt(edges[b] * edges[b + 1]),
                     np.median(ferr[sel]), np.quantile(ferr[sel], 0.9),
                     np.median(perr[sel]), int(sel.sum())))
    rows = np.array(rows)
    return {
        "r": rows[:, 0], "ferr_med": rows[:, 1], "ferr_p90": rows[:, 2],
        "perr_med": rows[:, 3], "counts": rows[:, 4],
        "ferr_all_med": float(np.median(ferr)),
        "perr_all_med": float(np.median(perr)),
    }


def kl_divergence_radial(x1, m1, x2, m2, nbins: int = 32):
    """KL divergence between the radial mass profiles of two snapshots
    (utils/Analysis KL tools)."""
    r1 = np.linalg.norm(np.asarray(x1), axis=1)
    r2 = np.linalg.norm(np.asarray(x2), axis=1)
    lo = max(min(r1.min(), r2.min()), 1e-8)
    hi = max(r1.max(), r2.max())
    edges = np.geomspace(lo, hi, nbins + 1)
    p, _ = np.histogram(r1, bins=edges, weights=np.asarray(m1))
    q, _ = np.histogram(r2, bins=edges, weights=np.asarray(m2))
    p = p / p.sum() + 1e-12
    q = q / q.sum() + 1e-12
    return float(np.sum(p * np.log(p / q)))
