"""Empirical re-orthogonalization of a disk basis from snapshots (port of
exp_tpu/analysis/diskeof.py).

The reference's diskeof tool (utils/Analysis/diskeof.cc): over a PSP
sequence, accumulate per-snapshot EOF coefficients AND the mass-weighted
modulus covariance D[m](n1,n2) = sum_i m_i |U_i(n1)| |U_i(n2)| of the
per-particle potential-basis rows; the SVD of D defines a rotated
("new EOF") order hierarchy adapted to the actual particle distribution,
and the coefficient series is re-expressed in it.

The per-particle basis rows come from the CylinderForce's full-resolution
bilinear table lookup (`CylinderForce._bilinear`, read-only: the force's
own path is untouched) on the force's device, and D is a single
(w|U|)^T |U| matmul per harmonic instead of the reference's per-particle
quad loop (diskeof.cc:363-380).  `accumulate` keeps the rows on the device
and sums in f64 there, as exp_tpu sums them in f64 on the host: one upload
a snapshot, one download of its coefficients and one of D at the end.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from exp_tpu_torch.analysis.basis import download, force_device, upload


def _rows(cyl, x):
    """basis_rows on the device: U (N, mmax+1, nmax), cos/sin (N, mmax+1)
    and the inside mask (N,), tensors."""
    R, z, phi = cyl._geometry(x)
    U = cyl._bilinear(cyl.pot_t, R, z)
    cosm, sinm = cyl._trig(phi, x.dtype)
    r = torch.sqrt(R * R + z * z)
    return U, cosm, sinm, r <= cyl.rmax_grid


def basis_rows(cyl, x):
    """Per-particle potential-basis rows U (N, mmax+1, nmax) and the
    azimuthal factors (cos m phi, sin m phi) for a CylinderForce."""
    x, = upload(force_device(cyl), x)
    return download(_rows(cyl, x))


def accumulate(cyl, snaps, nmin=0, nmax=None):
    """Coefficient series + modulus covariance over a snapshot sequence.

    snaps yields (time, mass, x).  Returns (times, coefC, coefS, D):
    coefC/coefS (T, mmax+1, Nord), D (mmax+1, Nord, Nord); the -4 pi
    projection factor matches CylinderForce.coefficients_local."""
    M1 = cyl.mmax + 1
    n1 = 0 if nmin is None else max(int(nmin), 0)
    n2 = cyl.nmax if nmax is None else min(int(nmax), cyl.nmax)
    nord = n2 - n1
    dev = force_device(cyl)
    D = torch.zeros((M1, nord, nord), dtype=torch.float64, device=dev)
    times, cc, ss = [], [], []
    for time, mass, x in snaps:
        x, mass = upload(dev, x, mass)
        U, cosm, sinm, inside = _rows(cyl, x)
        U = U[:, :, n1:n2].to(torch.float64)
        w = torch.where(inside, mass.to(torch.float64),
                        torch.zeros((), dtype=torch.float64, device=dev))
        wc = w[:, None] * cosm.to(torch.float64)      # (N, M+1)
        ws = w[:, None] * sinm.to(torch.float64)
        # coefficients: one einsum over particles
        csnap = -4.0 * math.pi * torch.einsum("nm,nmk->mk", wc, U)
        ssnap = -4.0 * math.pi * torch.einsum("nm,nmk->mk", ws, U)
        ssnap[0] = 0.0
        c_h, s_h = download((csnap, ssnap))
        cc.append(c_h)
        ss.append(s_h)
        # D[m] += (w |U_m|)^T |U_m| — diskeof.cc:369-379 with the
        # identity mod(n) = retC^2 + retS^2 = U(n)^2 (phi cancels)
        A = torch.abs(U)
        D += torch.einsum("nmk,nml->mkl", A * w[:, None, None], A)
        times.append(float(time))
    return (np.asarray(times), np.stack(cc) if cc else np.zeros((0, M1,
            nord)), np.stack(ss) if ss else np.zeros((0, M1, nord)),
            download(D))


def rotate(coefC, coefS, D):
    """SVD of D per harmonic; rotated coefficient series.

    Returns (svals (M+1, Nord), Urot (M+1, Nord, Nord), rotC, rotS with
    rot = U^T coef as in diskeof.cc:472-492)."""
    M1, nord = D.shape[0], D.shape[1]
    svals = np.zeros((M1, nord))
    Urot = np.zeros((M1, nord, nord))
    for m in range(M1):
        u, s, _vt = np.linalg.svd(D[m])
        svals[m], Urot[m] = s, u
    rotC = np.einsum("mkn,tmk->tmn", Urot, coefC)
    rotS = np.einsum("mkn,tmk->tmn", Urot, coefS)
    return svals, Urot, rotC, rotS


def write_coef_tables(path_rot, path_orig, times, coefC, coefS, rotC,
                      rotS):
    """The readcoefs-style ascii rows (diskeof.cc:495-515): per time and
    harmonic, the amplitude sqrt(C^2+S^2) of each (rotated) order."""
    ampR = np.sqrt(rotC ** 2 + rotS ** 2)
    ampO = np.sqrt(coefC ** 2 + coefS ** 2)
    with open(path_rot, "w") as fr, open(path_orig, "w") as fo:
        for t, time in enumerate(times):
            for m in range(coefC.shape[1]):
                head = f"{time:18.10g}{m:5d}"
                fr.write(head + "".join(f"{v:18.10g}"
                                        for v in ampR[t, m]) + "\n")
                fo.write(head + "".join(f"{v:18.10g}"
                                        for v in ampO[t, m]) + "\n")


def rotated_grids(cyl, Urot, rotC, rotS, m, rmax, outr, nmin=0):
    """In-plane (z=0) potential and density maps of each rotated order
    (diskeof.cc write_output redesign: the rotated basis function
    Vtilde_n = sum_k Urot(k,n) V_k carries the rotation; the reference's
    inner k-loop is vestigial).  Returns (dens, pot) of shape
    (T, Nord, outr, outr)."""
    nord = Urot.shape[1]
    g = np.linspace(-rmax, rmax, outr)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), np.zeros(outr * outr)], 1)
    xd, = upload(force_device(cyl), pts)
    R, z, phi = cyl._geometry(xd)
    P, Dn, phi = download((
        cyl._bilinear(cyl.pot_t, R, z)[:, m, nmin:nmin + nord],
        cyl._bilinear(cyl.dens_t, R, z)[:, m, nmin:nmin + nord], phi))
    cosp = np.cos(m * phi)
    sinp = np.sin(m * phi)
    Pt = P @ Urot[m]                                   # (G, Nord) rotated
    Dt = Dn @ Urot[m]
    T = rotC.shape[0]
    dens = np.zeros((T, nord, outr, outr))
    pot = np.zeros((T, nord, outr, outr))
    for t in range(T):
        ang_c = rotC[t, m][None, :] * cosp[:, None]
        ang_s = rotS[t, m][None, :] * sinp[:, None]
        pot[t] = (Pt * (ang_c + ang_s)).T.reshape(nord, outr, outr)
        dens[t] = (Dt * (ang_c + ang_s)).T.reshape(nord, outr, outr)
    return dens, pot
