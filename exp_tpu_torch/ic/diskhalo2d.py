"""Self-consistent razor-thin disk + halo ICs, the Disk2dHalo path (port of
exp_tpu/ic/diskhalo2d.py; utils/ICs/Disk2dHalo.cc(:59-3006) driven by
initial2d.cc): the 2D counterpart of ic/diskhalo.py.  The halo DF is
computed in the COMBINED potential (the disk monopole folded into the
halo model), both populations are expanded with the framework's own
bases (SphereSL + the razor-thin flatdisk basis through the shared
cylinder evaluator), and the disk velocities come from in-plane Jeans
moments of the measured total field:

    kappa^2(R)  = (2 Omega / R) d(Omega R^2)/dR       (epitable)
    sigma_R^2   = Q > 0 ? (3.36 Sigma Q / kappa)^2
                        : (SIG0 v_c(a))^2 e^{-R/a}    (vr_disp2)
    sigma_p^2   = sigma_R^2 kappa^2/(4 Omega^2)
    vbar_phi^2  = v_c^2 + sigma_R^2 (1 - kappa^2/(4 Omega^2)
                                     + dln(Sigma sigma_R^2)/dlnR)

with z = vz = 0 identically (Disk2dHalo::set_vel_disk, :1680-1860).

The host parts are NumPy with exp_tpu's seeds; the two coefficient
projections and the Jeans grid's field evaluations run through the forces
it is given, on their device (with `backend: pallas` on the card: K1 and
K4 for the coefficients, K2 and K5 for the grid).
"""

from __future__ import annotations

import numpy as np

from exp_tpu_torch.basis.model import SphericalModelTable
from exp_tpu_torch.ic.diskhalo import (DiskHaloICs, DiskHaloTables,
                                       _device_of, _eval_fields, _f32,
                                       sample_multimass_halo, set_vel_disk)
from exp_tpu_torch.ic.eddington import sample_spherical_model


def add_disk2d_to_model(halo: SphericalModelTable, Sigma, rdmax,
                        ) -> SphericalModelTable:
    """Composite halo + razor-thin-disk model: fold the disk's monopole
    M_d(<r) = int_0^r Sigma(R) 2 pi R dR into the halo's mass and
    potential (AddDisk.cc for the 2D surface density; the enclosed mass
    of a razor-thin disk inside a sphere equals the cylinder mass)."""
    r = halo.r
    Rq = np.geomspace(max(r[0] * 1e-2, 1e-12), float(r[-1]), 4096)
    dM = np.asarray(Sigma(Rq)) * 2.0 * np.pi * Rq
    Mcum = np.concatenate([[0.0], np.cumsum(
        0.5 * (dM[1:] + dM[:-1]) * np.diff(Rq))])
    Md = np.interp(r, Rq, Mcum)
    dMd = np.gradient(Md, r)
    integ = dMd / np.maximum(r, 1e-30)
    tail = np.concatenate([
        np.cumsum((0.5 * (integ[1:] + integ[:-1]) * np.diff(r))[::-1]
                  )[::-1], [0.0]])
    pot_d = -Md / np.maximum(r, 1e-30) - tail
    return SphericalModelTable(r, halo.rho, halo.mass + Md,
                               halo.pot + pot_d,
                               comment=halo.comment + " + 2d disk")


def sample_surface_density(Sigma, n, rmax, seed=0):
    """Positions from a surface-density profile, z = 0 (initial2d.cc)."""
    rng = np.random.default_rng(seed)
    Rq = np.geomspace(1e-4 * rmax, rmax, 4000)
    dM = np.asarray(Sigma(Rq)) * 2.0 * np.pi * Rq
    cum = np.concatenate([[0.0], np.cumsum(
        0.5 * (dM[1:] + dM[:-1]) * np.diff(Rq))])
    Mtot = cum[-1]
    R = np.interp(rng.uniform(0.0, 1.0, n) * Mtot, cum, Rq)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    x = np.stack([R * np.cos(phi), R * np.sin(phi), np.zeros(n)], 1)
    return x, np.full(n, Mtot / n)


def build_disk_tables_2d(halo_force, coef_h, disk_force, coef_d, *,
                         Sigma, acyl, Q=0.0, sig0=0.1,
                         ndp=8, ndr=40, rdmin=None, rdmax=None,
                         dphidr_floor=None) -> DiskHaloTables:
    """Disk2dHalo::table_disk (:1109-1463): in-plane Jeans tables from
    the measured total field on a (phi, log R) grid.  The vertical
    branch is identically zero (razor-thin)."""
    rdmin = rdmin if rdmin is not None else 1e-4
    rdmax = rdmax if rdmax is not None else 10.0 * acyl
    lnR = np.linspace(np.log(rdmin), np.log(rdmax), ndr)
    R = np.exp(lnR)
    phis = np.arange(ndp) * (2.0 * np.pi / ndp)

    P, Rg = np.meshgrid(phis, R, indexing="ij")
    pts = np.stack([(Rg * np.cos(P)).ravel(), (Rg * np.sin(P)).ravel(),
                    np.zeros(ndp * ndr)], axis=-1)
    acc, _ = _eval_fields(halo_force, coef_h, disk_force, coef_d, pts)
    a0 = acc.reshape(ndp, ndr, 3)
    dPhidR = np.maximum(-(a0[..., 0] * np.cos(phis)[:, None]
                          + a0[..., 1] * np.sin(phis)[:, None]), 1e-20)
    if dphidr_floor is not None:
        dPhidR = np.maximum(dPhidR, np.asarray(dphidr_floor(R))[None, :])
    omega2 = dPhidR / R[None]
    omega = np.sqrt(omega2)
    q2 = omega * R[None] ** 2
    dq2 = np.gradient(q2, lnR, axis=1)
    kappa2 = 2.0 * omega / R[None] ** 2 * dq2
    kappa2 = np.clip(kappa2, omega2, 4.0 * omega2)
    vc = omega * R[None]

    tiny = np.finfo(np.float64).tiny
    SR = np.maximum(np.asarray(Sigma(R)), tiny)
    if Q > 0.0:
        sigR2 = (3.36 * SR[None] * Q / np.sqrt(kappa2)) ** 2
        sigma0 = 0.0
    else:
        ia = int(np.clip(np.searchsorted(R, acyl), 0, ndr - 1))
        sigma0 = float(sig0 * vc[:, ia].mean())
        sigR2 = sigma0 ** 2 * np.exp(-R / acyl)[None] * np.ones((ndp, 1))

    lnSsR2 = np.log(np.maximum(SR[None] * sigR2, tiny))
    dlnSsR2 = np.gradient(lnSsR2, lnR, axis=1)

    zs = np.array([0.0, acyl])                 # trivial vertical branch
    zero3 = np.zeros((ndp, ndr, 2))
    return DiskHaloTables(phis=phis, lnR=lnR, zs=zs, sigz2P=zero3,
                          sigz2N=zero3, kappa2=kappa2, omega2=omega2,
                          vc=vc, sigR2=sigR2, dlnSsR2=dlnSsR2,
                          sigma0=sigma0)


def diskhalo2d_ics(halo_model: SphericalModelTable, *, n_halo, n_disk,
                   Mdisk, acyl, halo_force, disk_force, model="expon",
                   Q=0.0, sig0=0.1, xi=1.0, gen_type="asymmetric",
                   ra=None, number_model=None, ndp=8, ndr=40,
                   rdmax=None, seed=0, zero_com=True, zero_cov=True,
                   **model_kw) -> DiskHaloICs:
    """The full initial2d pipeline (initial2d.cc over Disk2dHalo.cc).

    halo_force / disk_force: the port's SphereSL and (flatdisk)
    CylinderForce whose truncated fields the run will integrate."""
    from exp_tpu_torch.basis.flatdisk import surface_density_model

    Sigma = surface_density_model(model, a=acyl, M=Mdisk, **model_kw)
    rdmax = rdmax if rdmax is not None else 10.0 * acyl

    comp = add_disk2d_to_model(halo_model, Sigma, rdmax)
    if number_model is not None:
        xh, vh, mh = sample_multimass_halo(comp, number_model, n_halo,
                                           ra=ra, seed=seed)
    else:
        xh, vh, mh = sample_spherical_model(comp, n_halo, seed=seed,
                                            ra=ra, tracer_only=True,
                                            zero_com=False)

    xd, md = sample_surface_density(Sigma, n_disk, rdmax, seed=seed + 1)
    if zero_com:
        xh = xh - np.average(xh, axis=0, weights=np.maximum(mh, 0.0))
        # keep the disk exactly in the z=0 plane: remove only the
        # in-plane sampling-noise COM
        com_d = np.average(xd, axis=0, weights=md)
        xd = xd - np.array([com_d[0], com_d[1], 0.0])

    dh, dd = _device_of(halo_force), _device_of(disk_force)
    ch = halo_force.coefficients(_f32(xh, dh), _f32(mh, dh))
    cd = disk_force.coefficients(_f32(xd, dd), _f32(md, dd))

    tables = build_disk_tables_2d(
        halo_force, ch, disk_force, cd, Sigma=Sigma, acyl=acyl, Q=Q,
        sig0=sig0, ndp=ndp, ndr=ndr, rdmax=rdmax,
        dphidr_floor=lambda R: 0.5 * comp.get_dpot(R))
    vd, vdiag = set_vel_disk(xd, tables, acyl=acyl, gen_type=gen_type,
                             xi=xi, seed=seed, zero_cov=False)
    vd[:, 2] = 0.0                              # razor-thin kinematics
    if zero_cov:
        vd[:, :2] -= np.average(vd[:, :2], axis=0, weights=md)
        vh = vh - np.average(vh, axis=0, weights=np.maximum(mh, 0.0))

    diag = dict(vdiag)
    diag["sigma0"] = tables.sigma0
    return DiskHaloICs(x_halo=xh, v_halo=vh, m_halo=mh, x_disk=xd,
                       v_disk=vd, m_disk=md, tables=tables, diag=diag)
