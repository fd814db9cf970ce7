"""Self-consistent disk+halo initial conditions, the DiskHalo path (port of
exp_tpu/ic/diskhalo.py; utils/ICs/DiskHalo.cc + AddDisk.cc driven by
utils/ICs/initial.cc, gendisk).

  1. Composite spherical model: the halo density as the tracer, the total
     (halo + sphericalized disk) mass and potential (`add_disk_to_model`);
     the Eddington inversion of that model gives the halo DF in the
     combined potential (DiskHalo.cc:131-146).
  2. Halo realization from the DF (optionally multimass, with importance
     weights against a number-density profile: DiskHalo.cc:225-287).
  3. Disk positions from Sigma(R) ~ R e^{-R/a}, sech^2(z/h) vertical.
  4. Both populations expanded with the port's own forces (SphereSL and
     CylinderForce, the truncated fields the run integrates), and the disk
     velocities drawn from Jeans moments of those measured fields
     (DiskHalo::table_disk, DiskHalo.cc:1118-1536; set_vel_disk
     :1879-2110): see exp_tpu/ic/diskhalo.py for the closures.

The host parts are NumPy, with the JAX package's `default_rng` seeds, so
given the same fields the port draws the same velocities.  The two
coefficient projections and the grid field evaluations run through the
forces on their device (the card by default), in batches.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from exp_tpu_torch.basis.model import SphericalModelTable, add_disk_to_model
from exp_tpu_torch.ic.disk import sample_exponential_disk
from exp_tpu_torch.ic.eddington import EddingtonDF, sample_spherical_model


def _sech2(u):
    c = np.cosh(np.clip(u, -40.0, 40.0))
    return 1.0 / (c * c)


def _device_of(force):
    """The device a force's tables live on."""
    return next(force.buffers()).device


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


@dataclass
class DiskHaloTables:
    """Jeans tables on the (phi, lnR, z) grid (DiskHalo::table_disk)."""

    phis: np.ndarray          # (NDP,)
    lnR: np.ndarray           # (NDR,)
    zs: np.ndarray            # (NDZ,) >= 0
    sigz2P: np.ndarray        # (NDP, NDR, NDZ) sigma_z^2, z > 0 branch
    sigz2N: np.ndarray        # (NDP, NDR, NDZ) sigma_z^2, z < 0 branch
    kappa2: np.ndarray        # (NDP, NDR) epicyclic frequency^2
    omega2: np.ndarray        # (NDP, NDR) (v_c/R)^2
    vc: np.ndarray            # (NDP, NDR) circular speed
    sigR2: np.ndarray         # (NDP, NDR) radial dispersion^2
    dlnSsR2: np.ndarray       # (NDP, NDR) dln(Sigma sigma_R^2)/dlnR
    sigma0: float = 0.0

    def interp2(self, table, phi, lnR):
        """Bilinear interp of an (NDP, NDR) table at particle (phi, lnR)."""
        ndp, ndr = table.shape
        dP = 2.0 * np.pi / ndp
        p = np.mod(phi, 2.0 * np.pi) / dP
        ip0 = np.floor(p).astype(int) % ndp
        ip1 = (ip0 + 1) % ndp
        cp = p - np.floor(p)
        x = np.clip((lnR - self.lnR[0]) / (self.lnR[1] - self.lnR[0]),
                    0.0, ndr - 1 - 1e-9)
        ir0 = np.floor(x).astype(int)
        cr = x - ir0
        return ((1 - cp) * ((1 - cr) * table[ip0, ir0]
                            + cr * table[ip0, ir0 + 1])
                + cp * ((1 - cr) * table[ip1, ir0]
                        + cr * table[ip1, ir0 + 1]))

    def interp3(self, phi, lnR, z):
        """Trilinear sigma_z^2 at (phi, lnR, z) using the +/- z branches."""
        ndp, ndr, ndz = self.sigz2P.shape
        dP = 2.0 * np.pi / ndp
        p = np.mod(phi, 2.0 * np.pi) / dP
        ip0 = np.floor(p).astype(int) % ndp
        ip1 = (ip0 + 1) % ndp
        cp = p - np.floor(p)
        x = np.clip((lnR - self.lnR[0]) / (self.lnR[1] - self.lnR[0]),
                    0.0, ndr - 1 - 1e-9)
        ir0 = np.floor(x).astype(int)
        cr = x - ir0
        dz = self.zs[1] - self.zs[0]
        zz = np.clip(np.abs(z) / dz, 0.0, ndz - 1 - 1e-9)
        iz0 = np.floor(zz).astype(int)
        cz = zz - iz0
        pos = z >= 0.0

        def tri(table):
            c00 = (1 - cz) * table[ip0, ir0, iz0] + cz * table[ip0, ir0,
                                                               iz0 + 1]
            c01 = (1 - cz) * table[ip0, ir0 + 1, iz0] + cz * table[
                ip0, ir0 + 1, iz0 + 1]
            c10 = (1 - cz) * table[ip1, ir0, iz0] + cz * table[ip1, ir0,
                                                               iz0 + 1]
            c11 = (1 - cz) * table[ip1, ir0 + 1, iz0] + cz * table[
                ip1, ir0 + 1, iz0 + 1]
            return ((1 - cp) * ((1 - cr) * c00 + cr * c01)
                    + cp * ((1 - cr) * c10 + cr * c11))

        return np.where(pos, tri(self.sigz2P), tri(self.sigz2N))


@dataclass
class DiskHaloICs:
    """Result bundle: the two populations plus build diagnostics."""

    x_halo: np.ndarray
    v_halo: np.ndarray
    m_halo: np.ndarray
    x_disk: np.ndarray
    v_disk: np.ndarray
    m_disk: np.ndarray
    tables: DiskHaloTables | None = None
    diag: dict = field(default_factory=dict)


def _eval_fields(halo_force, coef_h, disk_force, coef_d, pts,
                 batch: int = 262_144):
    """Total (acc, pot) of the two measured expansions at host points, f32,
    through the forces on the coefficients' device in batches."""
    pts = np.asarray(pts, np.float32)
    acc = np.zeros_like(pts)
    pot = np.zeros(len(pts), np.float32)
    dev = coef_h.device
    for i in range(0, len(pts), batch):
        p = _f32(pts[i:i + batch], dev)
        a1, p1 = halo_force.acceleration(coef_h, p)
        a2, p2 = disk_force.acceleration(coef_d, p)
        acc[i:i + batch] = (a1 + a2).cpu().numpy()
        pot[i:i + batch] = (p1 + p2).cpu().numpy()
    return acc, pot


def build_disk_tables(halo_force, coef_h, disk_force, coef_d, *,
                      Mdisk, acyl, hcyl, Q=0.0, sig0=0.1,
                      ndp=8, ndr=40, ndz=128, rdmin=None, rdmax=None,
                      zmax=None, shfactor=16.0,
                      dphidr_floor=None) -> DiskHaloTables:
    """DiskHalo::table_disk (DiskHalo.cc:1118-1536): Jeans tables from the
    measured total field on a (phi, log R, z) grid.

    dphidr_floor: optional smooth callable R -> dPhi/dR, a lower bound on
    the measured in-plane radial force (the reference's use_mono option,
    DiskHalo.cc:1298-1306), which keeps the Toomre-Q dispersion finite
    where the sampled expansions are noisy."""
    rdmin = rdmin if rdmin is not None else 1e-4
    rdmax = rdmax if rdmax is not None else 10.0 * acyl
    zmax = zmax if zmax is not None else shfactor * hcyl
    lnR = np.linspace(np.log(rdmin), np.log(rdmax), ndr)
    R = np.exp(lnR)
    zs = np.linspace(0.0, zmax, ndz)
    phis = np.arange(ndp) * (2.0 * np.pi / ndp)

    def sigma(Rv):
        return Mdisk / (2.0 * np.pi * acyl ** 2) * np.exp(-Rv / acyl)

    def rho_d(Rv, zv):
        return sigma(Rv) * _sech2(zv / hcyl) * 0.5 / hcyl

    # grid field evaluation: (ndp, ndr, ndz, +/-) vertical + in-plane
    P, Rg, Z = np.meshgrid(phis, R, zs, indexing="ij")
    base = np.stack([(Rg * np.cos(P)).ravel(), (Rg * np.sin(P)).ravel()],
                    axis=-1)
    pts = np.concatenate([
        np.concatenate([base, Z.reshape(-1, 1)], axis=-1),     # +z
        np.concatenate([base, -Z.reshape(-1, 1)], axis=-1),    # -z
    ])
    acc, _ = _eval_fields(halo_force, coef_h, disk_force, coef_d, pts)
    npts = ndp * ndr * ndz
    accP = acc[:npts].reshape(ndp, ndr, ndz, 3)
    accN = acc[npts:].reshape(ndp, ndr, ndz, 3)

    # vertical Jeans integral: sigma_z^2 rho = int_z^zmax rho dPhi/dz dz'
    # (B&T eq. 4-29c; disktableP/N, DiskHalo.cc:1327-1396).  dPhi/dz=-acc_z;
    # on the -z branch the sign flips so the integrand is positive both ways
    rho_g = rho_d(Rg, Z)
    dz = zs[1] - zs[0]
    tiny = np.finfo(np.float64).tiny

    def jeans_z(accb, sgn):
        integrand = rho_g * np.maximum(sgn * (-accb[..., 2]), 0.0)
        # cumulative from the top: A(z) = int_z^zmax
        cum = np.cumsum((0.5 * (integrand[..., 1:] + integrand[..., :-1])
                         * dz)[..., ::-1], axis=-1)[..., ::-1]
        cum = np.concatenate([cum, np.zeros_like(cum[..., :1])], axis=-1)
        return np.maximum(cum, tiny) / np.maximum(rho_g, tiny)

    sigz2P = jeans_z(accP, +1.0)
    sigz2N = jeans_z(accN, -1.0)

    # in-plane radial force -> Omega, kappa, v_c (epitable,
    # DiskHalo.cc:1289-1463).  dPhi/dR = -(a_x cos + a_y sin).
    a0 = accP[..., 0, :]                                   # z = 0 plane
    dPhidR = np.maximum(-(a0[..., 0] * np.cos(phis)[:, None]
                          + a0[..., 1] * np.sin(phis)[:, None]), 1e-20)
    if dphidr_floor is not None:
        dPhidR = np.maximum(dPhidR, np.asarray(dphidr_floor(R))[None, :])
    omega2 = dPhidR / R[None]
    omega = np.sqrt(omega2)
    q2 = omega * R[None] ** 2                              # R^2 Omega
    dq2 = np.gradient(q2, lnR, axis=1)                     # d/dlnR
    kappa2 = 2.0 * omega / R[None] ** 2 * dq2
    # physical bounds kappa in [Omega, 2 Omega] (ENFORCE_KAPPA,
    # DiskHalo.cc:1451-1457): guards table noise
    kappa2 = np.clip(kappa2, omega2, 4.0 * omega2)
    vc = np.sqrt(omega2) * R[None]

    # radial dispersion (vr_disp2, DiskHalo.cc:1790-1802)
    if Q > 0.0:
        sigR = 3.36 * sigma(R)[None] * Q / np.sqrt(kappa2)
        sigR2 = sigR ** 2
        sigma0 = 0.0
    else:
        ia = int(np.clip(np.searchsorted(R, acyl), 0, ndr - 1))
        sigma0 = float(sig0 * vc[:, ia].mean())
        smth = 0.25 * hcyl
        sigR2 = sigma0 ** 2 * np.exp(
            -np.sqrt(R ** 2 + smth ** 2) / acyl)[None] * np.ones((ndp, 1))

    # asymmetric-drift log-derivative (asytable, DiskHalo.cc:1466-1491)
    lnSsR2 = np.log(np.maximum(sigma(R)[None] * sigR2, tiny))
    dlnSsR2 = np.gradient(lnSsR2, lnR, axis=1)

    return DiskHaloTables(phis=phis, lnR=lnR, zs=zs, sigz2P=sigz2P,
                          sigz2N=sigz2N, kappa2=kappa2, omega2=omega2,
                          vc=vc, sigR2=sigR2, dlnSsR2=dlnSsR2,
                          sigma0=sigma0)


def set_vel_disk(x, tables: DiskHaloTables, *, acyl, gen_type="asymmetric",
                 xi=1.0, seed=0, zero_cov=True):
    """Draw disk velocities from the Jeans tables (set_vel_disk,
    DiskHalo.cc:1879-2110, Asymmetric/Jeans branches)."""
    rng = np.random.default_rng(seed + 11)
    R = np.hypot(x[:, 0], x[:, 1]) + np.finfo(np.float64).tiny
    phi = np.arctan2(x[:, 1], x[:, 0])
    lnR = np.log(np.maximum(R, np.exp(tables.lnR[0])))

    vvZ = np.maximum(tables.interp3(phi, lnR, x[:, 2]), 0.0)
    vvR = np.maximum(tables.interp2(tables.sigR2, phi, lnR), 0.0)
    k2 = tables.interp2(tables.kappa2, phi, lnR)
    o2 = np.maximum(tables.interp2(tables.omega2, phi, lnR), 1e-30)
    vc = np.maximum(tables.interp2(tables.vc, phi, lnR), 0.0)
    frac = np.clip(k2 / (4.0 * o2), 0.25, 1.0)

    if gen_type == "jeans":
        vvP = vvR / (xi * xi)
        dln = -2.0 * R / acyl                      # hard-coded closure
    else:
        vvP = vvR * frac                            # vp_disp2 :1694-1707
        dln = tables.interp2(tables.dlnSsR2, phi, lnR)

    # mean streaming from the radial Jeans closure (DiskHalo.cc:2005-2016)
    vp2 = vc * vc + vvR * (1.0 - frac + dln)
    n_oob = int(np.sum(vp2 < 0.0))
    vbar = np.sqrt(np.maximum(vp2, 0.0))

    n = len(R)
    vr = rng.normal(0.0, 1.0, n) * np.sqrt(vvR)
    vp = vbar + rng.normal(0.0, 1.0, n) * np.sqrt(vvP)
    vz = rng.normal(0.0, 1.0, n) * np.sqrt(vvZ)

    cph, sph = np.cos(phi), np.sin(phi)
    v = np.stack([vr * cph - vp * sph, vr * sph + vp * cph, vz], axis=-1)
    if zero_cov:
        v -= v.mean(axis=0)
    return v, {"n_oob": n_oob, "max_sigR2": float(vvR.max()),
               "max_sigz2": float(vvZ.max()), "max_sigp2": float(vvP.max())}


def sample_multimass_halo(real: SphericalModelTable,
                          fake: SphericalModelTable, n: int, *,
                          ra=None, seed=0, allow_negative=False):
    """Multimass halo realization (SphericalModelMulti, DiskHalo.cc:225-287
    + realize_model.cc gen_point): positions and velocities from the FAKE
    (number-density) model's DF in the REAL potential, each particle
    weighted by f_real(E)/f_fake(E) so the mass density follows the real
    profile.  Returns (x, v, mass) with sum(mass) = real total mass."""
    # fake model re-packed with the real potential (DiskHalo.cc:249-274)
    r = fake.r
    pot = np.interp(r, real.r, real.pot)
    fake2 = SphericalModelTable(r, fake.rho, fake.mass, pot,
                                comment="multimass number model")
    x, v, _ = sample_spherical_model(fake2, n, seed=seed, ra=ra,
                                     tracer_only=True, zero_com=False)
    df_real = EddingtonDF(real, ra=ra)
    df_fake = EddingtonDF(fake2, ra=ra)
    rr = np.linalg.norm(x, axis=1)
    eps = df_real.psi(rr) - 0.5 * np.sum(v * v, axis=1)
    w = df_real.f(eps) / np.maximum(df_fake.f(eps), 1e-300)
    if not allow_negative:
        w = np.maximum(w, 0.0)
    mass = w / w.sum() * float(real.total_mass)
    return x, v, mass


def diskhalo_ics(halo_model: SphericalModelTable, *, n_halo, n_disk,
                 Mdisk, acyl, hcyl, halo_force, disk_force,
                 Q=0.0, sig0=0.1, xi=1.0, gen_type="asymmetric",
                 ra=None, compression=1.0, number_model=None,
                 ndp=8, ndr=40, ndz=128, shfactor=16.0,
                 rdmax=None, seed=0, zero_com=True,
                 zero_cov=True) -> DiskHaloICs:
    """The full gendisk pipeline (utils/ICs/initial.cc over DiskHalo.cc).

    halo_force / disk_force: the port's SphereSL and CylinderForce whose
    truncated fields the run will integrate; the measured expansions of the
    sampled particles give the potential for the halo DF and the disk
    Jeans tables."""
    # 1. composite model + halo DF in the total potential
    comp = add_disk_to_model(halo_model, Mdisk * compression, acyl)
    if number_model is not None:
        xh, vh, mh = sample_multimass_halo(comp, number_model, n_halo,
                                           ra=ra, seed=seed)
    else:
        xh, vh, mh = sample_spherical_model(comp, n_halo, seed=seed,
                                            ra=ra, tracer_only=True,
                                            zero_com=False)

    # 2. disk positions
    xd, md = sample_exponential_disk(n_disk, acyl=acyl, hcyl=hcyl,
                                     mass=Mdisk, seed=seed + 1)

    if zero_com:
        # each population's own sampling-noise COM (set_halo
        # DiskHalo.cc:488-494): the combined COM would shift the disk off
        # the expansion center by the halo's noise
        xh = xh - np.average(xh, axis=0, weights=np.maximum(mh, 0.0))
        xd = xd - np.average(xd, axis=0, weights=md)

    # 3. measured expansions of both populations
    dh, dd = _device_of(halo_force), _device_of(disk_force)
    ch = halo_force.coefficients(_f32(xh, dh), _f32(mh, dh))
    cd = disk_force.coefficients(_f32(xd, dd), _f32(md, dd))

    # 4. Jeans tables in the total measured field + disk velocity draws
    tables = build_disk_tables(
        halo_force, ch, disk_force, cd, Mdisk=Mdisk, acyl=acyl, hcyl=hcyl,
        Q=Q, sig0=sig0, ndp=ndp, ndr=ndr, ndz=ndz, shfactor=shfactor,
        rdmax=rdmax if rdmax is not None else 10.0 * acyl,
        # half the composite monopole: a noise guard only, so that the
        # velocities stay consistent with the truncated field the run
        # integrates (exp_tpu/ic/diskhalo.py:381-386)
        dphidr_floor=lambda R: 0.5 * comp.get_dpot(R))
    vd, vdiag = set_vel_disk(xd, tables, acyl=acyl, gen_type=gen_type,
                             xi=xi, seed=seed, zero_cov=zero_cov)

    if zero_cov:
        vh = vh - np.average(vh, axis=0, weights=np.maximum(mh, 0.0))

    diag = dict(vdiag)
    diag["sigma0"] = tables.sigma0
    return DiskHaloICs(x_halo=xh, v_halo=vh, m_halo=mh, x_disk=xd,
                       v_disk=vd, m_disk=md, tables=tables, diag=diag)


def virial_ratio(populations, forces_coefs):
    """-2T / VC with the Clausius virial from the measured expansions
    (DiskHalo::virial_ratio, DiskHalo.cc:2734-2896): VC = sum m x . F.

    populations: list of (x, v, mass) host arrays; forces_coefs: list of
    (force, coef) whose fields act on all populations, evaluated on the
    coefficients' device."""
    T = 0.0
    VC = 0.0
    for (x, v, m) in populations:
        T += 0.5 * float(np.sum(m * np.sum(np.asarray(v) ** 2, axis=1)))
        acc = None
        for force, coef in forces_coefs:
            a, _ = force.acceleration(coef, _f32(x, coef.device))
            acc = a if acc is None else acc + a
        VC += float(np.sum(m * np.sum(np.asarray(x) * acc.cpu().numpy(),
                                      axis=1)))
    return -2.0 * T / VC if VC != 0.0 else np.inf
