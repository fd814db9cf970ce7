"""gendisk2d — razor-thin 2D disk initial conditions
(utils/ICs/ZangICs.cc, initial2d.cc): sample a kuzmin / expon / mestel /
zang surface density, rotate at the model's circular speed with a
Toomre-Q radial dispersion (z = vz = 0).

With --halo MODEL and --nhalo N: the full self-consistent Disk2dHalo
construction (ic/diskhalo2d.py, Disk2dHalo.cc): halo DF in the combined
potential, disk velocities from in-plane Jeans moments of the measured
expansions; writes the halo to --ohalo."""

import sys

import numpy as np

from exp_tpu_torch.cli._common import make_parser


def main(argv=None):
    ap = make_parser("gendisk2d", __doc__)
    ap.add_argument("-N", type=int, default=10000)
    ap.add_argument("-i", "--model", default="zang",
                    choices=["kuzmin", "expon", "mestel", "zang"])
    ap.add_argument("--acyl", type=float, default=1.0)
    ap.add_argument("--mass", type=float, default=1.0)
    ap.add_argument("--Q", type=float, default=None,
                    help="Toomre Q.  Default 1.4 on the light path; 0 on "
                         "the Disk2dHalo path (SIG0 profile — a heavy "
                         "compact disk makes the Q dispersion exceed "
                         "v_c, as on the 3D path)")
    ap.add_argument("--rmax", type=float, default=10.0,
                    help="sampling radius in units of acyl (mestel/zang "
                         "extend automatically past the outer taper)")
    ap.add_argument("-o", "--output", default="disk2d.bods")
    ap.add_argument("-s", "--seed", type=int, default=11)
    ap.add_argument("--halo", default=None,
                    help="halo model (file or builtin)")
    ap.add_argument("--nhalo", type=int, default=0,
                    help="halo particles: > 0 switches to the "
                         "self-consistent Disk2dHalo construction")
    ap.add_argument("--ohalo", default="halo.bods")
    ap.add_argument("--sig0", type=float, default=0.1,
                    help="dispersion fraction at a scale length when "
                         "Q <= 0 on the Disk2dHalo path")
    ap.add_argument("--lmax", type=int, default=4)
    ap.add_argument("--nmaxh", type=int, default=10)
    ap.add_argument("--mmax", type=int, default=4)
    ap.add_argument("--nmaxd", type=int, default=8)
    ap.add_argument("--disk-cache", default=None,
                    help="flatdisk table cache file")
    a = ap.parse_args(argv)
    from exp_tpu_torch.basis.flatdisk import surface_density_model, _trapz_w
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    if a.nhalo > 0:
        if not a.halo:
            ap.error("--nhalo requires --halo MODEL")
        from exp_tpu_torch.basis.flatdisk import build_flatdisk_tables
        from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
        from exp_tpu_torch.cli._common import load_model
        from exp_tpu_torch.forces.cylinder import CylinderForce
        from exp_tpu_torch.forces.spherical import SphereSL
        from exp_tpu_torch.ic.diskhalo import _f32, virial_ratio
        from exp_tpu_torch.ic.diskhalo2d import diskhalo2d_ics

        # same taper-extension rule as the light path: truncating a
        # mestel/zang realization mid-taper (Sigma still ~50% at the
        # taper center) seeds spurious transients AND mis-states the
        # disk monopole the halo DF responds to
        rmax_eff = a.rmax * a.acyl
        if a.model in ("mestel", "zang"):
            rmax_eff = max(rmax_eff, 40.0 * a.acyl)
        halo_model = load_model(a.halo)
        ts = build_sph_sl_tables(halo_model, lmax=a.lmax, nmax=a.nmaxh,
                                 numr=1000, cmap=1, rmap=1.0)
        halo_force = SphereSL.from_tables(ts, device=a.device)
        td = build_flatdisk_tables(mmax=a.mmax, nmax=a.nmaxd,
                                   model=a.model, acyl=a.acyl,
                                   Mtot=a.mass, cachename=a.disk_cache)
        disk_force = CylinderForce.from_tables(td, device=a.device)
        ics = diskhalo2d_ics(halo_model, n_halo=a.nhalo, n_disk=a.N,
                             Mdisk=a.mass, acyl=a.acyl,
                             halo_force=halo_force, disk_force=disk_force,
                             model=a.model,
                             Q=a.Q if a.Q is not None else 0.0,
                             sig0=a.sig0, rdmax=rmax_eff,
                             seed=a.seed)
        write_ascii_bodies(a.output, (ics.x_disk, ics.v_disk, ics.m_disk))
        write_ascii_bodies(a.ohalo, (ics.x_halo, ics.v_halo,
                                     np.maximum(ics.m_halo, 0.0)))
        ch = halo_force.coefficients(_f32(ics.x_halo, a.device),
                                     _f32(np.maximum(ics.m_halo, 0),
                                          a.device))
        cd = disk_force.coefficients(_f32(ics.x_disk, a.device),
                                     _f32(ics.m_disk, a.device))
        vr = virial_ratio([(ics.x_halo, ics.v_halo, ics.m_halo),
                           (ics.x_disk, ics.v_disk, ics.m_disk)],
                          [(halo_force, ch), (disk_force, cd)])
        print(f"gendisk2d: wrote {a.N} disk bodies to {a.output}, "
              f"{a.nhalo} halo bodies to {a.ohalo} "
              f"(-2T/VC={vr:.4f}, n_oob={ics.diag['n_oob']})")
        return

    rng = np.random.default_rng(a.seed)
    S = surface_density_model(a.model, a=a.acyl, M=a.mass)
    rmax_eff = a.rmax * a.acyl
    if a.model in ("mestel", "zang"):
        # the Zang outer taper is centered at router = 10 a (Sigma is
        # still 50% there): sample well past it or the realization gets
        # a hard edge mid-taper, seeding spurious transients
        rmax_eff = max(rmax_eff, 40.0 * a.acyl)
    Rg = np.geomspace(1e-3 * a.acyl, rmax_eff, 4000)
    w = _trapz_w(Rg)
    dM = 2.0 * np.pi * np.asarray(S(Rg)) * Rg * w
    cum = np.cumsum(dM)
    Mtot = cum[-1]
    # positions from the cumulative surface mass
    u = rng.uniform(0, 1, a.N) * Mtot
    R = np.interp(u, cum, Rg)
    phi = rng.uniform(0, 2 * np.pi, a.N)
    x = np.stack([R * np.cos(phi), R * np.sin(phi), np.zeros(a.N)], -1)
    # circular speed of the razor-thin disk: midplane radial force by
    # direct ring quadrature is expensive; use the spherical approximation
    # vc^2 = M(<R)/R (good to ~15% for these profiles) plus Q-dispersion
    Menc = np.interp(R, Rg, cum)
    vc = np.sqrt(np.maximum(Menc / np.maximum(R, 1e-12), 0.0))
    kappa = np.sqrt(2.0) * vc / np.maximum(R, 1e-12)   # flat-curve approx
    Qlight = a.Q if a.Q is not None else 1.4
    sigR = 3.36 * np.asarray(S(R)) * Qlight / np.maximum(kappa, 1e-12)
    sigR = np.minimum(sigR, 0.7 * vc)
    vR = rng.normal(0, 1, a.N) * sigR
    vP = np.sqrt(np.maximum(vc ** 2 - 2.0 * sigR ** 2, 0.0)) \
        + rng.normal(0, 1, a.N) * sigR / np.sqrt(2.0)
    v = np.stack([vR * np.cos(phi) - vP * np.sin(phi),
                  vR * np.sin(phi) + vP * np.cos(phi),
                  np.zeros(a.N)], -1)
    m = np.full(a.N, Mtot / a.N)
    write_ascii_bodies(a.output, (x, v, m))
    print(f"gendisk2d: wrote {a.N} bodies to {a.output} "
          f"(model={a.model}, M={Mtot:.6g})")


if __name__ == "__main__":
    sys.exit(main() or 0)
