"""gendisk — exponential-disk (+ halo) ICs (utils/ICs initial.cc over
DiskHalo.cc).

Disk-only (no --nhalo): sample the disk and close velocities with the
epicyclic recipe against the given rotation curve (the light path).

With --halo MODEL and --nhalo N: the full self-consistent DiskHalo
construction (ic/diskhalo.py): the halo DF is computed in the COMBINED
disk+halo potential (AddDisk), both populations are expanded with the
framework's own bases, and disk velocities come from Jeans moments of
the measured total field; writes the disk to -o and the halo to
--ohalo.  The expansions are the port's SphereSL ('matmul') and
CylinderForce ('xla') in f32, exp_tpu's defaults, on the card (or the CPU
with --cpu); the sampling draws are host NumPy in exp_tpu's order (port of
exp_tpu/cli/gendisk.py).
"""

import sys

from exp_tpu_torch.cli._common import make_parser, load_model


def main(argv=None):
    ap = make_parser("gendisk", __doc__)
    ap.add_argument("-N", "--number", type=int, default=10000)
    ap.add_argument("--acyl", type=float, default=0.01)
    ap.add_argument("--hcyl", type=float, default=0.002)
    ap.add_argument("--mass", type=float, default=0.05)
    ap.add_argument("--halo", default=None,
                    help="halo model (file or builtin)")
    ap.add_argument("--nhalo", type=int, default=0,
                    help="halo particles: > 0 switches to the "
                         "self-consistent DiskHalo construction")
    ap.add_argument("--ohalo", default="halo.bods",
                    help="halo bodies output (DiskHalo path)")
    ap.add_argument("--nhalo-number", dest="number_model", default=None,
                    help="optional number-density model for a multimass "
                         "halo (SphericalModelMulti path)")
    ap.add_argument("-Q", type=float, default=None,
                    help="Toomre Q for the radial dispersion.  Default: "
                         "1.2 on the disk-only path; 0 on the DiskHalo "
                         "path (the reference's DiskHalo::Q=0 default — "
                         "SIG0 exponential profile; Q > 0 with a heavy "
                         "inner disk can demand sigma_R >> v_c)")
    ap.add_argument("--sig0", type=float, default=0.1,
                    help="dispersion fraction at a scale length when "
                         "Q <= 0 (DiskHalo::SIG0)")
    ap.add_argument("--gentype", default="asymmetric",
                    choices=["asymmetric", "jeans"],
                    help="DiskHalo velocity closure (DiskGenType)")
    ap.add_argument("--lmax", type=int, default=4)
    ap.add_argument("--nmaxh", type=int, default=10,
                    help="halo expansion radial order")
    ap.add_argument("--mmax", type=int, default=4)
    ap.add_argument("--nmaxd", type=int, default=10,
                    help="disk EOF radial order")
    ap.add_argument("--eof-cache", default=None,
                    help="EOF table cache file (strongly recommended)")
    ap.add_argument("-o", "--output", default="disk.bods")
    ap.add_argument("-s", "--seed", type=int, default=7)
    a = ap.parse_args(argv)

    import numpy as np
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    if a.nhalo > 0:
        if not a.halo:
            ap.error("--nhalo requires --halo MODEL")
        from exp_tpu_torch.basis.empcyl import build_empcyl_tables
        from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
        from exp_tpu_torch.forces.cylinder import CylinderForce
        from exp_tpu_torch.forces.spherical import SphereSL
        from exp_tpu_torch.ic.diskhalo import (_f32, diskhalo_ics,
                                               virial_ratio)

        halo_model = load_model(a.halo)
        ts = build_sph_sl_tables(halo_model, lmax=a.lmax, nmax=a.nmaxh,
                                 numr=1000, cmap=1, rmap=1.0)
        halo_force = SphereSL.from_tables(ts, device=a.device)
        tc = build_empcyl_tables(mmax=a.mmax, nmax=a.nmaxd,
                                 lmaxfid=24, nmaxfid=16,
                                 acyl=a.acyl, hcyl=a.hcyl,
                                 cachename=a.eof_cache)
        disk_force = CylinderForce.from_tables(tc, device=a.device)
        number_model = (load_model(a.number_model)
                        if a.number_model else None)
        ics = diskhalo_ics(halo_model, n_halo=a.nhalo, n_disk=a.number,
                           Mdisk=a.mass, acyl=a.acyl, hcyl=a.hcyl,
                           halo_force=halo_force, disk_force=disk_force,
                           Q=a.Q if a.Q is not None else 0.0,
                           sig0=a.sig0, gen_type=a.gentype,
                           number_model=number_model, seed=a.seed)
        write_ascii_bodies(a.output,
                           (ics.x_disk, ics.v_disk, ics.m_disk))
        write_ascii_bodies(a.ohalo,
                           (ics.x_halo, ics.v_halo,
                            np.maximum(ics.m_halo, 0.0)))
        ch = halo_force.coefficients(_f32(ics.x_halo, a.device),
                                     _f32(np.maximum(ics.m_halo, 0),
                                          a.device))
        cd = disk_force.coefficients(_f32(ics.x_disk, a.device),
                                     _f32(ics.m_disk, a.device))
        vr = virial_ratio([(ics.x_halo, ics.v_halo, ics.m_halo),
                           (ics.x_disk, ics.v_disk, ics.m_disk)],
                          [(halo_force, ch), (disk_force, cd)])
        print(f"gendisk: wrote {a.number} disk bodies to {a.output}, "
              f"{a.nhalo} halo bodies to {a.ohalo} "
              f"(-2T/VC={vr:.4f}, n_oob={ics.diag['n_oob']})")
        return

    from exp_tpu_torch.ic.disk import sample_exponential_disk, disk_velocities

    x, m = sample_exponential_disk(a.number, acyl=a.acyl, hcyl=a.hcyl,
                                   mass=a.mass, seed=a.seed)

    def vc2_disk(R):
        # self-gravity estimate from the enclosed disk mass
        Menc = a.mass * (1 - (1 + R / a.acyl) * np.exp(-R / a.acyl))
        return Menc / np.maximum(R, 1e-12)

    if a.halo:
        halo = load_model(a.halo)

        def vc_of_R(R):
            # TOTAL rotation curve: halo force PLUS the disk's own
            # enclosed mass (disk_velocities' documented contract)
            return np.sqrt(np.maximum(R * halo.get_dpot(R)
                                      + vc2_disk(R), 0.0))
    else:
        def vc_of_R(R):
            return np.sqrt(np.maximum(vc2_disk(R), 0.0))

    v = disk_velocities(x, vc_of_R, acyl=a.acyl, seed=a.seed,
                        Q=a.Q if a.Q is not None else 1.2,
                        Mdisk=a.mass, hcyl=a.hcyl)
    write_ascii_bodies(a.output, (x, v, m))
    print(f"gendisk: wrote {a.number} bodies to {a.output}")


if __name__ == "__main__":
    sys.exit(main() or 0)
