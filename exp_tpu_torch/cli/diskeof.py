"""diskeof — empirical re-orthogonalization of a disk EOF basis from a
PSP snapshot sequence (utils/Analysis/diskeof.cc): accumulate the
coefficient series and the mass-weighted modulus covariance D[m], SVD-
rotate to the distribution-adapted order hierarchy, write the
readcoefs-style amplitude tables (and optional in-plane grid maps).

Port of exp_tpu/cli/diskeof.py: the f32 'xla' cylinder of the cache on the
parsed device (exp_tpu_torch/analysis/diskeof.py sums in f64 there)."""

import os
import sys

from exp_tpu_torch.cli._common import add_sequence_args, iter_psp_sequence, \
    make_parser


def main(argv=None):
    ap = make_parser("diskeof", __doc__)
    add_sequence_args(ap, suffix_default="eof")
    ap.add_argument("--cachefile", required=True,
                    help="EOF basis cache (cylcache / build_empcyl_tables "
                         "HDF5)")
    ap.add_argument("--nmin", type=int, default=0,
                    help="first radial order of the analysis window")
    ap.add_argument("--nmax", type=int, default=None,
                    help="one past the last radial order (default: all)")
    ap.add_argument("--prefix", default="diskeof",
                    help="output file prefix")
    ap.add_argument("--grid", type=int, default=0, metavar="OUTR",
                    help="write (OUTR x OUTR) in-plane maps of every "
                         "rotated order to an npz")
    ap.add_argument("--rmax", type=float, default=0.1,
                    help="half-extent of the grid maps")
    ap.add_argument("--mbeg", type=int, default=0)
    ap.add_argument("--mend", type=int, default=None)
    a = ap.parse_args(argv)

    import numpy as np

    from exp_tpu_torch.analysis import diskeof as DE
    from exp_tpu_torch.basis.empcyl import EmpCylTables
    from exp_tpu_torch.forces.cylinder import CylinderForce

    tables = EmpCylTables.read_cache(a.cachefile)
    cyl = CylinderForce.from_tables(tables, device=a.device)

    def snaps():
        for time, comp in iter_psp_sequence(a):
            yield time, comp.mass, comp.x

    times, coefC, coefS, D = DE.accumulate(cyl, snaps(), nmin=a.nmin,
                                           nmax=a.nmax)
    if len(times) == 0:
        print("diskeof: no snapshots found", file=sys.stderr)
        return 1
    svals, Urot, rotC, rotS = DE.rotate(coefC, coefS, D)
    for m in range(svals.shape[0]):
        print(f"Singular values for m={m}:",
              " ".join(f"{v:.6g}" for v in svals[m]))

    base = os.path.join(a.work, f"{a.runtag}_{a.prefix}")
    DE.write_coef_tables(base + ".coefs", base + ".coefs_orig",
                         times, coefC, coefS, rotC, rotS)
    print(f"diskeof: wrote {base}.coefs / .coefs_orig "
          f"({len(times)} times, {coefC.shape[1]} harmonics, "
          f"{coefC.shape[2]} orders)")

    if a.grid:
        mend = svals.shape[0] - 1 if a.mend is None else a.mend
        for m in range(a.mbeg, min(mend, svals.shape[0] - 1) + 1):
            dens, pot = DE.rotated_grids(cyl, Urot, rotC, rotS, m,
                                         a.rmax, a.grid, nmin=a.nmin)
            out = f"{base}_rotated.{m:05d}.npz"
            np.savez(out, dens=dens, pot=pot, times=times,
                     svals=svals[m], rmax=a.rmax)
            print(f"diskeof: wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
