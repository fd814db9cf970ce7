"""psp2bess — kinematic Fourier-Bessel coefficient series from a PSP
snapshot sequence (utils/PhaseSpace/psp2bess.cc): density and
cylindrical-velocity fields expanded in e^{im phi} x orthonormal
J_m(alpha_mn R/rmax); one binary BessCoefs block per snapshot appended
to {work}/{runtag}.{suffix}.

Port of exp_tpu/cli/psp2bess.py: the same flags, lines and files."""

import os
import sys

from exp_tpu_torch.cli._common import add_sequence_args, iter_psp_sequence, \
    make_parser


def main(argv=None):
    ap = make_parser("psp2bess", __doc__)
    add_sequence_args(ap, suffix_default="bess_coefs")
    ap.add_argument("-M", "--mmax", type=int, default=4,
                    help="maximum Fourier component")
    ap.add_argument("-R", "--rmax", type=float, default=0.04,
                    help="maximum radius")
    ap.add_argument("-n", "--nmax", type=int, default=8,
                    help="maximum Bessel order")
    a = ap.parse_args(argv)

    from exp_tpu_torch.analysis.kincoefs import bess_coefs, write_bess_coefs

    out = os.path.join(a.work, f"{a.runtag}.{a.suffix}")
    nsnap = 0
    with open(out, "wb") as fh:
        for time, comp in iter_psp_sequence(a):
            cos_c, sin_c = bess_coefs(comp.mass, comp.x, comp.v, a.rmax,
                                      mmax=a.mmax, nmax=a.nmax)
            write_bess_coefs(fh, time, a.rmax, cos_c, sin_c)
            nsnap += 1
    print(f"psp2bess: wrote {nsnap} snapshot block(s) to {out}")
    return 0 if nsnap else 1


if __name__ == "__main__":
    sys.exit(main() or 0)
