"""psp2lagu — kinematic Fourier-Laguerre coefficient series from a PSP
snapshot sequence (utils/PhaseSpace/psp2lagu.cc): density and
cylindrical-velocity fields expanded in e^{im phi} x orthonormal
L^1_n(2r/a) e^{-r/a}; one binary LaguCoefs block per snapshot appended
to {work}/{runtag}.{suffix}.

Port of exp_tpu/cli/psp2lagu.py: the same flags, lines and files."""

import os
import sys

from exp_tpu_torch.cli._common import add_sequence_args, iter_psp_sequence, \
    make_parser


def main(argv=None):
    ap = make_parser("psp2lagu", __doc__)
    add_sequence_args(ap, suffix_default="lagu_coefs")
    ap.add_argument("-M", "--mmax", type=int, default=4,
                    help="maximum Fourier component")
    ap.add_argument("-a", "--rscl", type=float, default=0.01,
                    help="Laguerre scale length")
    ap.add_argument("-n", "--nmax", type=int, default=8,
                    help="maximum Laguerre order")
    a = ap.parse_args(argv)

    from exp_tpu_torch.analysis.kincoefs import lagu_coefs, write_lagu_coefs

    out = os.path.join(a.work, f"{a.runtag}.{a.suffix}")
    nsnap = 0
    with open(out, "wb") as fh:
        for time, comp in iter_psp_sequence(a):
            cos_c, sin_c = lagu_coefs(comp.mass, comp.x, comp.v, a.rscl,
                                      mmax=a.mmax, nmax=a.nmax)
            write_lagu_coefs(fh, time, a.rscl, cos_c, sin_c)
            nsnap += 1
    print(f"psp2lagu: wrote {nsnap} snapshot block(s) to {out}")
    return 0 if nsnap else 1


if __name__ == "__main__":
    sys.exit(main() or 0)
