"""psp2rings — ring-binned kinematic Fourier coefficient series from a
PSP snapshot sequence (utils/PhaseSpace/psp2rings.cc): per radial ring,
the mass-weighted mean cos/sin m phi amplitudes of (vr, vt, vz); a
ring-edge preamble then one binary RingCoefs block per snapshot in
{work}/{runtag}.{suffix}.

Port of exp_tpu/cli/psp2rings.py: the same flags, lines and files."""

import os
import sys

from exp_tpu_torch.cli._common import add_sequence_args, iter_psp_sequence, \
    make_parser


def main(argv=None):
    ap = make_parser("psp2rings", __doc__)
    add_sequence_args(ap, suffix_default="ring_coefs")
    ap.add_argument("-m", "--mmin", type=int, default=1,
                    help="minimum Fourier component in bin")
    ap.add_argument("-M", "--mmax", type=int, default=4,
                    help="maximum Fourier component in bin")
    ap.add_argument("-r", "--rmin", type=float, default=0.0,
                    help="minimum bin radius")
    ap.add_argument("-R", "--rmax", type=float, default=0.04,
                    help="maximum bin radius")
    ap.add_argument("-b", "--bins", type=int, default=40,
                    help="number of bins")
    a = ap.parse_args(argv)

    from exp_tpu_torch.analysis.kincoefs import ring_coefs, write_ring_coefs, \
        write_ring_preamble

    out = os.path.join(a.work, f"{a.runtag}.{a.suffix}")
    nsnap = 0
    with open(out, "wb") as fh:
        write_ring_preamble(fh, a.rmin, a.rmax, a.bins)
        for time, comp in iter_psp_sequence(a):
            cos_c, sin_c = ring_coefs(comp.mass, comp.x, comp.v,
                                      a.rmin, a.rmax, a.bins,
                                      mmin=a.mmin, mmax=a.mmax)
            write_ring_coefs(fh, time, cos_c, sin_c, mmin=a.mmin)
            nsnap += 1
    print(f"psp2rings: wrote {nsnap} snapshot block(s) to {out}")
    return 0 if nsnap else 1


if __name__ == "__main__":
    sys.exit(main() or 0)
