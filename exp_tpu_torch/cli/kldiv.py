"""kldiv — KL divergence between the radial mass profiles of two
snapshots (utils/Analysis/KL_sph.cc, KL_cyl.cc).  With --cyl the profile
is in cylindrical R (the KL_cyl mode).  Port of exp_tpu/cli/kldiv.py,
host NumPy."""

import sys

import numpy as np

from exp_tpu_torch.cli._common import make_parser, load_snapshot


def main(argv=None):
    ap = make_parser("kldiv", __doc__)
    ap.add_argument("file1")
    ap.add_argument("file2")
    ap.add_argument("--type", default="ascii")
    ap.add_argument("--comp", default=None)
    ap.add_argument("--nbins", type=int, default=32)
    ap.add_argument("--cyl", action="store_true",
                    help="cylindrical-R profiles (KL_cyl)")
    a = ap.parse_args(argv)
    from exp_tpu_torch.analysis.crossval import kl_divergence_radial

    s1 = load_snapshot(a.file1, a.type)
    s2 = load_snapshot(a.file2, a.type)
    x1, _, m1 = s1.GetParticles(a.comp)
    x2, _, m2 = s2.GetParticles(a.comp)
    if a.cyl:
        x1 = np.concatenate([x1[:, :2], np.zeros((len(x1), 1))], axis=1)
        x2 = np.concatenate([x2[:, :2], np.zeros((len(x2), 1))], axis=1)
    kl = kl_divergence_radial(x1, m1, x2, m2, nbins=a.nbins)
    print(f"KL(p1 || p2) = {kl:.6g}  ({'cylindrical' if a.cyl else 'spherical'} "
          f"radial profile, {a.nbins} bins)")
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
