"""zangics — tapered-Mestel (Zang) 2D disk ICs (utils/ICs/ZangICs.cc;
port of exp_tpu/cli/zangics.py, the same flags and body file)."""

import sys

from exp_tpu_torch.cli._common import make_parser


def main(argv=None):
    ap = make_parser("zangics", __doc__)
    ap.add_argument("-N", "--number", type=int, default=100000)
    ap.add_argument("-n", "--nu", type=float, default=2.0,
                    help="inner taper exponent (0 = no taper)")
    ap.add_argument("-m", "--mu", type=float, default=2.0,
                    help="outer taper exponent (0 = no taper)")
    ap.add_argument("-i", "--Ri", type=float, default=1.0)
    ap.add_argument("-o", "--Ro", type=float, default=20.0)
    ap.add_argument("-r", "--Rmin", type=float, default=0.001)
    ap.add_argument("-R", "--Rmax", type=float, default=50.0)
    ap.add_argument("-S", "--sigma", type=float, default=1.0,
                    help="radial velocity dispersion")
    ap.add_argument("-q", "--Nrepl", type=int, default=1,
                    help="azimuthal replicates per orbit (quiet start)")
    ap.add_argument("-V", "--nozerovel", action="store_true")
    ap.add_argument("-P", "--nozeropos", action="store_true")
    ap.add_argument("-s", "--seed", type=int, default=11)
    ap.add_argument("-f", "--file", default="zang.bods")
    a = ap.parse_args(argv)

    from exp_tpu_torch.ic.zang import sample_zang_disk
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    x, v, m = sample_zang_disk(a.number, nu=a.nu, mu=a.mu, Ri=a.Ri,
                               Ro=a.Ro, sigma=a.sigma, rmin=a.Rmin,
                               rmax=a.Rmax, seed=a.seed,
                               zero_com=not a.nozeropos,
                               zero_cov=not a.nozerovel, nrepl=a.Nrepl)
    write_ascii_bodies(a.file, (x, v, m))
    print(f"zangics: wrote {len(x)} bodies to {a.file} "
          f"(M={m.sum():.6g})")


if __name__ == "__main__":
    sys.exit(main() or 0)
