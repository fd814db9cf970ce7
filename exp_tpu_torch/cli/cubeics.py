"""cubeics — periodic-cube ICs (utils/ICs/cubeics).

Port of exp_tpu/cli/cubeics.py: the same flags, lines and files."""

from exp_tpu_torch.cli._common import make_parser


def main(argv=None):
    ap = make_parser("cubeics", __doc__)
    ap.add_argument("-N", "--number", type=int, default=4000)
    ap.add_argument("-o", "--output", default="cube.bods")
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--mass", type=float, default=1.0)
    ap.add_argument("--pert-amp", type=float, default=0.0)
    ap.add_argument("--pert-k", type=int, nargs=3, default=None)
    ap.add_argument("-s", "--seed", type=int, default=0)
    a = ap.parse_args(argv)

    from exp_tpu_torch.ic.cubeics import sample_cube
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    x, v, m = sample_cube(a.number, mass=a.mass, sigma=a.sigma,
                          pert_k=a.pert_k, pert_amp=a.pert_amp, seed=a.seed)
    write_ascii_bodies(a.output, (x, v, m))
    print(f"cubeics: wrote {len(m)} bodies to {a.output}")


if __name__ == "__main__":
    main()
