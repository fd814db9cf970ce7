"""pspmono — spherical monopole model table from a snapshot
(utils/PhaseSpace/pspmono.cc): radial-bin density/mass/potential of the
selected component, written in the 4-column SphericalModelTable format
(usable as a gensph/halo input or a Direct pm_model profile).

Port of exp_tpu/cli/pspmono.py: the same flags, lines and files."""

import sys

from exp_tpu_torch.cli._common import make_parser


def main(argv=None):
    ap = make_parser("pspmono", __doc__)
    ap.add_argument("file", help="snapshot file")
    ap.add_argument("--type", default="psp",
                    choices=["psp", "gadget", "tipsy", "ascii"])
    ap.add_argument("--comp", default=None,
                    help="component name (PSP multi-component dumps)")
    ap.add_argument("--rmin", type=float, default=None)
    ap.add_argument("--rmax", type=float, default=None)
    ap.add_argument("--rnum", type=int, default=1000,
                    help="number of radial grid points")
    ap.add_argument("--center", type=float, nargs=3, default=None,
                    metavar=("X", "Y", "Z"),
                    help="expansion center (default: density center)")
    ap.add_argument("-o", "--output", default="model.file")
    a = ap.parse_args(argv)

    import numpy as np
    from exp_tpu_torch.basis.model import model_from_particles
    from exp_tpu_torch.io.readers import createReader

    s = createReader(a.type, a.file)
    x, v, m = s.GetParticles(a.comp)
    x = np.asarray(x, np.float64)
    if a.center is not None:
        x = x - np.asarray(a.center)
    model = model_from_particles(x, np.asarray(m, np.float64),
                                 numr=a.rnum, rmin=a.rmin, rmax=a.rmax)
    model.to_file(a.output)
    print(f"pspmono: wrote {a.rnum}-point model to {a.output} "
          f"(M={model.total_mass:.6g})")


if __name__ == "__main__":
    sys.exit(main() or 0)
