"""genslab — periodic-slab initial conditions (utils/ICs/genslab.cc):
uniform in (x, y) on [0, L)^2, isothermal Spitzer sheet in z
(rho ~ sech^2(z/z0), sigma_z^2 = pi G Sigma z0, G = 1).

Port of exp_tpu/cli/genslab.py: the same flags, lines and files."""

import sys

import numpy as np

from exp_tpu_torch.cli._common import make_parser


def main(argv=None):
    ap = make_parser("genslab", __doc__)
    ap.add_argument("-N", type=int, default=10000)
    ap.add_argument("-o", "--output", default="slab.bods")
    ap.add_argument("--L", type=float, default=1.0)
    ap.add_argument("--z0", type=float, default=0.02,
                    help="sech^2 scale height")
    ap.add_argument("--mass", type=float, default=1.0)
    ap.add_argument("--sigmaxy", type=float, default=None,
                    help="in-plane dispersion (default: sigma_z)")
    ap.add_argument("-s", "--seed", type=int, default=11)
    a = ap.parse_args(argv)
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    rng = np.random.default_rng(a.seed)
    x = rng.uniform(0.0, a.L, (a.N, 2))
    # slab convention (forces/slab.py): x, y in [0, L), z centered on 0
    z = a.z0 * np.arctanh(rng.uniform(-1, 1, a.N) * 0.9999999)
    pos = np.concatenate([x, z[:, None]], axis=1)
    sigma = a.mass / a.L ** 2                      # surface density
    sz = np.sqrt(np.pi * sigma * a.z0)             # Spitzer sheet, G=1
    sxy = a.sigmaxy if a.sigmaxy is not None else sz
    v = np.stack([rng.normal(0, sxy, a.N), rng.normal(0, sxy, a.N),
                  rng.normal(0, sz, a.N)], axis=1)
    m = np.full(a.N, a.mass / a.N)
    write_ascii_bodies(a.output, (pos, v, m))
    print(f"genslab: wrote {a.N} bodies to {a.output} "
          f"(z0={a.z0}, sigma_z={sz:.4g})")


if __name__ == "__main__":
    sys.exit(main() or 0)
