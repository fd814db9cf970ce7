"""slshift — multipole expansion of a rigidly shifted spherical model
(utils/SL/slshift.cc): shift the model density a distance `--offset` along
the z-axis, project it onto the SL basis (the Shift/Reconstruct pair,
slshift.cc:57-230), dump the cosine coefficient table per (l, n), and
tabulate the reconstructed vs true density and potential along the +/- z
axis.  A sharp check of basis completeness: the shifted monopole feeds all
odd-l channels, and the profile error shows where the radial span runs out.

The projection integrates rho(|r - d zhat|) against the basis with the
same particle-projection kernel the N-body code uses, on an (r, cos theta)
Gauss-Legendre quadrature grid entered as weighted particles — so the
coefficients come out in exactly the convention SphereSL.density/
acceleration expect (slshift.cc does the same via scalar_prod).

Port of exp_tpu/cli/slshift.py: the f64 'matmul' sphere on the parsed
device, one upload of the quadrature particles and one of the axis."""

import sys

import numpy as np

from exp_tpu_torch.cli._common import make_parser, load_model


def main(argv=None):
    ap = make_parser("slshift", __doc__)
    ap.add_argument("-i", "--model", default="hernquist")
    ap.add_argument("--offset", type=float, default=0.1,
                    help="shift distance along z")
    ap.add_argument("--lmax", type=int, default=6)
    ap.add_argument("--nmax", type=int, default=12)
    ap.add_argument("--numr", type=int, default=1000,
                    help="SL grid points")
    ap.add_argument("--nquad-r", type=int, default=400,
                    help="radial quadrature nodes")
    ap.add_argument("--nquad-t", type=int, default=200,
                    help="angular quadrature nodes")
    ap.add_argument("--nout", type=int, default=60,
                    help="profile output points")
    ap.add_argument("-o", "--output", default="slshift",
                    help="output prefix")
    a = ap.parse_args(argv)

    import torch

    from exp_tpu_torch.analysis.basis import download, upload
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
    from exp_tpu_torch.forces.spherical import SphereSL

    model = load_model(a.model)
    t = build_sph_sl_tables(model, lmax=a.lmax, nmax=a.nmax, numr=a.numr,
                            cmap=1, rmap=1.0)
    force = SphereSL.from_tables(t, dtype=torch.float64, device=a.device)

    # quadrature "particles": w_ij = rho(|x - d zhat|) r^2 dr d(cos th) dphi
    # (m-symmetry: the shifted density is axisymmetric, phi integrates to
    # 2 pi and only m=0 channels survive — slshift.cc:151-168)
    d = a.offset
    rmin, rmax = float(model.rmin), float(model.rmax)
    # log-radius Gauss-Legendre absorbs the cusp
    xg, wg = np.polynomial.legendre.leggauss(a.nquad_r)
    lr = 0.5 * (np.log(rmax) + np.log(rmin)) \
        + 0.5 * (np.log(rmax) - np.log(rmin)) * xg
    r = np.exp(lr)
    wr = 0.5 * (np.log(rmax) - np.log(rmin)) * wg * r  # dr = r dlr
    cg, wc = np.polynomial.legendre.leggauss(a.nquad_t)
    R, C = np.meshgrid(r, cg, indexing="ij")
    WR, WC = np.meshgrid(wr, wc, indexing="ij")
    # |x - d zhat|^2 = r^2 + d^2 - 2 d r cos(theta)
    rshift = np.sqrt(np.maximum(R * R + d * d - 2.0 * d * R * C, 1e-30))
    rho = np.asarray(model.get_density(np.clip(rshift, rmin, rmax)))
    rho = np.where((rshift >= rmin) & (rshift <= rmax), rho, 0.0)
    w = (2.0 * np.pi * rho * R * R * WR * WC).ravel()
    sint = np.sqrt(np.maximum(1.0 - C * C, 0.0))
    pts = np.column_stack([(R * sint).ravel(), np.zeros(R.size),
                           (R * C).ravel()])

    coef_d = force.coefficients(*upload(a.device, pts, w))
    coef = download(coef_d)

    # coefficient dump (slshift.cc dump_coefficients: cosine terms only)
    cout = f"{a.output}.coefs"
    with open(cout, "w") as f:
        f.write("# cosine coefficients (m=0 channels of the shifted "
                "model)\n#    l     " +
                "".join(f"{'n=%d' % n:>16s}" for n in range(a.nmax)) + "\n")
        for l in range(a.lmax + 1):
            row = coef[0, l, 0] if coef.ndim == 4 else coef[l, 0]
            f.write(f"{l:6d}" + "".join(f"{v:16.8e}" for v in row) + "\n")
    print(f"slshift: wrote {cout}")

    # profile along the z axis (both signs), reconstructed vs true
    zs = np.concatenate([-np.geomspace(rmax * 0.9, rmin * 2, a.nout // 2),
                         np.geomspace(rmin * 2, rmax * 0.9, a.nout // 2)])
    ppts = np.column_stack([np.zeros_like(zs), np.zeros_like(zs), zs])
    dens = download(force.density(coef_d, *upload(a.device, ppts)))
    rtrue = np.abs(zs - d)
    dtrue = np.where((rtrue >= rmin) & (rtrue <= rmax),
                     np.asarray(model.get_density(
                         np.clip(rtrue, rmin, rmax))), 0.0)
    pout = f"{a.output}.profile"
    np.savetxt(pout, np.column_stack([zs, dens, dtrue,
                                      dens - dtrue]),
               header="z dens_recon dens_true error")
    rel = (np.abs(dens - dtrue)[np.abs(dtrue) > 0]
           / np.abs(dtrue)[np.abs(dtrue) > 0])
    print(f"slshift: wrote {pout}; median |rel err| on axis = "
          f"{np.median(rel):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
