"""diskfreqs — rotation curve and epicyclic/vertical frequencies from a
cylinder (EOF) basis + snapshot (utils/Analysis/diskfreqs.cc):
  vc^2 = R dPhi/dR,  Omega = vc/R,
  kappa^2 = R dOmega^2/dR + 4 Omega^2,  nu^2 = d^2Phi/dz^2 |_(z=0)
evaluated from the m=0 field of the expansion (port of
exp_tpu/cli/diskfreqs.py: the f64 'xla' cylinder on the parsed device, one
upload of the snapshot and of the probe points)."""

import sys

import numpy as np

from exp_tpu_torch.cli._common import make_parser, load_snapshot


def main(argv=None):
    ap = make_parser("diskfreqs", __doc__)
    ap.add_argument("file", help="snapshot (bodies) to expand")
    ap.add_argument("--type", default="ascii")
    ap.add_argument("--comp", default=None)
    ap.add_argument("--eof", required=True, help="EOF cache file")
    ap.add_argument("--rmin", type=float, default=None)
    ap.add_argument("--rmax", type=float, default=None)
    ap.add_argument("--nout", type=int, default=40)
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)

    import torch

    from exp_tpu_torch.analysis.basis import download, upload
    from exp_tpu_torch.basis.empcyl import EmpCylTables
    from exp_tpu_torch.forces.cylinder import CylinderForce

    t = EmpCylTables.read_cache(a.eof)
    f = CylinderForce.from_tables(t, dtype=torch.float64, device=a.device)
    s = load_snapshot(a.file, a.type)
    x, v, m = s.GetParticles(a.comp)
    coef = download(f.coefficients(*upload(a.device, x, m)))
    # axisymmetric part only
    c0 = np.zeros_like(coef)
    c0[0, 0] = coef[0, 0]
    c0, = upload(a.device, c0)

    R = np.hypot(x[:, 0], x[:, 1])
    rmin = a.rmin if a.rmin else np.percentile(R, 1)
    rmax = a.rmax if a.rmax else np.percentile(R, 99)
    Rg = np.geomspace(rmin, rmax, a.nout)
    dz = 0.05 * t.hcyl
    pts = np.zeros((3 * a.nout, 3))
    pts[:a.nout, 0] = Rg
    pts[a.nout:2 * a.nout, 0] = Rg
    pts[a.nout:2 * a.nout, 2] = dz
    pts[2 * a.nout:, 0] = Rg
    pts[2 * a.nout:, 2] = -dz
    acc = download(f.acceleration(c0, *upload(a.device, pts))[0])
    aR = acc[:a.nout, 0]                    # a_R along +x at z=0
    vc2 = np.maximum(-Rg * aR, 0.0)
    Om2 = vc2 / Rg ** 2
    dOm2 = np.gradient(Om2, Rg)
    kap2 = np.maximum(Rg * dOm2 + 4.0 * Om2, 0.0)
    nu2 = np.maximum(-(acc[a.nout:2 * a.nout, 2]
                       - acc[2 * a.nout:, 2]) / (2.0 * dz), 0.0)
    out = a.output or a.file + ".diskfreqs"
    with open(out, "w") as fh:
        fh.write("# R vc Omega kappa nu\n")
        for i in range(a.nout):
            fh.write(f"{Rg[i]:.8g} {np.sqrt(vc2[i]):.8g} "
                     f"{np.sqrt(Om2[i]):.8g} {np.sqrt(kap2[i]):.8g} "
                     f"{np.sqrt(nu2[i]):.8g}\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    sys.exit(main() or 0)
