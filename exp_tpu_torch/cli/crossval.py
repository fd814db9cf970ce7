"""crossval — BFE vs direct-sum cross-validation of a snapshot
(utils/Analysis/cross_validation_*; port of exp_tpu/cli/crossval.py).  The
basis is exp_tpu's default backend on the parsed device (the f64 'matmul'
sphere or the f64 'xla' cylinder); the direct sum is host NumPy."""

import sys

from exp_tpu_torch.cli._common import make_parser, load_model, load_snapshot


def main(argv=None):
    ap = make_parser("crossval", __doc__)
    ap.add_argument("file")
    ap.add_argument("--type", default="ascii")
    ap.add_argument("--comp", default=None)
    ap.add_argument("-i", "--model", default="hernquist")
    ap.add_argument("--lmax", type=int, default=4)
    ap.add_argument("--nmax", type=int, default=10)
    ap.add_argument("--rmap", type=float, default=1.0)
    ap.add_argument("--ntest", type=int, default=512)
    ap.add_argument("--eof", default=None,
                    help="EOF cache file: cross-validate a cylinder basis "
                         "instead (cross_validation_cyl path)")
    a = ap.parse_args(argv)

    import torch

    from exp_tpu_torch.analysis.crossval import cross_validate

    if a.eof:
        from exp_tpu_torch.basis.empcyl import EmpCylTables
        from exp_tpu_torch.forces.cylinder import CylinderForce

        force = CylinderForce.from_tables(
            EmpCylTables.read_cache(a.eof), dtype=torch.float64,
            device=a.device)
    else:
        from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
        from exp_tpu_torch.forces.spherical import SphereSL

        model = load_model(a.model)
        t = build_sph_sl_tables(model, lmax=a.lmax, nmax=a.nmax, numr=1000,
                                cmap=1, rmap=a.rmap)
        force = SphereSL.from_tables(t, dtype=torch.float64,
                                     device=a.device)
    s = load_snapshot(a.file, a.type)
    x, v, m = s.GetParticles(a.comp)
    out = cross_validate(force, x, m, ntest=a.ntest)
    print("#      r   ferr_med   ferr_p90   perr_med    N")
    for i in range(len(out["r"])):
        print(f"{out['r'][i]:10.4g} {out['ferr_med'][i]:10.4g} "
              f"{out['ferr_p90'][i]:10.4g} {out['perr_med'][i]:10.4g} "
              f"{int(out['counts'][i]):5d}")
    print(f"# overall median force error: {out['ferr_all_med']:.4g}")


if __name__ == "__main__":
    sys.exit(main() or 0)
