"""gensph — equilibrium spherical N-body realization (utils/ICs/gensph;
port of exp_tpu/cli/gensph.py, the same flags and body files).

    python -m exp_tpu_torch.cli.gensph -N 10000 -i SLGridSph.model -o new.bods

--qp evaluates its DF on the card (or the CPU with --cpu).
"""

from exp_tpu_torch.cli._common import make_parser, load_model


def main(argv=None):
    ap = make_parser("gensph", __doc__)
    ap.add_argument("-N", "--number", type=int, default=10000)
    ap.add_argument("-i", "--model", default="hernquist",
                    help="model file or builtin (hernquist[:a=..,M=..])")
    ap.add_argument("-o", "--output", default="new.bods")
    ap.add_argument("-s", "--seed", type=int, default=11)
    ap.add_argument("--rmin", type=float, default=1e-4)
    ap.add_argument("--rmax", type=float, default=20.0)
    ap.add_argument("--ra", type=float, default=None,
                    help="Osipkov-Merritt anisotropy radius")
    ap.add_argument("--qp", action="store_true",
                    help="quadratic-programming DF inversion (QPDistF: "
                         "nonnegative Gaussian-kernel fit on the (E, K) "
                         "plane) instead of the Eddington integral")
    ap.add_argument("--qp-lambda", type=float, default=0.0,
                    help="QP anisotropy penalty LAMBDA")
    ap.add_argument("--adddisk", default=None, metavar="MASS,ACYL",
                    help="embed an exponential disk: the halo DF responds "
                         "to the disk mass (AddDisk / DiskHalo path)")
    ap.add_argument("--addsphere", default=None, metavar="MODEL",
                    help="embed a second spherical model (file or builtin "
                         "spec, e.g. plummer:a=0.1,M=0.2): the sampled "
                         "component's DF responds to the total potential "
                         "(utils/ICs/AddSpheres)")
    ap.add_argument("--ebar", default=None, metavar="RBAR,BRATIO,CRATIO,M",
                    help="embed a homogeneous ellipsoidal bar with "
                         "semi-axes (RBAR, RBAR*BRATIO, RBAR*BRATIO*"
                         "CRATIO) and mass M: the halo DF responds to the "
                         "bar's monopole (gensph.cc EBAR / EllipForce)")
    ap.add_argument("--ebar-smooth", type=float, default=0.0,
                    help="Gaussian smoothing scale for the bar mass "
                         "profile (gensph.cc SMOOTH)")
    a = ap.parse_args(argv)

    from exp_tpu_torch.ic.eddington import sample_spherical_model
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    model = load_model(a.model, rmin=a.rmin, rmax=a.rmax)
    tracer_only = False
    if a.adddisk:
        from exp_tpu_torch.basis.model import add_disk_to_model

        md, ad = (float(s) for s in a.adddisk.split(","))
        model = add_disk_to_model(model, md, ad)
        tracer_only = True
    if a.addsphere:
        from exp_tpu_torch.basis.model import add_sphere_to_model

        other = load_model(a.addsphere, rmin=a.rmin, rmax=a.rmax)
        model = add_sphere_to_model(model, other)
        tracer_only = True
    if a.ebar:
        from exp_tpu_torch.ic.ellip import EllipForce, add_ellip_to_model

        rbar, brat, crat, mbar = (float(s) for s in a.ebar.split(","))
        ellip = EllipForce(rbar, rbar * brat, rbar * brat * crat, mbar)
        model = add_ellip_to_model(model, ellip, rbar=rbar,
                                   smooth=a.ebar_smooth)
        tracer_only = True
    if a.qp:
        if tracer_only:
            ap.error("--qp does not support --adddisk/--addsphere/--ebar "
                     "composite tracers (the QP fit constrains the "
                     "model's own density)")
        from exp_tpu_torch.ic.qpdistf import sample_qp_model

        x, v, m = sample_qp_model(model, a.number, seed=a.seed,
                                  lam=a.qp_lambda, device=a.device)
    else:
        x, v, m = sample_spherical_model(model, a.number, seed=a.seed,
                                         ra=a.ra, tracer_only=tracer_only)
    write_ascii_bodies(a.output, (x, v, m))
    print(f"gensph: wrote {a.number} bodies to {a.output} "
          f"(M={m.sum():.6g})")


if __name__ == "__main__":
    main()
