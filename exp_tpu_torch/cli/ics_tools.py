"""IC-toolbox utilities: modelfit, addring, forcetest, addsphmod,
hdf52accel (reference utils/ICs/ModelFit.cc, addring.cc, force_test.cc,
addsphmod.cc, hdf52accel.cc; port of exp_tpu/cli/ics_tools.py).

These complete the utils/ICs family beyond the generators (gensph,
gendisk, cubeics, ...): fitting an analytic profile to a realization,
adding a ring population to an existing realization, and measuring BFE
force errors against the direct O(N^2) sum.
"""

from __future__ import annotations

import numpy as np

from exp_tpu_torch.cli._common import make_parser, load_model, load_snapshot


# ---------------------------------------------------------------------------
# modelfit
# ---------------------------------------------------------------------------

def _profiles():
    """family -> (param names, initial guess, rho(r, params))."""
    def hernquist(r, p):
        M, a = p
        return M * a / (2 * np.pi * r * (r + a) ** 3)

    def plummer(r, p):
        M, a = p
        return 3 * M / (4 * np.pi * a ** 3) * (1 + (r / a) ** 2) ** -2.5

    def nfw(r, p):
        rho0, a = p
        return rho0 / ((r / a) * (1 + r / a) ** 2)

    def powerlaw(r, p):
        rho0, alpha = p
        return rho0 * r ** (-alpha)

    return {
        "hernquist": (("M", "a"), (1.0, 1.0), hernquist),
        "plummer": (("M", "a"), (1.0, 1.0), plummer),
        "nfw": (("rho0", "a"), (1.0, 1.0), nfw),
        "powerlaw": (("rho0", "alpha"), (1.0, 2.0), powerlaw),
    }


def binned_density(x, mass, nbins=40, rmin=None, rmax=None):
    """Spherically averaged rho(r) from a snapshot (log bins)."""
    r = np.sqrt((x * x).sum(axis=1))
    if rmin is None:
        rmin = np.quantile(r[r > 0], 0.005)
    if rmax is None:
        rmax = np.quantile(r, 0.99)
    edges = np.geomspace(rmin, rmax, nbins + 1)
    idx = np.digitize(r, edges) - 1
    ok = (idx >= 0) & (idx < nbins)
    msum = np.bincount(idx[ok], weights=mass[ok], minlength=nbins)
    vol = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    rc = np.sqrt(edges[1:] * edges[:-1])
    keep = msum > 0
    return rc[keep], (msum / vol)[keep]


def fit_profile(rc, rho, family="hernquist"):
    """Least-squares fit in log space; returns (params dict, rms log
    residual).  The reference anneals (utils/ICs/ModelFit.cc SimAnn);
    log-space LSQ with positivity via log-params is equally robust for
    these monotone 2-parameter families and deterministic."""
    from scipy.optimize import least_squares

    names, p0, fn = _profiles()[family]
    lrho = np.log(rho)

    def resid(q):
        return np.log(fn(rc, np.exp(q))) - lrho

    sol = least_squares(resid, np.log(np.asarray(p0)), method="lm")
    p = np.exp(sol.x)
    rms = float(np.sqrt(np.mean(resid(sol.x) ** 2)))
    return dict(zip(names, p.tolist())), rms


def modelfit(argv=None):
    """modelfit — fit an analytic density profile to a snapshot and
    optionally write a SphericalModelTable file usable as a sphereSL
    `modelname` (utils/ICs/ModelFit.cc)."""
    ap = make_parser("modelfit", modelfit.__doc__)
    ap.add_argument("file")
    ap.add_argument("--type", default=None)
    ap.add_argument("--comp", default=None)
    ap.add_argument("--family", default="hernquist",
                    choices=sorted(_profiles()))
    ap.add_argument("--nbins", type=int, default=40)
    ap.add_argument("--rmin", type=float, default=None)
    ap.add_argument("--rmax", type=float, default=None)
    ap.add_argument("-o", "--output", default=None,
                    help="write the fitted model as a model table file")
    a = ap.parse_args(argv)

    s = load_snapshot(a.file, a.type)
    x, _, m = s.GetParticles(a.comp)
    rc, rho = binned_density(x, m, nbins=a.nbins, rmin=a.rmin, rmax=a.rmax)
    params, rms = fit_profile(rc, rho, a.family)
    pstr = " ".join(f"{k}={v:.6g}" for k, v in params.items())
    print(f"{a.family}: {pstr}  rms(log rho)={rms:.3f}")

    if a.output:
        from exp_tpu_torch.basis.model import (SphericalModelTable,
                                         hernquist_model, plummer_model)

        if a.family == "hernquist":
            mt = hernquist_model(a=params["a"], M=params["M"],
                                 rmin=rc[0], rmax=rc[-1])
        elif a.family == "plummer":
            mt = plummer_model(a=params["a"], M=params["M"],
                               rmin=rc[0], rmax=rc[-1])
        else:
            names, _, fn = _profiles()[a.family]
            p = np.array([params[k] for k in names])
            mt = SphericalModelTable.from_density(
                lambda r: fn(r, p), rmin=rc[0], rmax=rc[-1])
        mt.to_file(a.output)
        print(f"wrote {a.output}")
    return 0


# ---------------------------------------------------------------------------
# addring
# ---------------------------------------------------------------------------

def addring(argv=None):
    """addring — add a cold ring population to an existing realization
    (utils/ICs/addring.cc).  Ring particles get circular velocities from
    the spherically-enclosed snapshot mass (the reference re-expands the
    blend through SphericalSL; the monopole estimate differs by the ring's
    own quadrupole, negligible for mring << M(<R))."""
    ap = make_parser("addring", addring.__doc__)
    ap.add_argument("file", help="input body file (ascii)")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--nring", type=int, default=10000)
    ap.add_argument("--radius", type=float, default=1.0)
    ap.add_argument("--mring", type=float, default=0.01,
                    help="total ring mass")
    ap.add_argument("--width", type=float, default=0.05,
                    help="gaussian radial width (fraction of radius)")
    ap.add_argument("--height", type=float, default=0.01,
                    help="gaussian vertical width (fraction of radius)")
    ap.add_argument("--seed", type=int, default=11)
    a = ap.parse_args(argv)

    from exp_tpu_torch.nbody.particles import (read_ascii_arrays,
                                               write_ascii_bodies)

    # the body file's rows rounded to float32, as a ParticleSystem of
    # exp_tpu's default dtype holds them
    x, v, m = (np.asarray(c, np.float32) for c in read_ascii_arrays(a.file))
    rng = np.random.default_rng(a.seed)
    R = a.radius * (1.0 + a.width * rng.standard_normal(a.nring))
    R = np.abs(R)
    z = a.radius * a.height * rng.standard_normal(a.nring)
    ph = rng.uniform(0, 2 * np.pi, a.nring)
    xr = np.stack([R * np.cos(ph), R * np.sin(ph), z], axis=-1)

    # circular speed from the enclosed mass of the blend (G = 1):
    # sort + cumsum + searchsorted, O((N + nring) log N)
    r_old = np.sqrt((x * x).sum(axis=1))
    order = np.argsort(r_old)
    csum = np.concatenate([[0.0], np.cumsum(m[order])])
    Menc = csum[np.searchsorted(r_old[order], R)] + 0.5 * a.mring
    vc = np.sqrt(Menc / np.maximum(R, 1e-12))
    vr = np.stack([-vc * np.sin(ph), vc * np.cos(ph),
                   np.zeros(a.nring)], axis=-1)
    mr = np.full(a.nring, a.mring / a.nring)

    write_ascii_bodies(a.output,
                       (np.concatenate([x, xr]), np.concatenate([v, vr]),
                        np.concatenate([m, mr])))
    print(f"wrote {a.output}: {len(m)} + {a.nring} ring particles "
          f"(vc({a.radius}) = {np.sqrt((m[r_old < a.radius].sum() + 0.5 * a.mring) / a.radius):.4f})")
    return 0


# ---------------------------------------------------------------------------
# forcetest
# ---------------------------------------------------------------------------

def forcetest(argv=None):
    """forcetest — BFE force errors vs the direct O(N^2) sum on a particle
    subset (utils/ICs/force_test.cc over DiskEval; here the truth is the
    softened direct sum, the candidate the sphereSL expansion)."""
    ap = make_parser("forcetest", forcetest.__doc__)
    ap.add_argument("file")
    ap.add_argument("--type", default=None)
    ap.add_argument("--comp", default=None)
    ap.add_argument("--model", default="hernquist",
                    help="conditioning model for the SL basis, or a file")
    ap.add_argument("--lmax", type=int, default=4)
    ap.add_argument("--nmax", type=int, default=10)
    ap.add_argument("--numr", type=int, default=1000)
    ap.add_argument("--rmap", type=float, default=1.0)
    ap.add_argument("--nsample", type=int, default=500,
                    help="test points (direct sum is O(N * nsample))")
    ap.add_argument("--eps", type=float, default=1e-3,
                    help="Plummer softening of the direct-sum truth")
    ap.add_argument("--seed", type=int, default=5)
    a = ap.parse_args(argv)

    import torch

    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
    from exp_tpu_torch.forces.spherical import SphereSL

    s = load_snapshot(a.file, a.type)
    x, _, m = s.GetParticles(a.comp)
    model = load_model(a.model)
    t = build_sph_sl_tables(model, lmax=a.lmax, nmax=a.nmax, numr=a.numr,
                            cmap=1, rmap=a.rmap)
    # the expansion in f64 on the device (the card, or the CPU with --cpu)
    force = SphereSL.from_tables(t, dtype=torch.float64, backend="gather",
                                 device=a.device)

    def f64(arr):
        return torch.as_tensor(np.asarray(arr), dtype=torch.float64,
                               device=a.device)

    coef = force.coefficients(f64(x), f64(m), accum_dtype=torch.float64)

    rng = np.random.default_rng(a.seed)
    sel = rng.choice(x.shape[0], size=min(a.nsample, x.shape[0]),
                     replace=False)
    pts = x[sel]
    acc_b, _ = force.acceleration(coef, f64(pts))
    acc_b = acc_b.cpu().numpy()

    # direct softened sum, chunked over source particles so memory stays
    # O(nsample * chunk) regardless of snapshot size
    acc_d = np.zeros_like(pts)
    chunk = max(1, 10_000_000 // max(1, pts.shape[0]))
    for i0 in range(0, x.shape[0], chunk):
        xs_c = x[i0:i0 + chunk]
        d = pts[:, None, :] - xs_c[None, :, :]          # (S, c, 3)
        r2 = (d * d).sum(axis=2) + a.eps ** 2
        w = m[None, i0:i0 + chunk] * r2 ** -1.5
        acc_d -= (d * w[:, :, None]).sum(axis=1)

    nd = np.linalg.norm(acc_d, axis=1)
    err = np.linalg.norm(acc_b - acc_d, axis=1) / np.maximum(nd, 1e-30)
    for q in (50, 90, 99):
        print(f"p{q} relative force error: {np.percentile(err, q):.4f}")
    print(f"mean: {err.mean():.4f}  (lmax={a.lmax} nmax={a.nmax} "
          f"N={x.shape[0]} sample={len(sel)})")
    return 0


# ---------------------------------------------------------------------------
# addsphmod
# ---------------------------------------------------------------------------

def addsphmod(argv=None):
    """addsphmod — add two spherical model tables into one composite model
    (utils/ICs/addsphmod.cc: AddSpheres combo(mod1, mod2, bmass) written
    back out as a model table).  The second model's density, enclosed
    mass, and potential are scaled by --bmass and added on the first
    model's radial grid."""
    ap = make_parser("addsphmod", addsphmod.__doc__)
    ap.add_argument("model1", help="first model table (or builtin name)")
    ap.add_argument("model2", help="second model table (or builtin name)")
    ap.add_argument("--bmass", type=float, default=1.0,
                    help="mass factor for the second model (addsphmod.cc "
                         "--bmass)")
    ap.add_argument("-o", "--output", default="new.model")
    a = ap.parse_args(argv)

    from exp_tpu_torch.basis.model import add_sphere_to_model
    from exp_tpu_torch.cli._common import load_model

    m1 = load_model(a.model1)
    m2 = load_model(a.model2)
    combo = add_sphere_to_model(m1, m2, mass_scale=a.bmass,
                                include_density=True)
    combo.to_file(a.output)
    print(f"wrote {a.output}: M1={m1.mass[-1]:.6g} + "
          f"{a.bmass} x M2={m2.mass[-1]:.6g} -> "
          f"Mtot={combo.mass[-1]:.6g} over r in "
          f"[{combo.r[0]:.4g}, {combo.r[-1]:.4g}]")
    return 0


# ---------------------------------------------------------------------------

def hdf52accel(argv=None):
    """hdf52accel — dump the acceleration field of a GadgetHDF5 snapshot
    (utils/ICs/hdf52accel.cc): per particle of the chosen PartType,
    write the binary force.data record [int N; per body: float mass,
    float pos[3], float acc[3]] for force-comparison studies."""
    ap = make_parser("hdf52accel", hdf52accel.__doc__)
    ap.add_argument("--hdf5", default="snapfile_001.hdf5",
                    help="HDF5 Gadget2 file")
    ap.add_argument("--output", default="force.data")
    ap.add_argument("--ptype", type=int, default=2,
                    help="Gadget particle type (reference reads PartType2)")
    a = ap.parse_args(argv)

    import numpy as np
    import h5py

    with h5py.File(a.hdf5, "r") as f:
        mtab = np.asarray(f["Header"].attrs.get("MassTable",
                                                np.zeros(6)), np.float64)
        g = f[f"PartType{a.ptype}"]
        coords = np.asarray(g["Coordinates"][...], np.float32)
        if "Acceleration" not in g:
            raise SystemExit(f"PartType{a.ptype} has no Acceleration "
                             "dataset (write one or run with a snapshot "
                             "that stores forces)")
        acc = np.asarray(g["Acceleration"][...], np.float32)
        if "Masses" in g:
            mass = np.asarray(g["Masses"][...], np.float32)
        else:
            mass = np.full(len(coords), mtab[a.ptype], np.float32)
    print("Mass table:", " ".join(f"{v:g}" for v in mtab))
    n = len(coords)
    rec = np.zeros(n, dtype=[("mass", "f4"), ("pos", "f4", (3,)),
                             ("acc", "f4", (3,))])
    rec["mass"], rec["pos"], rec["acc"] = mass, coords, acc
    with open(a.output, "wb") as out:
        out.write(np.int32(n).tobytes())
        out.write(rec.tobytes())
    print(f"hdf52accel: wrote {n} records to {a.output}")
    return 0
