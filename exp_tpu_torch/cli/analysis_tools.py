"""Analysis CLI backends: diskprof, haloprof, mssaprof, viewcoefs,
h5compare, slcheck, orthochk, cylcache, eofinfo (the reference's
utils/Analysis, utils/SL, utils/MSSA and expui CLI helpers; port of
exp_tpu/cli/analysis_tools.py, the same flags, printed lines, output files
and exit codes).

A tool that builds a basis (sphprof, diskprof --coef, orthochk's pyEXP
branch, scalarprod, makecoefs) builds it on the parsed `device`: the CUDA
card, or the CPU under --cpu; its projections and fields launch the
kernels under a `backend: pallas` stanza.  The others are host NumPy.
Coefficient files, EOF caches and covariance files are HDF5: the tools
that read or write them need h5py and raise ImportError without it."""

from __future__ import annotations

import numpy as np

from exp_tpu_torch.cli._common import make_parser, load_model, load_snapshot


def haloprof(argv=None):
    """haloprof — radial profiles (density, vc, dispersion) of a snapshot."""
    ap = make_parser("haloprof", haloprof.__doc__)
    ap.add_argument("file")
    ap.add_argument("--type", default="ascii")
    ap.add_argument("--comp", default=None)
    ap.add_argument("--nbins", type=int, default=40)
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    s = load_snapshot(a.file, a.type)
    x, v, m = s.GetParticles(a.comp)
    r = np.linalg.norm(x, axis=1)
    edges = np.geomspace(max(r.min(), 1e-6), r.max(), a.nbins + 1)
    idx = np.clip(np.digitize(r, edges) - 1, 0, a.nbins - 1)
    rows = []
    for b in range(a.nbins):
        sel = idx == b
        if not sel.any():
            continue
        rc = np.sqrt(edges[b] * edges[b + 1])
        vol = 4 * np.pi / 3 * (edges[b + 1] ** 3 - edges[b] ** 3)
        Mb = m[sel].sum()
        vr = np.sum(x[sel] * v[sel], axis=1) / np.maximum(r[sel], 1e-12)
        vbar = np.average(vr, weights=m[sel])     # mass-weighted mean
        rows.append((rc, Mb / vol, np.sqrt(np.average(
            (vr - vbar) ** 2, weights=m[sel])), m[(r <= rc)].sum()))
    out = a.output or a.file + ".haloprof"
    with open(out, "w") as f:
        f.write("# r rho sigma_r M(<r)\n")
        for row in rows:
            f.write(" ".join(f"{v:.8g}" for v in row) + "\n")
    print(f"wrote {out} ({len(rows)} bins)")


def diskprof(argv=None):
    """diskprof — cylindrical disk profiles (Sigma, vc, sigma_z, z_rms)
    from particles; with --coef as the first argument, coefficient-based
    field profiles instead (see diskprof_coef)."""
    if argv is None:
        import sys

        argv = sys.argv[1:]
    if argv and argv[0] == "--coef":
        return diskprof_coef(argv[1:])
    ap = make_parser("diskprof", diskprof.__doc__)
    ap.add_argument("file")
    ap.add_argument("--type", default="ascii")
    ap.add_argument("--comp", default=None)
    ap.add_argument("--nbins", type=int, default=40)
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    s = load_snapshot(a.file, a.type)
    x, v, m = s.GetParticles(a.comp)
    R = np.hypot(x[:, 0], x[:, 1])
    phi = np.arctan2(x[:, 1], x[:, 0])
    vphi = -v[:, 0] * np.sin(phi) + v[:, 1] * np.cos(phi)
    edges = np.geomspace(max(R.min(), 1e-6), R.max(), a.nbins + 1)
    idx = np.clip(np.digitize(R, edges) - 1, 0, a.nbins - 1)
    out = a.output or a.file + ".diskprof"
    with open(out, "w") as f:
        f.write("# R Sigma vphi sigma_z z_rms\n")
        for b in range(a.nbins):
            sel = idx == b
            if not sel.any():
                continue
            rc = np.sqrt(edges[b] * edges[b + 1])
            area = np.pi * (edges[b + 1] ** 2 - edges[b] ** 2)
            sz = np.sqrt(np.average(v[sel, 2] ** 2, weights=m[sel]))
            zr = np.sqrt(np.average(x[sel, 2] ** 2, weights=m[sel]))
            f.write(f"{rc:.8g} {m[sel].sum()/area:.8g} "
                    f"{np.average(vphi[sel], weights=m[sel]):.8g} "
                    f"{sz:.8g} {zr:.8g}\n")
    print(f"wrote {out}")


def _basis_from_config_or_model(a, geometry, meta):
    """Build an analysis Basis either from a YAML stanza file (--config,
    the reference's usual route) or, for spheres, from a builtin/table
    model with the coefficient file's own lmax/nmax."""
    import yaml
    from exp_tpu_torch.analysis.basis import Basis

    if a.config:
        with open(a.config) as fh:
            conf = yaml.safe_load(fh)
        # accept either a bare force stanza or a Components-file entry
        if "id" not in conf and "force" in conf:
            conf = conf["force"]
        return Basis.factory(conf, device=a.device)
    if geometry != "sphere":
        raise SystemExit("--config is required for non-sphere coefficient "
                         "files (the EOF cache cannot be inferred)")
    params = {"modelname": a.model,
              "Lmax": int(meta.get("lmax", 4)),
              "nmax": int(meta.get("nmax", 10)),
              "scale": float(meta.get("scale", 1.0))}
    if getattr(a, "basis_rmin", None) is not None:
        params["rmin"] = a.basis_rmin
    if getattr(a, "basis_rmax", None) is not None:
        params["rmax"] = a.basis_rmax
    return Basis.factory({"id": "sphereSL", "parameters": params},
                         device=a.device)


def _fib_sphere(n):
    """n quasi-uniform unit vectors (Fibonacci lattice)."""
    i = np.arange(n) + 0.5
    z = 1.0 - 2.0 * i / n
    phi = np.pi * (1 + 5 ** 0.5) * i
    s = np.sqrt(1 - z * z)
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=1)


def sphprof(argv=None):
    """sphprof — radial profiles of the BFE fields (density, potential,
    radial force) reconstructed from a spherical coefficient file, with
    optional harmonic truncation (utils/Analysis/sphprof.cc and
    haloprof_coef.cc; haloprof here is the particle-histogram variant)."""
    ap = make_parser("sphprof", sphprof.__doc__)
    ap.add_argument("coeffile")
    ap.add_argument("--config", default=None,
                    help="YAML force stanza ({id, parameters}) for the "
                         "basis; default builds sphereSL over --model with "
                         "the file's lmax/nmax")
    ap.add_argument("--model", default="hernquist",
                    help="conditioning model (builtin or table file)")
    ap.add_argument("--basis-rmin", type=float, default=None)
    ap.add_argument("--basis-rmax", type=float, default=None)
    ap.add_argument("--rmin", type=float, default=1e-3)
    ap.add_argument("--rmax", type=float, default=2.0)
    ap.add_argument("--nbins", type=int, default=60)
    ap.add_argument("--time", type=float, default=None,
                    help="snapshot time (nearest; default: last)")
    ap.add_argument("--all-times", action="store_true",
                    help="one profile block per stored time")
    ap.add_argument("--lcut", type=int, default=None,
                    help="drop harmonics with l > lcut")
    ap.add_argument("--m0", action="store_true",
                    help="keep only the axisymmetric m = 0 channels")
    ap.add_argument("--theta", type=float, default=90.0,
                    help="colatitude of the profile ray [deg]")
    ap.add_argument("--phi", type=float, default=0.0,
                    help="azimuth of the profile ray [deg]")
    ap.add_argument("--avg", type=int, default=0, metavar="NANG",
                    help="average over NANG quasi-uniform sphere "
                         "directions instead of a single ray")
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    from exp_tpu_torch.analysis.coefs import Coefs

    c = Coefs.from_file(a.coeffile)
    if c.geometry != "sphere":
        raise SystemExit(f"{a.coeffile}: geometry {c.geometry!r}, "
                         "expected 'sphere'")
    basis = _basis_from_config_or_model(a, "sphere", c.meta)

    ts = c.times()
    sel_times = ts if a.all_times else \
        [ts[-1] if a.time is None else
         ts[int(np.argmin(np.abs(np.asarray(ts) - a.time)))]]

    r = np.geomspace(a.rmin, a.rmax, a.nbins)
    if a.avg:
        dirs = _fib_sphere(a.avg)
    else:
        th, ph = np.radians(a.theta), np.radians(a.phi)
        dirs = np.array([[np.sin(th) * np.cos(ph),
                          np.sin(th) * np.sin(ph), np.cos(th)]])
    pts = (r[:, None, None] * dirs[None, :, :]).reshape(-1, 3)

    out = a.output or a.coeffile + ".sphprof"
    with open(out, "w") as f:
        f.write("# r dens pot F_r\n")
        for t in sel_times:
            coef = np.array(c.getCoefStruct(t))
            if a.lcut is not None:
                coef[:, a.lcut + 1:] = 0.0
            if a.m0:
                coef[:, :, 1:] = 0.0
                coef[1] = 0.0
            dens, pot, acc = basis.get_fields(coef, pts)
            rhat = np.repeat(dirs[None], len(r), 0).reshape(-1, 3)
            fr = np.sum(np.asarray(acc) * rhat, axis=1)
            nd = dirs.shape[0]
            dens = np.asarray(dens).reshape(len(r), nd).mean(1)
            pot = np.asarray(pot).reshape(len(r), nd).mean(1)
            fr = fr.reshape(len(r), nd).mean(1)
            f.write(f"# time = {t:.8g}\n")
            for k in range(len(r)):
                f.write(f"{r[k]:.8g} {dens[k]:.8g} {pot[k]:.8g} "
                        f"{fr[k]:.8g}\n")
    print(f"wrote {out} ({len(sel_times)} time(s), {len(r)} radii)")


def diskprof_coef(argv=None):
    """diskprof --coef backend: midplane disk-field profiles (density,
    potential, v_c) reconstructed from a cylinder coefficient file +
    basis config (utils/Analysis/diskprof_coef.cc)."""
    ap = make_parser("diskprof --coef", diskprof_coef.__doc__)
    ap.add_argument("coeffile")
    ap.add_argument("--config", required=True,
                    help="YAML force stanza for the cylinder basis "
                         "(must point at the EOF cache)")
    ap.add_argument("--rmin", type=float, default=1e-3)
    ap.add_argument("--rmax", type=float, default=1.0)
    ap.add_argument("--nbins", type=int, default=60)
    ap.add_argument("--time", type=float, default=None)
    ap.add_argument("--mcut", type=int, default=None,
                    help="drop azimuthal orders m > mcut")
    ap.add_argument("--nphi", type=int, default=8,
                    help="azimuths averaged per radius")
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    from exp_tpu_torch.analysis.coefs import Coefs

    c = Coefs.from_file(a.coeffile)
    if c.geometry != "cylinder":
        raise SystemExit(f"{a.coeffile}: geometry {c.geometry!r}, "
                         "expected 'cylinder'")
    basis = _basis_from_config_or_model(a, "cylinder", c.meta)

    ts = c.times()
    t = ts[-1] if a.time is None else \
        ts[int(np.argmin(np.abs(np.asarray(ts) - a.time)))]
    coef = np.array(c.getCoefStruct(t))
    if a.mcut is not None:
        coef[:, a.mcut + 1:] = 0.0

    R = np.geomspace(a.rmin, a.rmax, a.nbins)
    phis = np.linspace(0, 2 * np.pi, a.nphi, endpoint=False)
    pts = np.stack([np.outer(R, np.cos(phis)).ravel(),
                    np.outer(R, np.sin(phis)).ravel(),
                    np.zeros(len(R) * a.nphi)], axis=1)
    dens, pot, acc = basis.get_fields(coef, pts)
    rhat = pts.copy()
    rhat[:, 2] = 0.0
    rhat /= np.maximum(np.linalg.norm(rhat, axis=1, keepdims=True), 1e-30)
    fr = np.sum(np.asarray(acc) * rhat, axis=1).reshape(len(R), a.nphi)
    dens = np.asarray(dens).reshape(len(R), a.nphi).mean(1)
    pot = np.asarray(pot).reshape(len(R), a.nphi).mean(1)
    vc = np.sqrt(np.maximum(-R * fr.mean(1), 0.0))

    out = a.output or a.coeffile + ".diskprof"
    with open(out, "w") as f:
        f.write(f"# time = {t:.8g}\n# R dens_mid pot_mid vc\n")
        for k in range(len(R)):
            f.write(f"{R[k]:.8g} {dens[k]:.8g} {pot[k]:.8g} "
                    f"{vc[k]:.8g}\n")
    print(f"wrote {out}")


def viewcoefs(argv=None):
    """viewcoefs — list times and per-harmonic power of a coefficient file
    (expui/viewcoefs + h5power)."""
    ap = make_parser("viewcoefs", viewcoefs.__doc__)
    ap.add_argument("file")
    a = ap.parse_args(argv)
    from exp_tpu_torch.analysis.coefs import Coefs

    c = Coefs.from_file(a.file)
    ts = c.times()
    print(f"geometry={c.geometry} name={c.name!r} snaps={len(ts)} "
          f"t=[{ts[0]:.6g}, {ts[-1]:.6g}]")
    P = c.power()
    if P.ndim == 2:
        print("power per l (first/last):")
        print("  t0 :", np.array2string(P[0], precision=4))
        print("  t-1:", np.array2string(P[-1], precision=4))
    else:
        print(f"total power: t0={P[0]:.6g} t-1={P[-1]:.6g}")


def h5compare(argv=None):
    """h5compare — coefficient-file regression comparator (expui/h5compare):
    exit 0 if all coefficients agree within tolerance."""
    ap = make_parser("h5compare", h5compare.__doc__)
    ap.add_argument("file1")
    ap.add_argument("file2")
    ap.add_argument("--tol", type=float, default=1e-8)
    a = ap.parse_args(argv)
    from exp_tpu_torch.analysis.coefs import Coefs

    c1 = Coefs.from_file(a.file1)
    c2 = Coefs.from_file(a.file2)
    if c1.geometry != c2.geometry:
        print(f"geometry mismatch: {c1.geometry} != {c2.geometry}")
        return 1
    t1, t2 = c1.times(), c2.times()
    if len(t1) != len(t2):
        print(f"snapshot count mismatch: {len(t1)} != {len(t2)}")
        return 1
    A1, A2 = c1.as_array(), c2.as_array()
    if A1.shape != A2.shape:
        print(f"coefficient shape mismatch: {A1.shape} != {A2.shape}")
        return 1
    scale = np.abs(A1).max() + 1e-300
    err = np.abs(A1 - A2).max() / scale
    print(f"max relative coefficient difference: {err:.3e} (tol {a.tol:g})")
    return 0 if err <= a.tol else 1


def mssaprof(argv=None):
    """mssaprof — MSSA of a coefficient file: contributions + PC table
    (utils/MSSA expmssa / expui expMSSA pipeline)."""
    ap = make_parser("mssaprof", mssaprof.__doc__)
    ap.add_argument("file")
    ap.add_argument("--window", type=int, default=0,
                    help="embedding window (default T/2)")
    ap.add_argument("--numpc", type=int, default=8)
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    from exp_tpu_torch.analysis.coefs import Coefs
    from exp_tpu_torch.analysis.mssa import expMSSA

    c = Coefs.from_file(a.file)
    T = len(c.times())
    w = a.window or max(2, T // 2)
    m = expMSSA({"c": c}, window=w, numpc=a.numpc)
    contrib = m.contributions()
    print("MSSA contributions:", np.array2string(contrib, precision=4))
    out = a.output or a.file + ".mssa"
    np.savetxt(out, m.pcs(), header="principal components (K x numpc)")
    print(f"wrote {out}")


def slcheck(argv=None):
    """slcheck — build an SL basis and dump/inspect its functions
    (utils/SL/slcheck)."""
    ap = make_parser("slcheck", slcheck.__doc__)
    ap.add_argument("-i", "--model", default="hernquist")
    ap.add_argument("--lmax", type=int, default=2)
    ap.add_argument("--nmax", type=int, default=8)
    ap.add_argument("--numr", type=int, default=1000)
    ap.add_argument("--rmap", type=float, default=1.0)
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables

    model = load_model(a.model)
    t = build_sph_sl_tables(model, lmax=a.lmax, nmax=a.nmax, numr=a.numr,
                            cmap=1, rmap=a.rmap)
    print("eigenvalues (per l):")
    for l in range(a.lmax + 1):
        print(f"  l={l}:", np.array2string(t.ev[l], precision=4))
    if a.output:
        cols = [t.r] + [t.pot_table[:, l, n] for l in range(a.lmax + 1)
                        for n in range(a.nmax)]
        np.savetxt(a.output, np.stack(cols, axis=1),
                   header="r then pot_ln columns (l-major)")
        print(f"wrote {a.output}")


def orthochk(argv=None):
    """orthochk — biorthogonality check of a built basis
    (utils/SL/orthochk + slabchk; the in-code orthoTest).  With
    --geometry slab/cube/cylinder the check runs through the pyEXP
    orthoCheck path (cylinder needs --config pointing at the EOF
    cache)."""
    ap = make_parser("orthochk", orthochk.__doc__)
    ap.add_argument("-i", "--model", default="hernquist")
    ap.add_argument("--geometry", default="sphere",
                    choices=["sphere", "slab", "cube", "cylinder",
                             "flatdisk"])
    ap.add_argument("--config", default=None,
                    help="YAML force stanza (required for cylinder)")
    ap.add_argument("--lmax", type=int, default=2)
    ap.add_argument("--nmax", type=int, default=8)
    ap.add_argument("--numr", type=int, default=1000)
    ap.add_argument("--rmap", type=float, default=1.0)
    ap.add_argument("--tol", type=float, default=1e-3)
    a = ap.parse_args(argv)
    if a.geometry != "sphere":
        return _orthochk_pyexp(a)
    from exp_tpu_torch.basis.slgrid import (build_sph_sl_tables,
                                      biorthogonality_matrix)

    model = load_model(a.model)
    t = build_sph_sl_tables(model, lmax=a.lmax, nmax=a.nmax, numr=a.numr,
                            cmap=1, rmap=a.rmap)
    worst = 0.0
    for l in range(a.lmax + 1):
        B = biorthogonality_matrix(t, l)
        err = np.abs(B + np.eye(a.nmax)).max()
        worst = max(worst, err)
        print(f"l={l}: max|B+I| = {err:.3e}")
    print("PASS" if worst <= a.tol else "FAIL")
    return 0 if worst <= a.tol else 1


def _orthochk_flatdisk(a):
    """Razor-thin 2D EOF biorthogonality (utils/SL/EOF2d.cc --ortho):
    the density partner is a SURFACE density delta-layer, so the check
    is the midplane energy integral -int Phi_j [4 pi sigma_k] R dR
    x 2 pi (with the sqrt2 m>0 azimuthal convention giving 2 delta),
    not the 3D volume Gram the other geometries use."""
    from exp_tpu_torch.basis.flatdisk import build_flatdisk_tables

    model = str(a.model) if str(a.model) in ("kuzmin", "expon", "mestel",
                                             "zang") else "expon"
    # odd numy puts an exact z=0 row on the grid (with the default even
    # count the nearest row sits at |z|>0 and the e^{-k|z|} decay of the
    # high-k Hankel modes biases the energy integral by ~5%)
    t = build_flatdisk_tables(mmax=2, nmax=a.nmax, model=model, numy=129)
    iy0 = t.numy // 2                       # midplane row (z = 0)
    Rg = np.asarray(t.R_of_x(np.linspace(t.xmin, t.xmax, t.numx)))
    w = np.gradient(Rg)
    worst = 0.0
    for m in range(t.mmax + 1):
        P = t.pot[:, iy0, m, :]             # (numx, nmax)
        D = t.dens[:, iy0, m, :]            # stores 4 pi sigma
        G = -2.0 * np.pi * np.einsum("xj,xk,x->jk", P, D, Rg * w)
        target = (2.0 if m else 1.0) * np.eye(a.nmax)
        err = np.abs(G - target).max()
        worst = max(worst, err)
        print(f"m={m}: max|G-{'2' if m else ''}I| = {err:.3e}")
    print("PASS" if worst <= a.tol else "FAIL")
    return 0 if worst <= a.tol else 1


def _orthochk_pyexp(a):
    """Non-sphere orthochk backend over pyexp Basis.orthoCheck.  The
    Gram matrices are ~ -I for the cylinder potential/density pair and
    ~ +I for slab/cube (BiorthBasis.cc:4411 conventions)."""
    import yaml
    from exp_tpu_torch.pyexp.basis import Basis as PBasis

    if a.config:
        with open(a.config) as fh:
            conf = yaml.safe_load(fh)
    elif a.geometry == "slab":
        conf = {"id": "slabSL", "parameters":
                {"nmaxx": 2, "nmaxy": 2, "nmax": a.nmax, "numz": 201}}
    elif a.geometry == "cube":
        conf = {"id": "cube", "parameters":
                {"nmaxx": 2, "nmaxy": 2, "nmaxz": 2}}
    elif a.geometry == "flatdisk":
        return _orthochk_flatdisk(a)
    else:
        raise SystemExit("--config (with the EOF cache) is required for "
                         "--geometry cylinder")
    b = PBasis.factory(conf, device=a.device)
    sign = -1.0 if a.geometry in ("cylinder", "flatdisk") else 1.0
    worst = 0.0
    for k, G in enumerate(b.orthoCheck()):
        G = np.abs(np.asarray(G)) if a.geometry == "cube" else \
            sign * np.asarray(G)
        err = np.abs(G - np.eye(G.shape[0])).max()
        worst = max(worst, err)
        print(f"block {k}: max|G-I| = {err:.3e}")
    print("PASS" if worst <= a.tol else "FAIL")
    return 0 if worst <= a.tol else 1


def scalarprod(argv=None):
    """scalarprod — project a snapshot onto a basis and print the
    per-channel inner products (utils/Analysis/scalarprod.cc: the
    coefficient table straight from particles, no file round-trip)."""
    ap = make_parser("scalarprod", scalarprod.__doc__)
    ap.add_argument("file")
    ap.add_argument("--config", required=True,
                    help="YAML force stanza ({id, parameters})")
    ap.add_argument("--type", default=None)
    ap.add_argument("--comp", default=None)
    ap.add_argument("--center", action="store_true",
                    help="subtract the mass-weighted center first")
    a = ap.parse_args(argv)
    import yaml
    from exp_tpu_torch.analysis.basis import Basis

    with open(a.config) as fh:
        basis = Basis.factory(yaml.safe_load(fh), device=a.device)
    s = load_snapshot(a.file, a.type)
    x, v, m = s.GetParticles(a.comp)
    center = np.average(x, axis=0, weights=m) if a.center else None
    coef = basis.create_coefficients(x, m, center=center)
    geom = basis.geometry
    print(f"geometry={geom} N={len(m)} M={m.sum():.6g}")
    c = np.asarray(coef)
    if geom == "sphere":
        print("  l  m        n: amplitude (cos, sin)")
        for l in range(c.shape[1]):
            for mm in range(l + 1):
                amps = np.hypot(c[0, l, mm], c[1, l, mm])
                row = " ".join(f"{v:.4e}" for v in amps)
                print(f"  {l}  {mm}  [{row}]")
    elif geom == "cylinder":
        print("  m        n: |amplitude|")
        for mm in range(c.shape[1]):
            amps = np.hypot(c[0, mm], c[1, mm])
            row = " ".join(f"{v:.4e}" for v in amps)
            print(f"  {mm}  [{row}]")
    else:
        print(f"total power: {float(np.sum(np.abs(c) ** 2)):.6e}")
    return 0


def cylcache(argv=None):
    """cylcache — build (and cache) an EOF cylinder basis
    (utils/ICs cylcache / eof_basis)."""
    ap = make_parser("cylcache", cylcache.__doc__)
    ap.add_argument("-o", "--cachename", default="eof.cache.h5")
    ap.add_argument("--mmax", type=int, default=6)
    ap.add_argument("--nmax", type=int, default=18)
    ap.add_argument("--lmaxfid", type=int, default=48)
    ap.add_argument("--nmaxfid", type=int, default=32)
    ap.add_argument("--acyl", type=float, default=0.01)
    ap.add_argument("--hcyl", type=float, default=0.002)
    ap.add_argument("--ncylnx", type=int, default=256)
    ap.add_argument("--ncylny", type=int, default=128)
    a = ap.parse_args(argv)
    from exp_tpu_torch.basis.empcyl import build_empcyl_tables

    t = build_empcyl_tables(mmax=a.mmax, nmax=a.nmax, lmaxfid=a.lmaxfid,
                            nmaxfid=a.nmaxfid, acyl=a.acyl, hcyl=a.hcyl,
                            numx=a.ncylnx, numy=a.ncylny,
                            cachename=a.cachename, verbose=True)
    print(f"wrote {a.cachename} (mmax={t.mmax} nmax={t.nmax} "
          f"grid {t.numx}x{t.numy})")


def eofinfo(argv=None):
    """eofinfo — inspect an EOF cache file (utils/ICs empinfo); --dump
    writes the midplane basis functions U^m_n(R, z=0) to an ascii table
    (utils/ICs empdump/eofpeek); --compare reports per-m max |diff| /
    max |value| against a second cache (utils/ICs/eof_compare.cc +
    EmpCylSL::compare_basis, EmpCylSL.cc:6931-7030)."""
    ap = make_parser("eofinfo", eofinfo.__doc__)
    ap.add_argument("file")
    ap.add_argument("--dump", action="store_true",
                    help="write <file>.midplane with R, U^m_n(R, 0)")
    ap.add_argument("--m", type=int, default=None,
                    help="dump only this azimuthal order")
    ap.add_argument("--compare", default=None, metavar="OTHER",
                    help="second EOF cache to compare table-by-table")
    a = ap.parse_args(argv)
    from exp_tpu_torch.basis.empcyl import EmpCylTables
    t = EmpCylTables.read_cache(a.file)
    print(f"EOF cache: mmax={t.mmax} nmax={t.nmax} grid={t.numx}x{t.numy} "
          f"acyl={t.acyl} hcyl={t.hcyl} rcylmax={t.rcylmax}")
    print(f"even counts per m: {t.even_count.tolist()}")
    if a.compare:
        o = EmpCylTables.read_cache(a.compare)
        if (t.mmax, t.nmax, t.numx, t.numy) != (o.mmax, o.nmax,
                                                o.numx, o.numy):
            raise SystemExit(
                f"incompatible caches: {t.mmax},{t.nmax},{t.numx},{t.numy}"
                f" vs {o.mmax},{o.nmax},{o.numx},{o.numy}")
        print(f"{'table':8s} {'m':>3s} {'max|dif|':>12s} {'max|val|':>12s}"
              f" {'rel':>10s}")
        worst = 0.0
        for lab in ("pot", "rforce", "zforce", "dens"):
            A, B = getattr(t, lab), getattr(o, lab)
            for mm in range(t.mmax + 1):
                dif = float(np.abs(A[:, :, mm] - B[:, :, mm]).max())
                mx = float(np.abs(A[:, :, mm]).max())
                rel = dif / mx if mx > 0 else 0.0
                worst = max(worst, rel)
                print(f"{lab:8s} {mm:3d} {dif:12.4e} {mx:12.4e} "
                      f"{rel:10.3e}")
        print(f"worst relative difference: {worst:.3e}")
        return 0
    if a.dump:
        xg = t.xmin + t.dx * np.arange(t.numx)
        Rg = np.asarray(t.R_of_x(xg))
        # z = 0 row: y = asinh(z/h) = 0
        j0 = int(round((0.0 - t.ymin) / t.dy))
        mids = range(t.mmax + 1) if a.m is None else [a.m]
        out = a.file + ".midplane"
        with open(out, "w") as f:
            cols = " ".join(f"U_{mm}_{n}" for mm in mids
                            for n in range(t.nmax))
            f.write(f"# R {cols}\n")
            for i in range(t.numx):
                vals = " ".join(f"{t.pot[i, j0, mm, n]:.8g}"
                                for mm in mids for n in range(t.nmax))
                f.write(f"{Rg[i]:.8g} {vals}\n")
        print(f"wrote {out}")


def slabprof(argv=None):
    """slabprof — vertical slab profiles: rho(z), sigma_z(z), vz_mean(z)
    (utils/Analysis/slabprof.cc)."""
    ap = make_parser("slabprof", slabprof.__doc__)
    ap.add_argument("file")
    ap.add_argument("--type", default="ascii")
    ap.add_argument("--comp", default=None)
    ap.add_argument("--nbins", type=int, default=40)
    ap.add_argument("--L", type=float, default=1.0,
                    help="horizontal box side (for the density unit)")
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    s = load_snapshot(a.file, a.type)
    x, v, m = s.GetParticles(a.comp)
    z = x[:, 2]
    edges = np.linspace(z.min(), z.max(), a.nbins + 1)
    idx = np.clip(np.digitize(z, edges) - 1, 0, a.nbins - 1)
    dz = edges[1] - edges[0]
    out = a.output or a.file + ".slabprof"
    with open(out, "w") as f:
        f.write("# z rho sigma_z vz_mean N\n")
        for b in range(a.nbins):
            sel = idx == b
            if not sel.any():
                continue
            zc = 0.5 * (edges[b] + edges[b + 1])
            rho = m[sel].sum() / (a.L * a.L * dz)
            vzm = np.average(v[sel, 2], weights=m[sel])
            sz = np.sqrt(np.average((v[sel, 2] - vzm) ** 2,
                                    weights=m[sel]))
            f.write(f"{zc:.8g} {rho:.8g} {sz:.8g} {vzm:.8g} "
                    f"{int(sel.sum())}\n")
    print(f"wrote {out}")


def makecoefs(argv=None):
    """makecoefs — project snapshot(s) onto a basis and write an HDF5
    coefficient file (expui/makecoefs.cc; the CLI face of
    Basis.create_from_snapshots)."""
    ap = make_parser("makecoefs", makecoefs.__doc__)
    ap.add_argument("files", nargs="+", help="snapshot file(s), in order")
    ap.add_argument("--config", required=True,
                    help="YAML force stanza ({id, parameters})")
    ap.add_argument("--type", default=None)
    ap.add_argument("--comp", default=None)
    ap.add_argument("--center", action="store_true",
                    help="subtract each snapshot's mass-weighted center")
    ap.add_argument("--name", default="comp")
    ap.add_argument("-o", "--output", default="coefs.h5")
    a = ap.parse_args(argv)
    import yaml
    from exp_tpu_torch.analysis.basis import Basis

    with open(a.config) as fh:
        basis = Basis.factory(yaml.safe_load(fh), device=a.device)
    basis.name = a.name
    snaps, times, centers = [], [], []
    for f in a.files:
        s = load_snapshot(f, a.type)
        x, v, m = s.GetParticles(a.comp)
        snaps.append((x, m))
        times.append(float(getattr(s, "time", len(times))))
        centers.append(np.average(x, axis=0, weights=m)
                       if a.center else None)
    c = basis.create_from_snapshots(
        snaps, times=times,
        centers=centers if a.center else None)
    c.to_file(a.output)
    print(f"makecoefs: wrote {len(times)} snapshot(s) to {a.output}")
    return 0


def coefstoh5(argv=None):
    """coefstoh5 — convert a native (pre-HDF5 binary) EXP coefficient
    file to the HDF5 schema (expui/coefstoh5.cc over
    io.coefs.read_native_coefs)."""
    ap = make_parser("coefstoh5", coefstoh5.__doc__)
    ap.add_argument("file", help="native coefficient file")
    ap.add_argument("--geometry", default=None,
                    choices=[None, "sphere", "cylinder"],
                    help="force the geometry (default: sniffed)")
    ap.add_argument("-o", "--output", default=None)
    a = ap.parse_args(argv)
    from exp_tpu_torch.analysis.coefs import Coefs
    from exp_tpu_torch.io.coefs import read_native_coefs

    # read_native_coefs returns (geometry, times, arrays, meta): exp_tpu's
    # tool calls to_file on that tuple and fails; the port builds the
    # container, as Coefs.from_file does for a native file
    geom, times, arrs, meta = read_native_coefs(a.file, geometry=a.geometry)
    c = Coefs(geometry=geom, name=str(meta.get("forceID", "")), meta=meta)
    for t, arr in zip(times, arrs):
        c.add(float(t), arr)
    out = a.output or a.file + ".h5"
    c.to_file(out)
    print(f"coefstoh5: wrote {len(c.times())} time(s) "
          f"({c.geometry}) to {out}")
    return 0


def h5power(argv=None):
    """h5power — full time x harmonic power table of a coefficient file
    (expui/h5power.cc; viewcoefs prints only the first/last rows)."""
    ap = make_parser("h5power", h5power.__doc__)
    ap.add_argument("file")
    ap.add_argument("-o", "--output", default=None,
                    help="output table (default: stdout)")
    a = ap.parse_args(argv)
    import sys

    from exp_tpu_torch.analysis.coefs import Coefs

    c = Coefs.from_file(a.file)
    ts = np.asarray(c.times())
    P = np.atleast_2d(np.asarray(c.power()))
    if P.shape[0] != len(ts):
        P = P.T
    out = open(a.output, "w") if a.output else sys.stdout
    ncol = P.shape[1]
    out.write("# time " + " ".join(f"P[{j}]" for j in range(ncol)) + "\n")
    for t, row in zip(ts, P):
        out.write(f"{t:.10g} " + " ".join(f"{v:.8g}" for v in row) + "\n")
    if a.output:
        out.close()
        print(f"h5power: wrote {len(ts)} x {ncol} table to {a.output}")
    return 0
