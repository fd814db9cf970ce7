"""psporbv — per-particle orbital parameters against a spherical background
model (utils/PhaseSpace/psporbv.cc): for every particle in the radial and
kappa window, compute

  radius, energy, kappa = J/J_circ(E), actions (I_r, I_p), L components,
  frequencies (Omega_1, Omega_2), r/r_apo, r/r_peri, the radial angle w1,
  v_rad/v_tan, phi, theta, v_rad, v_tan, index

and write an `orbv.<suffix>` ascii table with the reference's column set
(psporbv.cc:168-200 labels).  Orbit quantities come from
exp_tpu_torch.analysis.orbit.SphericalOrbit; an (E, kappa) grid + bilinear
interpolation replaces the reference's per-particle orbit construction so
million-particle snapshots stay tractable (w1 is still exact per particle:
it only needs the interpolated peri/apo and a radial quadrature).

Port of exp_tpu/cli/psporbv.py: the same flags, lines and files."""

import sys

import numpy as np

from exp_tpu_torch.cli._common import make_parser, load_model, load_snapshot


def _orbit_grid(model, Emin, Emax, kmin, kmax, nE, nK):
    """Tabulate (Jr, Omega_r, Omega_phi, peri, apo) on an (E, kappa) grid.

    Returns (Egrid, Kgrid, dict name -> (nE, nK) array).  Grid nodes where
    the orbit solver fails (hyperbolic edge cases) are masked to NaN and
    excluded by the interpolation below."""
    from exp_tpu_torch.analysis.orbit import SphericalOrbit

    Eg = np.linspace(Emin, Emax, nE)
    Kg = np.linspace(kmin, kmax, nK)
    out = {k: np.full((nE, nK), np.nan)
           for k in ("Jr", "Jmax", "om1", "om2", "peri", "apo")}
    for i, E in enumerate(Eg):
        try:
            jm = SphericalOrbit(model, E, kappa=0.5).jcirc(E)
        except Exception:
            continue
        for j, kap in enumerate(Kg):
            try:
                orb = SphericalOrbit(model, E, kappa=kap)
            except Exception:
                continue
            out["Jr"][i, j] = orb.Jr
            out["Jmax"][i, j] = jm
            out["om1"][i, j] = orb.omega_r
            out["om2"][i, j] = orb.omega_phi
            out["peri"][i, j] = orb.peri
            out["apo"][i, j] = orb.apo
    return Eg, Kg, out


def _bilinear(Eg, Kg, tab, E, kap):
    """Vectorized bilinear interpolation on the orbit grid."""
    iE = np.clip(np.searchsorted(Eg, E) - 1, 0, len(Eg) - 2)
    iK = np.clip(np.searchsorted(Kg, kap) - 1, 0, len(Kg) - 2)
    fE = np.clip((E - Eg[iE]) / (Eg[iE + 1] - Eg[iE]), 0.0, 1.0)
    fK = np.clip((kap - Kg[iK]) / (Kg[iK + 1] - Kg[iK]), 0.0, 1.0)
    return ((1 - fE) * (1 - fK) * tab[iE, iK]
            + fE * (1 - fK) * tab[iE + 1, iK]
            + (1 - fE) * fK * tab[iE, iK + 1]
            + fE * fK * tab[iE + 1, iK + 1])


def _w1_of(model, E, J, om1, peri, apo, r, vr, nquad=32):
    """Radial angle w1 in [0, 2 pi): Omega_r * int_peri^r dr'/v_r with the
    peri-side root absorbed by the r = b + a sin(t) substitution
    (orbit.cc get_w1; vectorized over particles)."""
    a = 0.5 * np.maximum(apo - peri, 1e-30)
    b = 0.5 * (apo + peri)
    tr = np.arcsin(np.clip((r - b) / a, -1.0, 1.0))
    xg, wg = np.polynomial.legendre.leggauss(nquad)
    # integrate t from -pi/2 to tr
    mid = 0.5 * (tr - 0.5 * np.pi)[:, None] \
        + 0.5 * (tr + 0.5 * np.pi)[:, None] * xg[None, :]
    half = 0.5 * (tr + 0.5 * np.pi)
    rq = b[:, None] + a[:, None] * np.sin(mid)
    v2 = 2.0 * (E[:, None] - np.asarray(model.get_pot(rq.ravel())
                                        ).reshape(rq.shape)) \
        - (J[:, None] / rq) ** 2
    integ = a[:, None] * np.cos(mid) / np.sqrt(np.maximum(v2, 1e-12))
    # the integral is the TIME from pericenter; Omega_r turns it into the
    # radial angle.  The peri->apo branch spans w1 in [0, pi] exactly;
    # quadrature error against interpolated (peri, apo) can overshoot —
    # clamp to the branch before reflecting.
    w1 = np.clip(om1 * half * (integ @ wg), 0.0, np.pi)
    return np.where(vr < 0, 2.0 * np.pi - w1, w1)


def main(argv=None):
    ap = make_parser("psporbv", __doc__)
    ap.add_argument("-f", "--psp", required=True, help="input snapshot")
    ap.add_argument("--type", default=None, help="snapshot format")
    ap.add_argument("-c", "--name", default=None, help="component name")
    ap.add_argument("-m", "--model", default="hernquist",
                    help="spherical model file or builtin")
    ap.add_argument("-r", "--rmin", type=float, default=0.0)
    ap.add_argument("-R", "--rmax", type=float, default=1.0)
    ap.add_argument("-k", "--maxkap", type=float, default=0.5,
                    help="maximum kappa to select")
    ap.add_argument("-K", "--ktol", type=float, default=0.005)
    ap.add_argument("-s", "--suffix", default="run")
    ap.add_argument("--nE", type=int, default=64)
    ap.add_argument("--nK", type=int, default=32)
    ap.add_argument("-N", "--histo", type=int, default=0,
                    help="radial bins for the w1/kappa histogram")
    a = ap.parse_args(argv)

    model = load_model(a.model)
    snap = load_snapshot(a.psp, a.type)
    x, v, mass = snap.GetParticles(a.name)

    r = np.sqrt(np.sum(x * x, axis=1))
    Lv = np.cross(x, v)
    J = np.sqrt(np.sum(Lv * Lv, axis=1))
    E = 0.5 * np.sum(v * v, axis=1) + np.asarray(model.get_pot(
        np.clip(r, model.rmin, model.rmax)))
    rmin = max(a.rmin, model.rmin)
    rmax = min(a.rmax, model.rmax)
    Emin = float(model.get_pot(model.rmin))
    Emax = float(model.get_pot(model.rmax))

    Eg, Kg, tab = _orbit_grid(model, Emin * 0.999, Emax, a.ktol,
                              1.0 - a.ktol, a.nE, a.nK)
    jmax = _bilinear(Eg, Kg, tab["Jmax"], E, np.full_like(E, 0.5))
    kappa = J / np.maximum(jmax, 1e-30)

    sel = ((r >= rmin) & (r <= rmax) & (E > Emin) & (E < Emax)
           & (kappa > a.ktol) & (kappa < min(1.0 - a.ktol, a.maxkap)))
    idx = np.nonzero(sel)[0]
    if idx.size == 0:
        print("psporbv: no particles pass the selection")
        return 1

    E, J, kappa, r = E[idx], J[idx], kappa[idx], r[idx]
    xs, vs = x[idx], v[idx]
    Jr = _bilinear(Eg, Kg, tab["Jr"], E, kappa)
    om1 = _bilinear(Eg, Kg, tab["om1"], E, kappa)
    om2 = _bilinear(Eg, Kg, tab["om2"], E, kappa)
    peri = _bilinear(Eg, Kg, tab["peri"], E, kappa)
    apo = _bilinear(Eg, Kg, tab["apo"], E, kappa)

    vr = np.sum(xs * vs, axis=1) / np.maximum(r, 1e-30)
    vt = J / np.maximum(r, 1e-30)
    w1 = _w1_of(model, E, J, om1, np.minimum(peri, r),
                np.maximum(apo, r), r, vr)
    phi = np.arctan2(xs[:, 1], xs[:, 0])
    theta = np.arccos(np.clip(xs[:, 2] / np.maximum(r, 1e-30), -1, 1))

    out = f"orbv.{a.suffix}"
    cols = np.column_stack([
        r, E, kappa, Jr, J, Lv[idx, 0], Lv[idx, 1], Lv[idx, 2], om1, om2,
        r / np.maximum(apo, 1e-30), r / np.maximum(peri, 1e-30), w1,
        vr / np.where(np.abs(vt) > 1e-30, vt, 1e-30), phi, theta, vr, vt,
        idx.astype(float)])
    labels = ["radius", "energy", "kappa", "I_r", "I_p", "L_x", "L_y",
              "L_z", "Omega_1", "Omega_2", "r/r_apo", "r/r_peri", "w1",
              "v_rad/v_tan", "phi", "theta", "v_rad", "v_tan", "index"]
    np.savetxt(out, cols, header=" ".join(
        f"[{i+1}]{s}" for i, s in enumerate(labels)))
    print(f"psporbv: wrote {out} ({idx.size} orbits)")

    if a.histo > 0:
        # mass-weighted kappa moments vs radius (psporbv.cc kk_histo)
        m = mass[idx]
        edges = np.linspace(rmin, rmax, a.histo + 1)
        which = np.clip(np.digitize(r, edges) - 1, 0, a.histo - 1)
        w0 = np.bincount(which, weights=m, minlength=a.histo)
        w1h = np.bincount(which, weights=m * kappa, minlength=a.histo)
        w2h = np.bincount(which, weights=m * kappa ** 2, minlength=a.histo)
        mean = w1h / np.maximum(w0, 1e-30)
        var = w2h / np.maximum(w0, 1e-30) - mean ** 2
        hout = f"orbv.{a.suffix}.histo"
        np.savetxt(hout, np.column_stack(
            [0.5 * (edges[:-1] + edges[1:]), w0, mean,
             np.sqrt(np.maximum(var, 0.0))]),
            header="r mass mean_kappa sig_kappa")
        print(f"psporbv: wrote {hout}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
