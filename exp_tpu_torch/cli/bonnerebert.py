"""bonnerebert — isothermal (Bonnor–Ebert) gas sphere: integrate the
isothermal Lane–Emden equation and either print the physical profile or
sample an N-particle realization (utils/ICs/bonnerebert.cc).

Dimensionless system (bonnerebert.cc:90-115):

  psi'  = y,   y' = exp(-psi) - 2 y / x,   m' = 4 pi x^2 exp(-psi)

truncated where the density contrast rho_c/rho(x) reaches `--ratio`, then
scaled to physical units from (temperature T, total mass M in units of
`--munit` Msun, halo radius unit R in kpc) exactly as the reference
(bonnerebert.cc:267-292): the truncation pressure fixes rho_c, lengths in
units of the halo radius, masses in Munit.

With --number 0 the four-column profile (r, rho, M(r), m_dimensionless) is
printed; otherwise N particles are drawn from M(r) with isothermal
Maxwellian velocities (sigma = c_s) and written as a reference ascii body
file ("N 0 4" header + 4 zeroed double attributes, bonnerebert.cc:318-343).

Port of exp_tpu/cli/bonnerebert.py: the same flags, lines and files.
"""

import sys

import numpy as np

from exp_tpu_torch.cli._common import make_parser

# cgs constants (bonnerebert.cc:268-274)
_MP = 1.67262158e-24
_BOLTZ = 1.3810e-16
_F_H = 0.76
_PC = 3.086e18
_MSUN = 1.989e33
_G = 6.67428e-8


def integrate_lane_emden(xmax=1000.0, h=0.01):
    """RK4 march of the isothermal Lane-Emden system; returns the solution
    table with the reference's accum columns (bonnerebert.cc:138-152):
    x, psi, dpsi, m, x^2 dpsi, rho, sqrt(rho/4pi) x^2 dpsi, 1/rho."""

    def deriv(x, y):
        rho = np.exp(-y[0])
        if x > 0.0:
            return np.array([y[1], rho - 2.0 * y[1] / x,
                             4.0 * np.pi * x * x * rho])
        return np.array([0.0, 1.0, 0.0])

    rows = []

    def accum(x, y):
        rho = np.exp(-y[0])
        xxy = x * x * y[1]
        rows.append((x, y[0], y[1], y[2], xxy, rho,
                     np.sqrt(0.25 * rho / np.pi) * xxy, 1.0 / rho))

    x, y = 0.0, np.zeros(3)
    accum(x, y)
    while x <= xmax:
        x += h
        k1 = deriv(x, y)
        k2 = deriv(x + 0.5 * h, y + 0.5 * h * k1)
        k3 = deriv(x + 0.5 * h, y + 0.5 * h * k2)
        k4 = deriv(x + h, y + h * k3)
        y = y + h * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
        accum(x, y)
    return np.asarray(rows)


def main(argv=None):
    ap = make_parser("bonnerebert", __doc__)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-d", "--xstep", type=float, default=0.01,
                    help="ODE step in dimensionless units")
    ap.add_argument("-r", "--ratio", type=float, default=14.0,
                    help="central-to-edge density ratio")
    ap.add_argument("-M", "--munit", type=float, default=1e12,
                    help="mass unit in Msun")
    ap.add_argument("-m", "--mass", type=float, default=1.0,
                    help="sphere mass in mass units")
    ap.add_argument("-T", "--temp", type=float, default=1e6,
                    help="temperature in K")
    ap.add_argument("-R", "--runit", type=float, default=300.0,
                    help="radial unit in kpc")
    ap.add_argument("-N", "--number", type=int, default=0,
                    help="particles to sample (0: print profile)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--xmax", type=float, default=1000.0)
    a = ap.parse_args(argv)

    sol = integrate_lane_emden(a.xmax, a.xstep)

    # truncation point where 1/rho crosses the requested contrast
    contrast = sol[:, 7]
    if a.ratio >= contrast[-1]:
        n = len(sol) - 2
    elif a.ratio <= contrast[0]:
        n = 0
    else:
        n = int(np.searchsorted(contrast, a.ratio)) - 1
    denom = contrast[n + 1] - contrast[n]
    A = (contrast[n + 1] - a.ratio) / denom
    B = (a.ratio - contrast[n]) / denom
    xt = A * sol[n, 0] + B * sol[n + 1, 0]
    mt = A * sol[n, 6] + B * sol[n + 1, 6]

    # physical scalings (bonnerebert.cc:276-292)
    mm = _F_H * _MP + (1.0 - _F_H) * 4.0 * _MP
    cs2 = _BOLTZ * a.temp / mm
    Pt = (mt * cs2 * cs2 / (_G ** 1.5 * a.mass * a.munit * _MSUN)) ** 2
    Rhot = Pt / cs2
    Rhoc = Rhot * a.ratio
    rfac = np.sqrt(cs2 / (4.0 * np.pi * _G * Rhoc)) / (a.runit * 1e3 * _PC)
    rhofac = Rhoc * (a.runit * 1e3 * _PC) ** 3 / (a.munit * _MSUN)
    mfac = cs2 * cs2 / (np.sqrt(Pt) * _G ** 1.5) / (a.munit * _MSUN)
    mfac2 = rfac ** 3 * rhofac

    out = open(a.output, "w") if a.output else sys.stdout
    try:
        if a.number == 0:
            for i in range(n + 1):
                out.write(f"{sol[i, 0] * rfac:15.6e}"
                          f"{sol[i, 5] * rhofac:15.6e}"
                          f"{sol[i, 6] * mfac:15.6e}"
                          f"{sol[i, 3] * mfac2:15.6e}\n")
            out.write(f"{xt * rfac:15.6e}"
                      f"{(A * sol[n, 5] + B * sol[n + 1, 5]) * rhofac:15.6e}"
                      f"{mt * mfac:15.6e}"
                      f"{(A * sol[n, 3] + B * sol[n + 1, 3]) * mfac2:15.6e}"
                      "\n")
        else:
            vcirc = np.sqrt(_G * a.mass * a.munit * _MSUN
                            / (a.runit * 1e3 * _PC))
            vfac = np.sqrt(cs2) / vcirc
            rng = np.random.default_rng(a.seed)
            pm = a.mass / a.number
            mmax = float(np.interp(xt, sol[:, 0], sol[:, 3]))
            ms = mmax * rng.uniform(size=a.number)
            rs = np.interp(ms, sol[:, 3], sol[:, 0]) * rfac
            cost = 2.0 * rng.uniform(size=a.number) - 1.0
            sint = np.sqrt(1.0 - cost ** 2)
            phi = 2.0 * np.pi * rng.uniform(size=a.number)
            pos = np.column_stack([rs * sint * np.cos(phi),
                                   rs * sint * np.sin(phi), rs * cost])
            vel = vfac * rng.standard_normal((a.number, 3))
            out.write(f" {a.number} 0 4\n")
            for i in range(a.number):
                out.write(f"{pm:18.10e}"
                          + "".join(f"{c:18.10e}" for c in pos[i])
                          + "".join(f"{c:18.10e}" for c in vel[i])
                          + "".join(f"{0.0:18.10e}" for _ in range(4))
                          + "\n")
    finally:
        if a.output:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
