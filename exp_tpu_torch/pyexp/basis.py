"""pyEXP.basis compatibility (port of exp_tpu/pyexp/basis.py; reference
pyEXP/BasisWrappers.cc).

Reference-named surface over exp_tpu_torch.analysis.basis.Basis: factory,
createFromReader/createFromArray, the incremental accumulate API
(initFromArray/addFromArray/makeFromArray, BiorthBasis.H:258-275),
getFields with the reference's label set (BiorthBasis.cc:71-96),
getBasis / orthoCheck / cacheInfo, the (l,m,n) <-> flat index helpers
I/invI, and IntegrateOrbits with the AccelFunc family
(BiorthBasis.H:1588, BasisWrappers.cc:3040-3160).

Arguments and results are NumPy arrays; the native basis runs on its
device (`factory(..., device=None)`: the CUDA card, raising when there is
none) and uploads each array once and downloads each result once.  Under
`backend: pallas` createFromReader / createFromArray / makeFromArray and
each covariance partition launch the coefficient kernel once (K1, K4),
and getFields two field evaluations (the full and the m = 0
coefficients: K2, K5 each).  IntegrateOrbits is exp_tpu's host leapfrog
with one field evaluation a step.
"""

from __future__ import annotations

import numpy as np
import torch
import yaml

from exp_tpu_torch.analysis.basis import Basis as _NativeBasis
from exp_tpu_torch.analysis.basis import download, force_device, upload
from .coefs import CoefStruct, Coefs


class Basis:
    """Reference-shaped basis: camelCase methods, stateful accumulation."""

    def __init__(self, native: _NativeBasis):
        self._b = native
        self._accum = None          # (xs, ms) lists during accumulation
        self._coefs = None          # last made coefficient array
        self._time = 0.0
        self._center = np.zeros(3)
        self._field_type = ("cylindrical"
                            if native.geometry == "cylinder" else
                            "cartesian" if native.geometry in
                            ("cube", "slab") else "spherical")

    # -- factory ------------------------------------------------------------

    @staticmethod
    def factory(conf, workdir=".", device=None) -> "Basis":
        """Build from the same YAML stanza as the reference
        (BasisFactory.H:247) on `device` (None: CUDA, raising when there
        is none)."""
        return Basis(_NativeBasis.factory(conf, workdir=workdir,
                                          device=device))

    # reference alias
    factory_string = factory

    @property
    def native(self) -> _NativeBasis:
        return self._b

    def getName(self):
        return self._b.name

    def basisIDname(self):
        return self._b.config.get("id", self._b.name)

    # -- coordinate/field-type selection ------------------------------------

    def setFieldType(self, coord: str):
        """'spherical' | 'cylindrical' | 'cartesian' | 'none'
        (coordinate system of the force columns in getFields)."""
        c = coord.lower()
        for full in ("spherical", "cylindrical", "cartesian", "none"):
            if full.startswith(c):
                self._field_type = full
                return
        raise ValueError(f"unknown field type {coord!r}")

    def getFieldType(self):
        return self._field_type

    def getFieldLabels(self):
        """Reference label set (BiorthBasis.cc:71-96)."""
        labels = ["dens m=0", "dens m>0", "dens",
                  "potl m=0", "potl m>0", "potl"]
        if self._field_type == "cylindrical":
            labels += ["rad force", "ver force", "azi force"]
        elif self._field_type == "cartesian":
            labels += ["x force", "y force", "z force"]
        elif self._field_type == "spherical":
            labels += ["rad force", "mer force", "azi force"]
        return labels

    # -- one-shot coefficient creation ---------------------------------------

    def createFromReader(self, reader, center=None, time=None) -> Coefs:
        """Project the reader's selected component
        (BiorthBasis.cc:4517-4582)."""
        mass, x, v = reader.Particles()
        mass, x = self._apply_selector(mass, x, v)
        t = reader.CurrentTime() if time is None else float(time)
        self._accumulate_covariance(mass, x, center)
        c = self._b.create_coefficients(x, mass, time=t, center=center)
        struct = CoefStruct(self._b.geometry, c, time=t,
                            center=center, name=self._b.name,
                            meta=self._b._meta())
        out = Coefs.makecoefs(struct, self._b.name)
        out.add(struct)
        return out

    def createFromArray(self, mass, pos, time=0.0, center=None,
                        roundrobin=True, posvelrows=False) -> CoefStruct:
        """One snapshot -> CoefStruct (reference returns the struct; wrap
        with Coefs.makecoefs/add to build a series)."""
        pos = np.asarray(pos)
        if posvelrows or (pos.ndim == 2 and pos.shape[0] == 3
                          and pos.shape[1] != 3):
            pos = pos.T
        mass = np.broadcast_to(np.asarray(mass, float), (pos.shape[0],))
        mass, pos = self._apply_selector(mass, pos)
        self._accumulate_covariance(mass, pos, center)
        c = self._b.create_coefficients(pos, mass, time=time, center=center)
        return CoefStruct(self._b.geometry, c, time=float(time),
                          center=center, name=self._b.name,
                          meta=self._b._meta())

    # -- incremental accumulation API (initFromArray/addFromArray/make) -----

    def initFromArray(self, center=None):
        self._accum = ([], [])
        self._center = (np.zeros(3) if center is None
                        else np.asarray(center, float))

    def addFromArray(self, mass, pos, posvelrows=False):
        if self._accum is None:
            raise RuntimeError("call initFromArray first")
        pos = np.asarray(pos, float)
        if posvelrows or (pos.ndim == 2 and pos.shape[0] == 3
                          and pos.shape[1] != 3):
            pos = pos.T
        self._accum[0].append(pos)
        self._accum[1].append(np.broadcast_to(
            np.asarray(mass, float), (pos.shape[0],)))

    def makeFromArray(self, time=0.0) -> CoefStruct:
        if self._accum is None:
            raise RuntimeError("call initFromArray first")
        xs = np.concatenate(self._accum[0])
        ms = np.concatenate(self._accum[1])
        self._accum = None
        return self.createFromArray(ms, xs, time=time, center=self._center)

    # per-particle accumulate (BasisWrappers.cc:1704); vector-friendly
    def accumulate(self, x, y, z, mass, indx=0):
        if self._accum is None:
            self.initFromArray()
        pos = np.stack([np.atleast_1d(np.asarray(x, float)),
                        np.atleast_1d(np.asarray(y, float)),
                        np.atleast_1d(np.asarray(z, float))], axis=-1)
        self._accum[0].append(pos)
        self._accum[1].append(np.broadcast_to(
            np.asarray(mass, float), (pos.shape[0],)))

    def reset_coefs(self):
        self._accum = ([], [])
        self._coefs = None

    def make_coefs(self):
        struct = self.makeFromArray(time=self._time)
        self._coefs = struct.coefs
        return struct

    def set_coefs(self, coefstruct):
        """Install coefficients for getFields (BiorthBasis set_coefs)."""
        if isinstance(coefstruct, CoefStruct):
            self._coefs = np.asarray(coefstruct.coefs)
            self._time = float(coefstruct.time)
        else:
            self._coefs = np.asarray(coefstruct)

    # -- field evaluation ----------------------------------------------------

    def _m_zeroed(self, coef):
        """Coefficient array with all m>0 (angular) channels zeroed."""
        c = np.array(coef)
        g = self._b.geometry
        if g == "sphere":
            c[:, :, 1:, :] = 0.0          # (cs, l, m, n)
            c[1] = 0.0                    # sin block is m>=1 only
        elif g == "cylinder":
            c[:, 1:, :] = 0.0             # (cs, m, n)
            c[1] = 0.0
        else:
            c[:] = 0.0                    # cube/slab: no azimuthal split
        return c

    def getFields(self, x, y, z):
        """Fields at one point or arrays of points; columns ordered by
        getFieldLabels()."""
        if self._coefs is None:
            raise RuntimeError("no coefficients: set_coefs/make_coefs first")
        pts = np.stack([np.atleast_1d(np.asarray(x, float)),
                        np.atleast_1d(np.asarray(y, float)),
                        np.atleast_1d(np.asarray(z, float))], axis=-1)
        dens, pot, acc = self._b.get_fields(self._coefs, pts)
        if self._b.geometry in ("cube", "slab"):
            # no azimuthal split for plane-wave bases: the m=0 columns
            # are identically zero — skip the second field evaluation
            d0 = np.zeros_like(dens)
            p0 = np.zeros_like(pot)
        else:
            d0, p0, _ = self._b.get_fields(self._m_zeroed(self._coefs), pts)
        cols = [d0, dens - d0, dens, p0, pot - p0, pot]
        ax, ay, az = acc[:, 0], acc[:, 1], acc[:, 2]
        if self._field_type == "cartesian":
            cols += [ax, ay, az]
        elif self._field_type == "cylindrical":
            R = np.hypot(pts[:, 0], pts[:, 1]) + 1e-30
            cp, sp = pts[:, 0] / R, pts[:, 1] / R
            cols += [ax * cp + ay * sp, az, -ax * sp + ay * cp]
        elif self._field_type == "spherical":
            R = np.hypot(pts[:, 0], pts[:, 1]) + 1e-30
            r = np.sqrt(R * R + pts[:, 2] ** 2) + 1e-30
            cp, sp = pts[:, 0] / R, pts[:, 1] / R
            ct, st = pts[:, 2] / r, R / r
            aR = ax * cp + ay * sp
            cols += [aR * st + az * ct, aR * ct - az * st,
                     -ax * sp + ay * cp]
        out = np.stack(cols, axis=-1)
        return out[0] if out.shape[0] == 1 else out

    def getFieldsCoefs(self, x, y, z, coefs: "Coefs"):
        """Fields at each stored time of a Coefs series ->
        dict time -> columns."""
        out = {}
        saved = self._coefs
        for t in coefs.Times():
            self.set_coefs(coefs.getCoefStruct(t))
            out[t] = self.getFields(x, y, z)
        self._coefs = saved
        return out

    # -- basis introspection -------------------------------------------------

    def getBasis(self, logxmin=-3.0, logxmax=0.5, numgrid=2000,
                 logzmin=-3.0, logzmax=0.5, numz=0,
                 zmin=None, zmax=None):
        """Tabulate the basis functions.

        Spherical: list over l of dict n -> {'potential', 'density',
        'rforce'} on a log radius grid (BasisWrappers.cc:1995).
        Cylindrical: dict m -> n -> {'potential', ...} on an (R, z)
        grid (BasisWrappers.cc:1811).
        Slab: nested list [kx][ky] of dict n -> {'potential', 'density',
        'zforce'} on a linear z grid zmin..zmax (BasisWrappers.cc:2574,
        BiorthBasis.cc:3892 Slab::getBasis)."""
        f = self._b.force
        g = self._b.geometry
        if g == "sphere":
            r = np.logspace(logxmin, logxmax, numgrid)
            grid = f.grid
            rt, = upload(force_device(f), r)
            pot, dens, dpot = download((grid.get_pot(rt), grid.get_dens(rt),
                                        grid.get_pot_dpot(rt)[1]))
            frc = -dpot
            out = []
            for l in range(f.lmax + 1):
                out.append({n: {"potential": pot[:, l, n],
                                "density": dens[:, l, n],
                                "rforce": frc[:, l, n]}
                            for n in range(f.nmax)})
            return out
        if g == "cylinder":
            nz = numz or numgrid // 4
            R = np.logspace(logxmin, logxmax, numgrid)
            z = np.linspace(-(10 ** logzmax), 10 ** logzmax, nz)
            Rg, zg = np.meshgrid(R, z, indexing="ij")
            pts = np.stack([Rg.ravel(), np.zeros(Rg.size), zg.ravel()], -1)
            out = {}
            pts, = upload(force_device(f), pts.astype(np.float32))
            for m in range(f.mmax + 1):
                out[m] = {}
                for n in range(f.nmax):
                    c = np.zeros((2, f.mmax + 1, f.nmax), np.float32)
                    c[0, m, n] = 1.0
                    c, = upload(pts.device, c)
                    _, pot = f.acceleration(c, pts)
                    pot, dens = download((pot, f.density(c, pts)))
                    out[m][n] = {"potential": pot.reshape(numgrid, nz),
                                 "density": dens.reshape(numgrid, nz)}
            return out
        if g == "slab":
            # vertical SL functions per non-negative (kx, ky) wavenumber
            # pair on a linear z grid (BiorthBasis.cc:3892-3950)
            zlo = -f.zmax if zmin is None else float(zmin)
            zhi = f.zmax if zmax is None else float(zmax)
            zq = np.linspace(zlo, zhi, numgrid)
            ztab = np.linspace(-f.zmax, f.zmax, f.numz)
            phi, dphi, dens = (a.astype(np.float64) for a in download(
                (f.phi_t, f.dphi_t, f.dens_t)))
            out = []
            for ix in range(f.nmaxx + 1):
                row = []
                for iy in range(f.nmaxy + 1):
                    row.append({n: {
                        "potential": np.interp(zq, ztab, phi[:, ix, iy, n]),
                        "density": np.interp(zq, ztab, dens[:, ix, iy, n]),
                        "zforce": -np.interp(zq, ztab, dphi[:, ix, iy, n]),
                    } for n in range(f.nmax)})
                out.append(row)
            return out
        raise NotImplementedError(f"getBasis for geometry {g}")

    def orthoCheck(self, knots=40):
        """Biorthogonality Gram matrices: list over l (sphere) / m
        (cylinder) / (kx, ky) pairs (slab) of (nmax, nmax) inner products
        — ~ -identity for the sphere/cylinder potential/density pair,
        ~ +identity for slab (sign-folded) and cube (|Gram| of the plane
        waves, BiorthBasis.cc:4411) — exputil/orthoTest.cc."""
        f = self._b.force
        g = self._b.geometry
        if g == "sphere":
            from exp_tpu_torch.ops import coords

            grid = f.grid
            xi = grid.xmin + grid.dxi * np.arange(grid.numr)
            r = np.asarray(coords.xi_to_r(xi, grid.cmap, grid.rmap))
            rp = 1.0 / np.asarray(coords.dxi_dr(xi, grid.cmap, grid.rmap))
            wq = np.full(grid.numr, grid.dxi)
            wq[0] = wq[-1] = 0.5 * grid.dxi
            # (numr, L+1, nmax)
            pot, dens = download((grid.pot_t, grid.dens_t))
            return [np.einsum("jn,jm,j->nm", pot[:, l], dens[:, l],
                              r ** 2 * rp * wq)
                    for l in range(f.lmax + 1)]
        if g == "cylinder":
            # EOF tables carry the biorthogonal pair (U, D=4 pi rho):
            # int U^m_n D^m_n' R dR dz dphi = -delta_nn'
            # (EmpCylSL ortho check; azimuthal factor 2 pi for m=0, pi else)
            from exp_tpu_torch.ops import coords

            xg = f.xmin + f.dx * np.arange(f.numx)
            Rg = np.asarray(coords.xi_to_r(xg, 1, f.acyl))
            zg = f.hcyl * np.sinh(f.ymin + f.dy * np.arange(f.numy))
            W2 = np.outer(np.gradient(Rg) * Rg, np.gradient(zg))
            sh = (f.numx, f.numy, f.mmax + 1, f.nmax)
            pot, dens = (a.astype(np.float64).reshape(sh)
                         for a in download((f.pot_t, f.dens_t)))
            return [(2 * np.pi if m == 0 else np.pi)
                    * np.einsum("xyn,xym,xy->nm", pot[:, :, m],
                                dens[:, :, m], W2)
                    for m in range(f.mmax + 1)]
        if g == "slab":
            # per (kx, ky) pair: -int phi_n dens_n' dz = sgn_n delta_nn'
            # (SLGridSlab orthoCheck; sgn folded in so the result ~ +I,
            # matching the reference's convention of near-identity output)
            phi, dens, sgn = (a.astype(np.float64) for a in download(
                (f.phi_t, f.dens_t, f.sgn)))
            sgn = sgn[f.nmaxx:, f.nmaxy:]
            zg = np.linspace(-f.zmax, f.zmax, f.numz)
            w = np.gradient(zg)
            return [-np.einsum("zn,zm,z->nm", phi[:, ix, iy],
                               dens[:, ix, iy], w) * sgn[ix, iy][None, :]
                    for ix in range(f.nmaxx + 1)
                    for iy in range(f.nmaxy + 1)]
        if g == "cube":
            # plane waves on the unit torus: the Gram matrix factorizes
            # per axis, G = Gx kron Gy kron Gz with
            # Gx[k,k'] = int_0^1 e^{2 pi i (k'-k) x} dx = delta (exact at
            # any midpoint-rule resolution > the bandwidth); reference
            # returns a single |Gram| (BiorthBasis.cc:4411 Cube::orthoCheck)
            def axis_gram(nmax):
                nq = max(knots, 2 * nmax + 1)   # beyond the k' - k bandwidth
                k = np.arange(-nmax, nmax + 1)
                xq = (np.arange(nq) + 0.5) / nq
                e = np.exp(2j * np.pi * np.outer(k, xq))
                return (np.conj(e) @ e.T).real / nq
            G = np.kron(axis_gram(f.nmaxx),
                        np.kron(axis_gram(f.nmaxy), axis_gram(f.nmaxz)))
            return [np.abs(G)]
        raise NotImplementedError(f"orthoCheck for geometry {g}")

    def cacheInfo(self, cachefile: str):
        """Attributes of a basis cache file as a dict
        (EmpCylSL::cacheInfo / SLGridSph cache header)."""
        import h5py

        out = {}
        with h5py.File(cachefile, "r") as h5:
            def walk(name, obj):
                for k, v in obj.attrs.items():
                    out[f"{name}/{k}" if name else str(k)] = (
                        v.item() if hasattr(v, "item") else v)
            walk("", h5)
            h5.visititems(walk)
        return out

    # -- (l, m, n) index helpers (Spherical only) ----------------------------

    def I(self, l, m, n=0):
        """Flat row index of (l, m) in the packed coefficient matrix
        (BasisWrappers.cc:2065)."""
        if m > l:
            raise ValueError("m > l")
        return l * (l + 1) // 2 + m

    def invI(self, I):
        """Inverse of I(): flat index -> (l, m)."""
        l = int((np.sqrt(8 * I + 1) - 1) // 2)
        return l, I - l * (l + 1) // 2

    # total gravitating mass inside radius r (Spherical getMass analogue)
    def getMass(self, r):
        if self._b.geometry != "sphere":
            raise NotImplementedError("getMass is spherical-only")
        if self._coefs is None:
            raise RuntimeError("set_coefs first")
        # M(<r) = -r^2 dPhi/dr |_monopole = r^2 * (radial acceleration
        # magnitude of the l=0 channel)
        c_mono = np.zeros_like(np.asarray(self._coefs))
        c_mono[0, 0, 0, :] = np.asarray(self._coefs)[0, 0, 0, :]
        pts = np.array([[float(r), 0.0, 0.0]])
        _, _, acc = self._b.get_fields(c_mono, pts)
        return float(-acc[0, 0] * r ** 2)

    # -- acceleration shorthand (BasisWrappers.cc:1548 getAccel) -----------

    def getAccel(self, x, y=None, z=None):
        """Cartesian acceleration at (x, y, z) (scalars or arrays) from
        the current coefficients, minus the pseudo-acceleration when a
        non-inertial frame is active (BiorthBasis.cc:4787)."""
        if self._coefs is None:
            raise RuntimeError("set_coefs first")
        if y is None:
            pts = np.atleast_2d(np.asarray(x, float))
        else:
            pts = np.stack([np.atleast_1d(np.asarray(x, float)),
                            np.atleast_1d(np.asarray(y, float)),
                            np.atleast_1d(np.asarray(z, float))], axis=-1)
        _, _, acc = self._b.get_fields(np.asarray(self._coefs), pts)
        acc = np.asarray(acc) - self.pseudo[None, :]
        return acc[0] if acc.shape[0] == 1 else acc

    getAccelArray = getAccel

    def __call__(self, x, y, z):
        """Field evaluation at a point (BasisWrappers.cc:999)."""
        return self.getFields(x, y, z)

    # -- particle selection functor (BasisWrappers.cc:1132) ----------------

    def setSelector(self, functor):
        """Register a per-particle selection functor
        bool = functor(mass, pos(3,), vel(3,)); applied in
        createFromReader/createFromArray (Basis::setSelector)."""
        self._selector = functor

    def clrSelector(self):
        self._selector = None

    def _apply_selector(self, mass, pos, vel=None):
        fn = getattr(self, "_selector", None)
        if fn is None:
            return mass, pos
        v = np.zeros_like(pos) if vel is None else np.asarray(vel)
        keep = np.fromiter(
            (bool(fn(float(mass[i]), pos[i], v[i]))
             for i in range(len(mass))), bool, count=len(mass))
        return np.asarray(mass)[keep], np.asarray(pos)[keep]

    # -- non-inertial (pseudo-acceleration) frame (BasisFactory.cc:286) ----

    @property
    def pseudo(self):
        return getattr(self, "_pseudo", np.zeros(3))

    def setInertial(self):
        """Reset to inertial coordinates (Basis::setInertial)."""
        self._naccel = 0
        self._pseudo = np.zeros(3)

    def setNonInertial(self, N, orient, pos=None):
        """Load a center trajectory for pseudo-acceleration: `orient` is an
        orient-log filename (EJOrient log: regressed center at columns
        7:10) or a time array with `pos` (T, 3)
        (Basis::setNonInertial, BasisFactory.cc:286-325)."""
        if isinstance(orient, str):
            a = np.loadtxt(orient, ndmin=2)
            t = a[:, 0]
            p = a[:, 7:10] if a.shape[1] >= 10 else a[:, 1:4]
        else:
            t = np.asarray(orient, float)
            p = np.asarray(pos, float)
        if len(t) < 3:
            raise ValueError("setNonInertial: need >= 3 center samples")
        self._naccel = max(3, int(N))
        self._t_accel = t
        self._p_accel = p
        self._pseudo = np.zeros(3)

    def setNonInertialAccel(self, time):
        """Pseudo-acceleration at `time`: 2x the quadratic coefficient of a
        least-squares fit of the center trajectory over ~N samples around
        `time` (Basis::currentAccel, BasisFactory.cc:358-398)."""
        n = getattr(self, "_naccel", 0)
        if not n:
            return self.pseudo
        t, p = self._t_accel, self._p_accel
        imax = min(len(t) - 1, np.searchsorted(t, time) + n // 2)
        imin = max(imax - n, 0)
        tt = t[imin:imax + 1] - time
        A = np.stack([tt * tt, tt, np.ones_like(tt)], axis=-1)
        coef, *_ = np.linalg.lstsq(A, p[imin:imax + 1], rcond=None)
        self._pseudo = 2.0 * coef[0]
        return self._pseudo

    # -- coefficient covariance (OutSamp analogue; BasisWrappers.cc:1933) --

    def enableCoefCovariance(self, use=True, sampT=100):
        """Enable partitioned coefficient covariance accumulation: the
        next createFromArray/createFromReader also projects sampT particle
        partitions separately (Cylindrical/SphericalSL
        enableCoefCovariance)."""
        self._sampT = int(sampT) if use else 0
        self._covar = None

    def _accumulate_covariance(self, mass, pos, center=None):
        sampT = getattr(self, "_sampT", 0)
        if not sampT:
            return
        n = len(mass)
        part = np.arange(n) % sampT
        samples, counts, masses = [], [], []
        for s in range(sampT):
            sel = part == s
            c = self._b.create_coefficients(pos[sel], mass[sel],
                                            center=center,
                                            accum_dtype=torch.float64)
            samples.append(np.asarray(c).ravel())
            counts.append(int(sel.sum()))
            masses.append(float(mass[sel].sum()))
        self._covar = np.stack(samples)        # (sampT, ncoef)
        self._covar_counts = np.asarray(counts)
        self._covar_masses = np.asarray(masses)

    def getCoefCovariance(self):
        """(mean (ncoef,), covariance (ncoef, ncoef)) over the sampT
        partition coefficient vectors (scaled to full-population sums)."""
        if getattr(self, "_covar", None) is None:
            raise RuntimeError("enableCoefCovariance + createFrom* first")
        V = self._covar * self._covar.shape[0]   # per-partition -> total
        mu = V.mean(axis=0)
        d = V - mu
        return mu, (d.T @ d) / max(1, V.shape[0] - 1)

    def setCovarH5Compress(self, compress=5, chunkSize=1024 * 1024,
                           shuffle=True, szip=False):
        self._h5_compress = int(compress)

    def writeCoefCovariance(self, cachefile, time=0.0):
        """Write the partitioned coefficient vectors + covariance to HDF5
        (Cylindrical::writeCoefCovariance)."""
        import h5py

        if getattr(self, "_covar", None) is None:
            raise RuntimeError("enableCoefCovariance + createFrom* first")
        mu, C = self.getCoefCovariance()
        kw = {}
        lvl = getattr(self, "_h5_compress", 0)
        if lvl:
            kw = dict(compression="gzip", compression_opts=min(lvl, 9))
        with h5py.File(cachefile, "a") as f:
            prev = str(f.attrs.get("basisID", ""))
            if prev and prev != self.basisIDname():
                raise ValueError(
                    f"{cachefile} holds covariance for basis {prev!r}; "
                    f"refusing to mix in {self.basisIDname()!r}")
            f.attrs["basisID"] = self.basisIDname()
            key = f"covariance/{float(time):.8e}"
            if key in f:                      # rewrite-at-same-time
                del f[key]
            g = f.create_group(key)
            g.attrs["sampT"] = self._covar.shape[0]
            g.attrs["time"] = float(time)
            g.create_dataset("samples", data=self._covar, **kw)
            g.create_dataset("counts", data=self._covar_counts)
            g.create_dataset("masses", data=self._covar_masses)
            g.create_dataset("mean", data=mu, **kw)
            g.create_dataset("covariance", data=C, **kw)

    # -- cube wave-number indexing (BasisWrappers.cc:2655) -----------------

    def index1D(self, nx, ny, nz):
        """Flattened index of wave numbers (nx, ny, nz) in the packed cube
        coefficient layout (Cube::index1D; signed k in -nmax..nmax)."""
        f = self._b.force
        sx, sy, sz = 2 * f.nmaxx + 1, 2 * f.nmaxy + 1, 2 * f.nmaxz + 1
        ix, iy, iz = nx + f.nmaxx, ny + f.nmaxy, nz + f.nmaxz
        if not (0 <= ix < sx and 0 <= iy < sy and 0 <= iz < sz):
            raise ValueError("wave number out of range")
        return (ix * sy + iy) * sz + iz

    def invI3(self, I):
        return self.index3D(I)

    def index3D(self, I):
        """Inverse of index1D: flat index -> (nx, ny, nz) (Cube::index3D)."""
        f = self._b.force
        sy, sz = 2 * f.nmaxy + 1, 2 * f.nmaxz + 1
        iz = I % sz
        iy = (I // sz) % sy
        ix = I // (sy * sz)
        return ix - f.nmaxx, iy - f.nmaxy, iz - f.nmaxz

    # -- coefficients from a density function (BiorthBasis.cc:5230) -------

    def makeFromFunction(self, func, params=None, time=0.0,
                         potential=False):
        """Coefficients from a density (or potential) function callback
        rho = func(x, y, z, time) by Gauss-Legendre quadrature over the
        basis domain (Spherical::makeFromFunction; params keys `knots`,
        `rmapping`).  The quadrature nodes become weighted 'particles', so
        the projection reuses the particle kernels."""
        if potential:
            raise NotImplementedError(
                "makeFromFunction(potential=True): project the density "
                "partner instead (the biorthogonal pair makes them "
                "equivalent)")
        w, pts = self._quadrature_nodes(params)
        rho = np.asarray([func(p[0], p[1], p[2], time) for p in pts])
        st = self.createFromArray(w * rho, pts, time=time)
        return st

    def computeQuadrature(self, func, params=None):
        """Quadrature of func(x, y, z) over the basis domain
        (Spherical::computeQuadrature)."""
        w, pts = self._quadrature_nodes(params)
        vals = np.asarray([func(p[0], p[1], p[2]) for p in pts])
        return float(np.sum(w * vals))

    def _quadrature_nodes(self, params=None):
        """(weights, points (N, 3)) covering the basis domain: GL in the
        mapped radius and cos(theta), uniform in phi (sphere), or GL in
        (R, z) x uniform phi (cylinder)."""
        params = dict(params or {})
        knots = int(params.get("knots", 64))
        g = self._b.geometry
        f = self._b.force
        if g == "sphere":
            grid = f.grid
            rmap = float(params.get("rmapping", grid.rmap))
            from exp_tpu_torch.ops import coords

            xi, wx = np.polynomial.legendre.leggauss(knots)
            ximin = float(coords.r_to_xi(grid.rmin + 1e-12, grid.cmap, rmap))
            ximax = float(coords.r_to_xi(grid.rmax, grid.cmap, rmap))
            xq = 0.5 * (ximax + ximin) + 0.5 * (ximax - ximin) * xi
            wq = 0.5 * (ximax - ximin) * wx
            r = np.asarray(coords.xi_to_r(xq, grid.cmap, rmap))
            drdxi = 1.0 / np.asarray(coords.dxi_dr(xq, grid.cmap, rmap))
            ct, wt = np.polynomial.legendre.leggauss(max(knots // 2, 8))
            nphi = max(knots // 2, 8)
            ph = 2 * np.pi * (np.arange(nphi) + 0.5) / nphi
            wp = 2 * np.pi / nphi
            R, CT, PH = np.meshgrid(r, ct, ph, indexing="ij")
            W = (wq * r * r * drdxi)[:, None, None] \
                * wt[None, :, None] * wp
            ST = np.sqrt(1 - CT ** 2)
            pts = np.stack([R * ST * np.cos(PH), R * ST * np.sin(PH),
                            R * CT], axis=-1).reshape(-1, 3)
            return np.broadcast_to(W, R.shape).reshape(-1).copy(), pts
        if g == "cylinder":
            Rmax = f.rmax_grid
            zmax = float(np.sinh(f.ymin + f.dy * (f.numy - 1)) * f.hcyl)
            xr, wr = np.polynomial.legendre.leggauss(knots)
            R = 0.5 * Rmax * (xr + 1.0)
            wR = 0.5 * Rmax * wr * R
            xz, wz = np.polynomial.legendre.leggauss(max(knots // 2, 8))
            z = zmax * xz
            wZ = zmax * wz
            nphi = max(knots // 2, 8)
            ph = 2 * np.pi * (np.arange(nphi) + 0.5) / nphi
            wp = 2 * np.pi / nphi
            RR, ZZ, PH = np.meshgrid(R, z, ph, indexing="ij")
            W = wR[:, None, None] * wZ[None, :, None] * wp
            pts = np.stack([RR * np.cos(PH), RR * np.sin(PH), ZZ],
                           axis=-1).reshape(-1, 3)
            return np.broadcast_to(W, RR.shape).reshape(-1).copy(), pts
        raise NotImplementedError(f"quadrature for geometry {g}")


# ---------------------------------------------------------------------------
# Field expansions over particle attributes (BasisWrappers.cc FieldBasis /
# VelocityBasis; expui/FieldBasis.H:23-186)

class FieldBasis:
    """pyEXP.basis.FieldBasis: expand per-particle phase-space fields over
    a harmonic x radial span conditioned on `modelname` (dof=3 sphere) or
    a disk background (dof=2).  Accepts the reference's YAML keys
    (FieldBasis.cc:27-39: modelname, dof, rmin/rmax/rmapping, ascl,
    lmax/mmax/nmax).  The expansion runs on `device` (None: CUDA, raising
    when there is none), on exp_tpu's f64 tables (the sphere's gather
    backend, the flat disk's xla): one upload of x, v and mass a
    projection, one download of its coefficients."""

    _default_fields = ("vx", "vy", "vz")

    def __init__(self, conf, device=None):
        from exp_tpu_torch import resolve_device
        from exp_tpu_torch.analysis.field_basis import FieldBasis as _Native

        if isinstance(conf, str):
            conf = yaml.safe_load(conf)
        conf = conf or {}
        p = dict(conf.get("parameters") or
                 {k: v for k, v in conf.items() if k != "id"})
        dof = int(p.get("dof", 3))
        nmax = int(p.get("nmax", 10))
        device = resolve_device(device)
        if dof == 3:
            from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
            from exp_tpu_torch.cli._common import load_model
            from exp_tpu_torch.forces.spherical import SphereSL

            model = load_model(p.get("modelname", "hernquist"),
                               rmin=float(p.get("rmin", 1e-4)),
                               rmax=float(p.get("rmax", 20.0)))
            t = build_sph_sl_tables(
                model, lmax=int(p.get("lmax", 4)), nmax=nmax,
                numr=int(p.get("numr", 1000)), cmap=1,
                rmap=float(p.get("rmapping", 1.0)))
            force = SphereSL.from_tables(t, dtype=torch.float64,
                                         backend="gather", device=device)
        elif dof == 2:
            from exp_tpu_torch.basis.flatdisk import build_flatdisk_tables
            from exp_tpu_torch.forces.cylinder import CylinderForce

            t = build_flatdisk_tables(
                mmax=int(p.get("mmax", 6)), nmax=nmax, model="expon",
                acyl=float(p.get("ascl", 0.01)))
            force = CylinderForce.from_tables(t, dtype=torch.float64,
                                              device=device)
        else:
            raise ValueError(f"dof must be 2 or 3, got {dof}")
        self._fb = _Native(force, self._default_fields)
        self._accum = None
        self.name = conf.get("name", "fieldbasis")

    def addPSFunction(self, func, labels):
        """Register a derived-field functor func(mass, pos(3,), vel(3,))
        -> list of len(labels) values (FieldBasis::addPSFunction)."""
        labels = list(labels)
        probe = func(0.01, np.full(3, 0.01), np.full(3, 0.01))
        if len(np.atleast_1d(probe)) != len(labels):
            raise ValueError(
                f"field dimension <{len(np.atleast_1d(probe))}> != label "
                f"dimension <{len(labels)}> (FieldBasis.cc:49)")

        def vec(k):
            def fn(x, v, m):
                return np.asarray(
                    [np.atleast_1d(func(float(m[i]), x[i], v[i]))[k]
                     for i in range(x.shape[0])])
            return fn

        for k, lab in enumerate(labels):
            self._fb.add_field(lab, vec(k))

    # -- projection ---------------------------------------------------------

    def createFromReader(self, reader, center=None):
        m, x, v = reader.Particles()
        x = np.asarray(x, float)
        if center is not None:
            x = x - np.asarray(center, float)[None, :]
        return download(self._fb.coefficients(x, np.asarray(v, float),
                                              np.asarray(m, float)))

    def initFromArray(self, center=None):
        self._accum = ([], [], [])
        self._center = (np.zeros(3) if center is None
                        else np.asarray(center, float))

    def addFromArray(self, mass, ps):
        """ps: (N, 6) phase space rows [x y z u v w] (FieldBasis
        addFromArray)."""
        if self._accum is None:
            raise RuntimeError("call initFromArray first")
        ps = np.asarray(ps, float)
        self._accum[0].append(np.broadcast_to(
            np.asarray(mass, float), (ps.shape[0],)))
        self._accum[1].append(ps[:, :3] - self._center[None, :])
        self._accum[2].append(ps[:, 3:6])

    def makeFromArray(self, time=0.0):
        if self._accum is None:
            raise RuntimeError("call initFromArray first")
        m = np.concatenate(self._accum[0])
        x = np.concatenate(self._accum[1])
        v = np.concatenate(self._accum[2])
        self._accum = None
        return download(self._fb.coefficients(x, v, m))

    # -- evaluation ---------------------------------------------------------

    def getFields(self, coefs, x, y, z):
        """Field estimates at one point or arrays of points: dict
        label -> values."""
        pts = np.stack([np.atleast_1d(np.asarray(x, float)),
                        np.atleast_1d(np.asarray(y, float)),
                        np.atleast_1d(np.asarray(z, float))], axis=-1)
        out = self._fb.evaluate(coefs, pts)
        if pts.shape[0] == 1:
            out = {k: v[0] for k, v in out.items()}
        return out

    def getBasis(self, logxmin=-3.0, logxmax=0.5, numgrid=400):
        """Underlying radial basis tables (FieldBasis::getBasis)."""
        return Basis(_NativeBasis(self._fb.force)).getBasis(
            logxmin, logxmax, numgrid)

    def orthoCheck(self, knots=40):
        return Basis(_NativeBasis(self._fb.force)).orthoCheck(knots)


class VelocityBasis(FieldBasis):
    """pyEXP.basis.VelocityBasis: FieldBasis preloaded with the velocity
    field set (FieldBasis.H:186)."""

    _default_fields = "spherical"


# ---------------------------------------------------------------------------
# Orbit integration (BasisWrappers.cc:3040-3160; BiorthBasis.cc:5056)

class AccelFunc:
    """Base acceleration functor: F(time, ps, accel, mod) adds the
    acceleration of model `mod` = (Basis, Coefs) to `accel`."""

    def F(self, time, ps, accel, mod):
        raise NotImplementedError


class AllTimeAccel(AccelFunc):
    """Interpolates coefficients from the Coefs series at every time."""

    def F(self, time, ps, accel, mod):
        basis, coefs = mod
        nat = coefs._c if hasattr(coefs, "_c") else coefs
        c = nat.interpolate(time)
        b = basis.native if hasattr(basis, "native") else basis
        _, _, acc3 = b.get_fields(c, ps[:, :3])
        accel[:, :3] += acc3
        if hasattr(basis, "setNonInertialAccel"):
            # non-inertial frame: refresh + subtract the pseudo
            # acceleration (BiorthBasis.cc:4787, 4888)
            accel[:, :3] -= basis.setNonInertialAccel(time)[None, :] \
                if getattr(basis, "_naccel", 0) else 0.0
        return accel


class SingleTimeAccel(AccelFunc):
    """Uses the coefficient set at one fixed time."""

    def __init__(self, time, mods=None):
        self.time = float(time)
        self._cache = {}

    def F(self, time, ps, accel, mod):
        basis, coefs = mod
        nat = coefs._c if hasattr(coefs, "_c") else coefs
        key = id(coefs)
        if key not in self._cache:
            self._cache[key] = nat.interpolate(self.time)
        b = basis.native if hasattr(basis, "native") else basis
        _, _, acc3 = b.get_fields(self._cache[key], ps[:, :3])
        accel[:, :3] += acc3
        return accel


def IntegrateOrbits(tinit, tfinal, h, ps, bfe, func, nout=0):
    """Leapfrog orbit integration in the field of `bfe` = list of
    (Basis, Coefs) pairs (BiorthBasis.cc:5056 IntegrateOrbits).

    ps: (n, 6) phase space [x, y, z, u, v, w].
    Returns (times (T,), orbits (T, n, 6) float32)."""
    ps = np.array(ps, float)
    nsteps = max(1, int(round((tfinal - tinit) / h)))
    h = (tfinal - tinit) / nsteps
    stride = max(1, nsteps // nout) if nout > 0 else 1

    def accel_at(t, ps):
        a = np.zeros((ps.shape[0], 6))
        for mod in bfe:
            a = func.F(t, ps, a, mod)
        return a[:, :3]

    times = [tinit]
    out = [ps.copy()]
    a = accel_at(tinit, ps)
    t = tinit
    for i in range(nsteps):
        ps[:, 3:6] += 0.5 * h * a
        ps[:, 0:3] += h * ps[:, 3:6]
        t += h
        a = accel_at(t, ps)
        ps[:, 3:6] += 0.5 * h * a
        if (i + 1) % stride == 0 or i == nsteps - 1:
            times.append(t)
            out.append(ps.copy())
    return np.asarray(times), np.asarray(out, np.float32)


class CovarianceReader:
    """Read a coefficient-covariance database written by
    Basis.writeCoefCovariance (the reference's SubsampleCovariance,
    bound as pyEXP.basis.CovarianceReader, BasisWrappers.cc:3172-3242).

    stride subsamples the stored partitions (every stride-th sample)."""

    def __init__(self, filename: str, stride: int = 1):
        import h5py

        self.filename = str(filename)
        self.stride = max(1, int(stride))
        self._groups = {}
        with h5py.File(self.filename, "r") as f:
            self._basis_id = str(f.attrs.get("basisID", ""))
            for key in f.get("covariance", {}):
                g = f[f"covariance/{key}"]
                self._groups[float(g.attrs["time"])] = key

    def Times(self):
        return sorted(self._groups)

    def basisIDname(self):
        return self._basis_id

    def getCoefCovariance(self, time: float):
        """(counts (T,), masses (T,), coefs (T, ncoef), covariance
        (ncoef, ncoef)) for the stored time nearest `time`, with the
        partitions subsampled by the reader's stride."""
        import h5py

        ts = self.Times()
        if not ts:
            raise KeyError("no covariance groups in file")
        t = min(ts, key=lambda u: abs(u - time))
        with h5py.File(self.filename, "r") as f:
            g = f[f"covariance/{self._groups[t]}"]
            sel = slice(None, None, self.stride)
            sampT = int(g.attrs.get("sampT", g["samples"].shape[0]))
            samples = np.asarray(g["samples"])[sel]
            counts = (np.asarray(g["counts"])[sel] if "counts" in g
                      else np.zeros(samples.shape[0], int))
            masses = (np.asarray(g["masses"])[sel] if "masses" in g
                      else np.zeros(samples.shape[0]))
            if self.stride == 1 and "covariance" in g:
                C = np.asarray(g["covariance"])
            else:
                # each partition holds ~1/sampT of the population, so the
                # population scaling is the STORED sampT, not the retained
                # row count after striding
                V = samples * sampT
                d = V - V.mean(axis=0)
                C = (d.T @ d) / max(1, V.shape[0] - 1)
        return counts, masses, samples, C
