"""External force fields, host operators, boundary wrappers and the
user-module registry (port of exp_tpu/forces/external.py).

The analogue of the reference's ExternalForce framework + user plugins
(src/ExternalCollection.cc:67-113 built-ins; src/user/ UserBar, UserDisk,
UserHalo, UserLogPot, UserMNdisk, UserMW...): global analytic fields added
to every component's acceleration.  Each field is a potential function
Phi(x, t) on tensors; the acceleration is -grad Phi by torch.autograd of
Phi(x, t).sum() with respect to a detached copy of x, under
torch.enable_grad().  Every particle's potential depends on its own
position only, so the gradient of the sum is the per-particle gradient
(exp_tpu's jax.vmap(jax.grad)).  UserHalo keeps its closed-form M(r)/r^2.

Python entry points replace the reference's dlopen plugin registry
(ExternalCollection.cc:194-256): registering a new field is
`register_external("myfield", MyFieldClass)`.

ScatterMFP and GenerateRelaxation are host operators applied between
blocks of the single-rate driver: they pull the state to NumPy, and
ScatterMFP draws from NumPy's generator seeded as exp_tpu seeds it, so its
draws are exp_tpu's.  On a world every rank applies them to the same
gathered state with the same draws; GenerateRelaxation writes from the
primary rank alone (`primary`).  PeriodicBC is a position wrapper applied after each
drift.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch


def _t(t, x):
    """The time as a 0-d tensor of the positions' dtype and device."""
    return torch.as_tensor(t, dtype=x.dtype, device=x.device)


def _sqrt0(a):
    """sqrt(a) for a >= 0 whose gradient is 0, not NaN, where a = 0: the
    radius of a particle at the origin, or the cylindrical radius of one
    on the z axis (zero-mass padding rows sit at the origin).  Equal to
    torch.sqrt(a) bit for bit wherever a > 0."""
    pos = a > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, a, torch.ones_like(a))),
                       torch.zeros_like(a))


def _interp(x, xp, fp):
    """jnp.interp of 1-d tables (constant ends): x in the dtype of xp."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(
        str(xp.dtype).replace("torch.", "")).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class ExternalField:
    """Base: subclasses implement potential(x, t) -> (N,)."""

    def potential(self, x, t):
        raise NotImplementedError

    def acceleration(self, x, t):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            phi = self.potential(xg, t)
            (g,) = torch.autograd.grad(phi.sum(), xg)
        return -g, phi.detach()


@dataclass
class UserLogPot(ExternalField):
    """Logarithmic halo: Phi = 1/2 v0^2 ln(rc^2 + R^2 + (z/q)^2)
    (src/user/UserLogPot.cc)."""

    v0: float = 1.0
    q: float = 0.9
    rc: float = 0.1

    def potential(self, x, t):
        R2 = x[:, 0] ** 2 + x[:, 1] ** 2
        return 0.5 * self.v0 ** 2 * torch.log(
            self.rc ** 2 + R2 + (x[:, 2] / self.q) ** 2)


@dataclass
class UserMNdisk(ExternalField):
    """Miyamoto–Nagai disk: Phi = -M / sqrt(R^2 + (a + sqrt(z^2+b^2))^2)
    (src/user/UserMNdisk.cc)."""

    a: float = 1.0
    b: float = 0.1
    mass: float = 1.0

    def potential(self, x, t):
        R2 = x[:, 0] ** 2 + x[:, 1] ** 2
        zb = torch.sqrt(x[:, 2] ** 2 + self.b ** 2)
        return -self.mass / torch.sqrt(R2 + (self.a + zb) ** 2)


@dataclass
class UserHalo(ExternalField):
    """Fixed spherical halo from a model file (src/user/UserHalo.cc):
    interpolates Phi(r) and M(r) from a SphericalModelTable."""

    r_t: torch.Tensor = None
    pot_tab: torch.Tensor = None
    mass_tab: torch.Tensor = None

    @classmethod
    def from_model(cls, model, dtype=torch.float32, device="cpu"):
        def tens(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(r_t=tens(np.log(model.r)), pot_tab=tens(model.pot),
                   mass_tab=tens(model.mass))

    def _lr(self, x):
        r = torch.sqrt(torch.sum(x * x, dim=-1)) + 1e-12
        return r, torch.clamp(torch.log(r), self.r_t[0], self.r_t[-1])

    def potential(self, x, t):
        r, lr = self._lr(x)
        pot = _interp(lr, self.r_t, self.pot_tab)
        # Keplerian continuation beyond the table edge so that the force
        # (M(rmax)/r^2) stays -grad(potential) for escaping particles
        rmax = torch.exp(self.r_t[-1])
        return torch.where(r > rmax, -self.mass_tab[-1] / r, pot)

    def acceleration(self, x, t):
        # exact spherical force M(r)/r^2 (smoother than autodiff of interp)
        r, lr = self._lr(x)
        M = _interp(lr, self.r_t, self.mass_tab)
        a = -(M / r ** 3)[:, None] * x
        return a, self.potential(x, t)


@dataclass
class UserBar(ExternalField):
    """Rotating quadrupole bar with adiabatic amplitude ramp
    (src/user/UserBar.cc): Phi = -amp(t) (R/(R+b))^5-style quadrupole
    cos(2(phi - Omega t)) truncated at length `length`, written without
    phi so that the force is finite at the origin and on the z axis."""

    amplitude: float = 0.1
    length: float = 0.5
    omega: float = 1.0
    Ton: float = 0.0
    DeltaT: float = 0.5

    def potential(self, x, t):
        t = _t(t, x)
        xx, yy = x[:, 0], x[:, 1]
        r2 = xx * xx + yy * yy + x[:, 2] ** 2
        amp = self.amplitude * 0.5 * (
            1.0 + torch.tanh((t - self.Ton) / self.DeltaT))
        b = self.length
        # smooth rational quadrupole profile (UserBar.cc:479-494
        # fac = 1 + (r/b)^5): inner ~ r^2/b^3, outer ~ b^2/r^3, C-inf.
        # exp_tpu writes R2/r2 cos 2(phi - Omega t) with phi = atan2(y, x)
        # and r = sqrt(r2) + 1e-12, whose gradients are NaN at the origin
        # and on the z axis.  Here the angular factor is the polynomial
        # ((x^2 - y^2) cos 2 Omega t + 2 x y sin 2 Omega t) / r2 and r
        # comes from _sqrt0, so the force is finite everywhere (0 on the
        # z axis) and equals exp_tpu's elsewhere to roundoff; r keeps the
        # 1e-12 of exp_tpu's profile, which r2 ** 2.5 would drop (5e-12
        # of the force at r ~ b)
        r = _sqrt0(r2) + 1e-12
        shape = (r2 / b ** 3) / (1.0 + (r / b) ** 5)
        wt = 2.0 * self.omega * t
        quad = (xx * xx - yy * yy) * torch.cos(wt) \
            + 2.0 * xx * yy * torch.sin(wt)
        return -amp * shape * quad / torch.clamp(r2, min=1e-20)


@dataclass
class UserEllipsoid(ExternalField):
    """Rotating triaxial ellipsoid bar with the EXACT Chandrasekhar
    homoeoid potential (utils/ICs/EllipsoidForce.cc powerlaw/ferrers/
    expon families; ic/ellipsoid.py) and an adiabatic amplitude ramp.
    Forces are autograd gradients — no force table."""

    a: tuple = (0.5, 0.25, 0.125)
    mass: float = 0.1
    bartype: str = "ferrers"
    param: float = 1.0
    omega: float = 1.0
    Ton: float = 0.0
    DeltaT: float = 0.5

    def __post_init__(self):
        from exp_tpu_torch.ic.ellipsoid import EllipsoidForce

        object.__setattr__(self, "_ellip", EllipsoidForce(
            a=tuple(self.a), mass=self.mass, bartype=self.bartype,
            param=self.param))

    def potential(self, x, t):
        t = _t(t, x)
        ang = self.omega * t
        c, s = torch.cos(ang), torch.sin(ang)
        # body frame: rotate by -Omega t about z
        xb = torch.stack([c * x[:, 0] + s * x[:, 1],
                          -s * x[:, 0] + c * x[:, 1], x[:, 2]], dim=-1)
        amp = 0.5 * (1.0 + torch.tanh((t - self.Ton) / self.DeltaT))
        return amp * self._ellip.potential(xb)


def _ramp(t, ton, toff, dT):
    """The erf on/off amplitude ramp of UserMW and UserDisk."""
    erf = torch.special.erf
    return 0.25 * ((1.0 + erf((t - ton) / dT)) * (1.0 + erf((toff - t) / dT)))


@dataclass
class UserMW(ExternalField):
    """Milky-Way potential a la Gala (src/user/UserMW.H:9-31): NFW halo +
    Miyamoto–Nagai disk + Hernquist nucleus + Hernquist bulge, with an erf
    amplitude ramp between Ton and Toff."""

    M_halo: float = 1.0
    rs_halo: float = 1.0
    M_disk: float = 0.05
    a_disk: float = 0.3
    b_disk: float = 0.03
    M_nucl: float = 0.0
    c_nucl: float = 0.01
    M_bulge: float = 0.01
    c_bulge: float = 0.1
    Ton: float = -1.0e20
    Toff: float = 1.0e20
    DeltaT: float = 0.25

    def potential(self, x, t):
        t = _t(t, x)
        # _sqrt0: a finite (zero) force at the origin, where exp_tpu's
        # sqrt gives NaN
        r = _sqrt0(torch.sum(x * x, dim=-1)) + 1e-12
        R2 = x[:, 0] ** 2 + x[:, 1] ** 2
        # NFW
        u = r / self.rs_halo
        phi = -self.M_halo / r * torch.log1p(u)
        # MN disk
        zb = torch.sqrt(x[:, 2] ** 2 + self.b_disk ** 2)
        phi = phi - self.M_disk / torch.sqrt(R2 + (self.a_disk + zb) ** 2)
        # Hernquist nucleus + bulge
        phi = phi - self.M_nucl / (r + self.c_nucl)
        phi = phi - self.M_bulge / (r + self.c_bulge)
        return _ramp(t, self.Ton, self.Toff, self.DeltaT) * phi


class UserDisk(ExternalField):
    """Thin exponential disk, potential tabulated on an (R, |z|) grid
    (src/user/UserDisk.H:8-24).  The table is built on the host with scipy
    from the Bessel integral  Phi(R,z) = -2 pi Sigma0 a^2 \\int J0(kR)
    e^{-k|z|} k dk / (1+(ka)^2)^{3/2}, then bilinearly interpolated on the
    device; forces come from autograd of the interpolant."""

    def __init__(self, a=1.0, mass=1.0, Ton=-1e20, Toff=1e20, DeltaT=0.25,
                 Nscale=25.0, Ngrid=256, Nint=600, dtype=torch.float32,
                 device="cpu"):
        from scipy.special import j0

        self.a, self.mass = float(a), float(mass)
        self.Ton, self.Toff, self.DeltaT = Ton, Toff, DeltaT
        Rmax = Zmax = Nscale * self.a
        Rg = np.linspace(0.0, Rmax, Ngrid)
        Zg = np.linspace(0.0, Zmax, Ngrid)
        # log-spaced k quadrature of the Bessel integral
        k = np.geomspace(1e-4 / self.a, 2e2 / self.a, Nint)
        wk = np.gradient(k)
        Sigma0a2 = self.mass / (2.0 * np.pi)   # Sigma0 a^2 for total mass M
        kern = k * wk / (1.0 + (k * self.a) ** 2) ** 1.5   # (Nint,)
        J = j0(k[None, :] * Rg[:, None])                   # (Ngrid, Nint)
        E = np.exp(-k[None, :] * Zg[:, None])              # (Ngrid, Nint)
        tab = -2.0 * np.pi * Sigma0a2 * np.einsum(
            "rk,zk,k->rz", J, E, kern)                     # (R, z)
        self.Rmax, self.Zmax = Rmax, Zmax
        self.dR = Rg[1] - Rg[0]
        self.dZ = Zg[1] - Zg[0]
        self.tab = torch.as_tensor(tab, dtype=dtype, device=device)

    def potential(self, x, t):
        t = _t(t, x)
        # _sqrt0: a finite force on the z axis, where exp_tpu's sqrt
        # gives NaN
        R = _sqrt0(x[:, 0] ** 2 + x[:, 1] ** 2)
        Z = torch.abs(x[:, 2])
        n = self.tab.shape[0]
        tr = torch.clamp(R / self.dR, 0.0, n - 1.001)
        tz = torch.clamp(Z / self.dZ, 0.0, n - 1.001)
        i = torch.floor(tr).to(torch.int64)
        j = torch.floor(tz).to(torch.int64)
        fr, fz = tr - i.to(tr.dtype), tz - j.to(tz.dtype)
        tab = self.tab.to(x.device)
        p = (tab[i, j] * (1 - fr) * (1 - fz)
             + tab[i + 1, j] * fr * (1 - fz)
             + tab[i, j + 1] * (1 - fr) * fz
             + tab[i + 1, j + 1] * fr * fz)
        # Keplerian continuation outside the table
        r = _sqrt0(R * R + Z * Z)
        p = torch.where((R < self.Rmax) & (Z < self.Zmax), p,
                        -self.mass / torch.clamp(r, min=1e-12))
        return _ramp(t, self.Ton, self.Toff, self.DeltaT) * p


@dataclass
class ExternalShock(ExternalField):
    """Time-dependent tidal shock along z (src/externalShock.H:7-24):
    Phi = 1/2 A(t) z^2 with a sech^2 pulse of amplitude AMPL and duration
    PER centered on each passage (the pulse profile is specified
    directly)."""

    AMPL: float = 1.0
    PER: float = 0.5
    T0: float = 1.0

    def potential(self, x, t):
        A = self.AMPL / torch.cosh((_t(t, x) - self.T0) / self.PER) ** 2
        return 0.5 * A * x[:, 2] ** 2


@dataclass
class TidalField(ExternalField):
    """Linear tidal tensor Phi = 1/2 x^T T x (src/tidalField.cc)."""

    txx: float = 0.0
    tyy: float = 0.0
    tzz: float = 0.0

    def potential(self, x, t):
        return 0.5 * (self.txx * x[:, 0] ** 2 + self.tyy * x[:, 1] ** 2
                      + self.tzz * x[:, 2] ** 2)


def _np(a):
    return a.detach().cpu().numpy()


class ScatterMFP:
    """Mean-free-path dark-matter self-interaction scattering
    (src/ScatterMFP.H:14-45).  Host operator applied between blocks: each
    application, every particle is scattered with probability dt/tau
    weighted by local density (radial shell estimate); a scattered particle
    keeps |v| but gets an isotropic random direction (elastic isotropic
    scattering in the local frame)."""

    is_operator = True

    def __init__(self, tau=10.0, rmax=10.0, tautab=40, nscat=1, seed=11,
                 **kw):
        self.tau = float(tau)
        self.rmax = float(rmax)
        self.tautab = int(tautab)
        self.nscat = int(nscat)       # apply every nscat blocks
        self.rng = np.random.default_rng(seed)
        self.nscattered = 0

    def apply(self, ps, dt, istep, time=0.0, name=""):
        if self.nscat > 0 and istep % self.nscat:
            return ps
        m = _np(ps.mass)
        live = m > 0
        x = _np(ps.x)
        v = _np(ps.v)
        r = np.linalg.norm(x, axis=1)
        # shell density estimate -> scattering rate ~ rho(r)
        edges = np.linspace(0.0, self.rmax, self.tautab + 1)
        idx = np.clip(np.digitize(r, edges) - 1, 0, self.tautab - 1)
        vol = 4.0 * np.pi / 3.0 * np.diff(edges ** 3)
        rho = np.bincount(idx, weights=m, minlength=self.tautab) / vol
        rate = rho[idx] / max(rho.max(), 1e-300)
        p = np.clip(dt / self.tau * rate, 0.0, 1.0)
        hit = live & (self.rng.random(len(m)) < p)
        nh = int(hit.sum())
        if nh:
            u = self.rng.normal(size=(nh, 3))
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            v = v.copy()
            v[hit] = u * np.linalg.norm(v[hit], axis=1, keepdims=True)
            self.nscattered += nh
        return replace(ps, v=torch.as_tensor(v, dtype=ps.v.dtype,
                                             device=ps.v.device))


class GenerateRelaxation:
    """Relaxation diagnostic (src/generateRelaxation.H:4-16): tracks the
    per-particle relative energy change since the first call and appends
    the mass-weighted <|dE/E|> to `<runtag>.relx`."""

    is_operator = True

    def __init__(self, runtag="run", outdir=".", nscat=1, primary=True,
                 **kw):
        self.path = os.path.join(outdir, f"{runtag}.relx")
        self.nscat = max(1, int(nscat))
        self.primary = primary   # False: another rank writes the file
        self._e0 = {}            # per-component baselines, keyed by name
        if not primary:
            return
        with open(self.path, "w") as f:
            f.write("# time  component  <|dE/E|>  max|dE/E|" + chr(10))

    def apply(self, ps, dt, istep, time=0.0, name=""):
        if istep % self.nscat or not self.primary:
            return ps
        m = _np(ps.mass)
        live = m > 0
        E = (0.5 * np.sum(_np(ps.v)[live] ** 2, axis=1)
             + _np(ps.pot)[live])
        e0 = self._e0.get(name)
        if e0 is None or e0.shape != E.shape:
            self._e0[name] = E
            return ps
        # magnitude floor on the denominator: unbound particles (E0 > 0)
        # must not divide by the -1e-12 clamp
        rel = np.abs(E - e0) / np.maximum(np.abs(e0), 1e-12)
        w = m[live] / m[live].sum()
        with open(self.path, "a") as f:
            f.write(f"{time:.10g} {name or 'all'} "
                    f"{np.sum(w * rel):.6g} {rel.max():.6g}" + chr(10))
        return ps


@dataclass
class PeriodicBC:
    """Boundary conditions applied after drift (src/PeriodicBC.H:10-19):
    per-axis edge sizes sx/sy/sz and a btype string of 'p' (periodic wrap
    into [0, s)), 'r' (reflect at 0 and s), or 'v' (vacuum — untouched).
    `L` is a shorthand setting sx = sy = sz.  Not a force — a post-drift
    position transform; torch.remainder is a floor-mod, like jnp.mod."""

    L: float = 1.0
    sx: float = None
    sy: float = None
    sz: float = None
    btype: str = "ppp"

    def wrap(self, x):
        sizes = [self.sx or self.L, self.sy or self.L, self.sz or self.L]
        cols = []
        for a in range(3):
            c = x[:, a]
            s = sizes[a]
            b = self.btype[a] if len(self.btype) > a else "p"
            if b == "p":
                c = torch.remainder(c, s)
            elif b == "r":
                # reflect into [0, s): triangle-wave fold of period 2s
                t = torch.remainder(c, 2.0 * s)
                c = torch.where(t > s, 2.0 * s - t, t)
            cols.append(c)
        return torch.stack(cols, dim=-1)


_REGISTRY = {
    "userlogpot": UserLogPot,
    "usermndisk": UserMNdisk,
    "userbar": UserBar,
    "userellipsoid": UserEllipsoid,
    "tidalField": TidalField,
    "usermw": UserMW,
    "userdisk": UserDisk,
    "externalShock": ExternalShock,
}

#: host operators (applied between blocks): ExternalCollection.cc:67-89
#: ScatterMFP and generateRelaxation.  Applied by the single-rate driver
#: loop only (multistep runs integrate ballistically between big steps).
_OPERATORS = {
    "scatterMFP": ScatterMFP,
    "generateRelaxation": GenerateRelaxation,
}


def register_external(name: str, cls):
    """Plugin entry point (replaces the dlopen registry,
    ExternalCollection.cc:194-256)."""
    _REGISTRY[name] = cls


def build_external(conf: dict, workdir=".", dtype=torch.float32,
                   device="cpu"):
    """Factory from a YAML stanza {id: ..., parameters: {...}}; tables on
    `device` (UserHalo in `dtype`, UserDisk in its own float32 default, as
    exp_tpu builds them)."""
    eid = conf.get("id")
    params = dict(conf.get("parameters") or {})
    if eid == "userhalo":
        from exp_tpu_torch.basis.model import SphericalModelTable

        model = SphericalModelTable.from_file(
            os.path.join(workdir, params.pop("modelname")))
        return UserHalo.from_model(model, dtype=dtype, device=device)
    cls = _REGISTRY.get(eid)
    if cls is None:
        raise ValueError(f"unknown external force id {eid!r}; known: "
                         f"{sorted(_REGISTRY) + ['userhalo'] + sorted(_OPERATORS)}")
    if cls is UserDisk:
        params.setdefault("device", device)
    return cls(**params)


def build_operator(conf: dict, runtag="run", outdir=".", seed=None,
                   primary=True):
    """Factory for host operators (scatterMFP, generateRelaxation);
    returns None if the id is not an operator.  `seed` (Global
    random_seed, parse.cc:115-121) is the default RNG seed when the
    operator's own parameters don't pin one; `primary` False on the ranks
    of a world that write no file."""
    cls = _OPERATORS.get(conf.get("id"))
    if cls is None:
        return None
    kw = dict(conf.get("parameters") or {})
    if seed is not None and "seed" not in kw:
        kw["seed"] = int(seed)
    return cls(runtag=runtag, outdir=outdir, primary=primary, **kw)
