"""QPDistF — quadratic-programming distribution-function inversion (port
of exp_tpu/ic/qpdistf.py; exputil/QPDistF.cc, MDW 1991/94).

The DF is a NONNEGATIVE sum of Gaussian kernels on the (E, K) plane,
K = J/Jmax(E) in [0, 1],

    f(E, K) = sum_n x_n g((E - E_n)/sig_E) g((K - K_n)/sig_K),  x_n >= 0,

whose amplitudes are fitted so that the velocity-space integral of f
reproduces the model's density at MGRID mass-quantile radii (scipy's NNLS
on the penalty-augmented system, the reference's QL0001 QP).  The fit is
host NumPy, as in exp_tpu, so the knots, widths and amplitudes are
exp_tpu's.

Evaluation runs on the DF's device as f64 tensors (the card unless the
caller names another device): Jmax(E) is the host cubic spline's
piecewise polynomials evaluated there, and f(E, K) is the kernel sum in
its separable form, sum_ij g_E,i(E) W_ij g_K,j(K) with
W_ij = x_ij / (2 pi sig_E,i sig_K,j), which touches egrid + kgrid
exponentials a point instead of egrid * kgrid.  `sample_qp_model` draws
every random number from NumPy's generator in exp_tpu's order and
evaluates its per-particle envelope and each rejection round's f(E, K)
on that device, so its sample is exp_tpu's: an acceptance test compares a
uniform draw times the envelope with f, and the last-ulp differences of
the two evaluations flip a trial with probability ~1e-16.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from scipy.interpolate import CubicSpline
from scipy.optimize import nnls

from exp_tpu_torch import resolve_device
from exp_tpu_torch.basis.model import SphericalModelTable

F64 = torch.float64

#: envelope grid (each axis of the (vr, vt) quarter disk) and its safety
#: factor, exp_tpu's; the particles an envelope chunk holds (the max is a
#: particle's own, so the chunk does not change a value)
ENV_GRID = 16
ENV_FAC = 1.6
ENV_CHUNK = 32768


def _gauss01(n):
    """Gauss-Legendre nodes/weights on [0, 1] (exputil LegeQuad)."""
    t, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (t + 1.0), 0.5 * w


def _pp_eval(x, c, e):
    """A scipy CubicSpline's piecewise cubic (breakpoints x, coefficients
    c (4, n-1)) at the tensor e, which lies inside [x[0], x[-1]]."""
    i = torch.clamp(torch.searchsorted(x, e.contiguous(), right=True) - 1,
                    0, x.shape[0] - 2)
    d = e - x[i]
    return ((c[0, i] * d + c[1, i]) * d + c[2, i]) * d + c[3, i]


@dataclass
class QPDistF:
    """Fit on construction (host); evaluate with f_EK / distf on `device`
    (None: CUDA, raising when there is none)."""

    model: SphericalModelTable
    rmmax: float | None = None          # outer radius of the density fit
    remax: float | None = None          # outer radius of the energy grid
    egrid: int = 10
    kgrid: int = 6
    mgrid: int = 40
    sigma: float = 2.0                  # kernel width scale
    lam: float = 0.0                    # anisotropy penalty LAMBDA
    alpha: float = 2.0                  # penalty exponent ALPHA
    beta: float = 1.0                   # radial grid stretch BETA
    kmin: float = 0.0
    kmax: float = 1.0
    nint: int = 32                      # velocity quadrature order
    fsige: float = 1.2
    fsigk: float = 2.0
    #: energy knots at linear (reference MassLinear=true) or log mass
    #: quantiles; log is required for cuspy models
    mass_linear: bool = False
    #: 'relative' weights each density row by 1/rho; 'none' is the
    #: reference's unweighted QP
    weighting: str = "relative"
    device: object = None

    # fitted state
    Egrid: np.ndarray = field(init=False)
    Kgrid: np.ndarray = field(init=False)
    sigma_E: np.ndarray = field(init=False)
    sigma_K: np.ndarray = field(init=False)
    X: np.ndarray = field(init=False)
    resid: float = field(init=False)

    def __post_init__(self):
        m = self.model
        self.device = resolve_device(self.device)
        self.rmmax = self.rmmax if self.rmmax is not None else m.rmax
        self.remax = self.remax if self.remax is not None else m.rmax
        self._setup_jmax()
        self._fit()
        self._to_device()

    # -- Jmax(E): circular-orbit angular momentum ----------------------
    def _setup_jmax(self):
        m = self.model
        r = m.r
        dpot = m.get_dpot(r)                       # M(r)/r^2
        Ec = m.get_pot(r) + 0.5 * r * dpot         # energy of circular orbit
        Jc = r * np.sqrt(np.maximum(r * dpot, 0.0))
        keep = np.concatenate([[True], np.diff(Ec) > 0])
        self._emin_c, self._emax_c = float(Ec[keep][0]), float(Ec[keep][-1])
        self._jmax_sp = CubicSpline(Ec[keep], Jc[keep])

    def _jmax_np(self, E):
        E = np.clip(np.asarray(E, float), self._emin_c, self._emax_c)
        return np.maximum(self._jmax_sp(E), 1e-300)

    def _kernel_np(self, E, K):
        """(..., N) kernel matrix at host phase points (the fit's)."""
        E = np.asarray(E)[..., None]
        K = np.asarray(K)[..., None]
        e0 = self.Egrid[:, None].repeat(self.kgrid, 1).ravel()[None]
        k0 = self.Kgrid[None, :].repeat(self.egrid, 0).ravel()[None]
        se = self.sigma_E[:, None].repeat(self.kgrid, 1).ravel()[None]
        sk = self.sigma_K[None, :].repeat(self.egrid, 0).ravel()[None]
        return np.exp(-0.5 * ((E - e0) / se) ** 2
                      - 0.5 * ((K - k0) / sk) ** 2) / (2 * np.pi * se * sk)

    # -- fit (host NumPy, exp_tpu's arithmetic) --------------------------
    def _fit(self):
        m = self.model
        rmin = m.rmin
        Mmax = float(m.get_mass(self.rmmax))
        Mmin = max(float(m.get_mass(rmin)), 1e-6 * Mmax)
        Emin = float(m.get_pot(rmin))
        Emax = float(m.get_pot(self.remax))

        # energy knots at equal mass fractions (QPDistF.cc:280-333)
        if self.mass_linear:
            targets = Mmin + (Mmax - Mmin) * (np.arange(self.egrid) + 0.5) \
                / self.egrid
        else:
            targets = np.exp(np.log(Mmin)
                             + (np.log(Mmax) - np.log(Mmin))
                             * np.arange(self.egrid) / (self.egrid - 1.0))
        mono = np.maximum.accumulate(m.mass)
        keepM = np.concatenate([[True], np.diff(mono) > 0])
        Minterp = CubicSpline(mono[keepM], np.log(m.r[keepM]))
        r_of_M = np.exp(Minterp(np.clip(targets, mono[keepM][0],
                                        mono[keepM][-1])))
        self.Egrid = np.asarray(m.get_pot(r_of_M), float)
        dE = np.diff(self.Egrid, prepend=self.Egrid[0])
        dE[0] = 2.0 * (self.Egrid[0] - Emin)       # QPDistF.cc:326-330
        self.sigma_E = self.sigma * np.maximum(dE, 1e-12) * self.fsige

        dK = (self.kmax - self.kmin) / self.kgrid
        self.Kgrid = self.kmin + dK * (np.arange(self.kgrid) + 1.0 - 0.5)
        self.sigma_K = np.full(self.kgrid, self.sigma * dK * self.fsigk)

        # radial grid at stretched mass quantiles (QPDistF.cc:352-362)
        if self.mass_linear:
            Mtot = Mmax - Mmin
            q = (Mtot * ((np.arange(self.mgrid) + 0.5) / self.mgrid)
                 ** self.beta) + Mmin
        else:
            q = np.exp(np.log(Mmin) + (np.log(Mmax) - np.log(Mmin))
                       * (np.arange(self.mgrid) + 0.5) / self.mgrid)
        Rgrid = np.exp(Minterp(np.clip(q, mono[keepM][0],
                                       mono[keepM][-1])))
        Dgrid = np.asarray(m.get_density(Rgrid), float)

        # B[k, n]: velocity-space integral of each kernel at R_k (dof=3
        # branch, QPDistF.cc:430-460)
        xq, wx = _gauss01(self.nint)
        yq, wy = _gauss01(self.nint)
        Xg, Yg = np.meshgrid(xq, yq, indexing="ij")
        Wg = np.outer(wx, wy)
        pot_k = np.asarray(m.get_pot(Rgrid), float)
        B = np.empty((self.mgrid, self.egrid * self.kgrid))
        for k in range(self.mgrid):
            vmax2 = 2.0 * (Emax - pot_k[k])
            if vmax2 <= 0:
                B[k] = 0.0
                continue
            vmax = np.sqrt(vmax2)
            E = pot_k[k] + 0.5 * vmax2 * (Xg ** 2 + (1 - Xg ** 2) * Yg ** 2)
            J = vmax * np.sqrt(1 - Xg ** 2) * Yg * Rgrid[k]
            K = J / self._jmax_np(E)
            fac = Wg * 4.0 * np.pi * vmax ** 3 * (1 - Xg ** 2) * Yg
            B[k] = np.einsum("xy,xyn->n", fac,
                             self._kernel_np(E, np.minimum(K, self.kmax)))

        # penalty-augmented NNLS == the reference's QP
        w = 1.0 / Dgrid if self.weighting == "relative" else \
            np.ones_like(Dgrid)
        Bw = B * w[:, None]
        rw = Dgrid * w
        if self.lam > 1e-20:
            u = np.tile(self.Kgrid ** self.alpha, self.egrid)
            Bw = np.vstack([Bw, np.sqrt(self.lam) * u[None]])
            rw = np.concatenate([rw, [0.0]])
        self.X, rnorm = nnls(Bw, rw)
        self.resid = float(np.max(np.abs(B @ self.X - Dgrid) / Dgrid)) \
            if self.weighting == "relative" else \
            float(np.linalg.norm(B @ self.X - Dgrid)
                  / np.linalg.norm(Dgrid))
        self._B, self._Rgrid, self._Dgrid = B, Rgrid, Dgrid
        self._Emax = Emax

    def _to_device(self):
        """The evaluation's tables as f64 tensors on the DF's device."""
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=F64,
                                   device=self.device)

        sp = self._jmax_sp
        self._jx, self._jc = t(sp.x), t(sp.c)
        self._e0, self._k0 = t(self.Egrid), t(self.Kgrid)
        self._se, self._sk = t(self.sigma_E), t(self.sigma_K)
        self._W = t(self.X.reshape(self.egrid, self.kgrid)
                    / (2.0 * np.pi * self.sigma_E[:, None]
                       * self.sigma_K[None, :]))

    # -- evaluation on the device ---------------------------------------
    def _t(self, a):
        return torch.as_tensor(a, dtype=F64, device=self.device)

    def jmax_t(self, E):
        """Jmax(E) of a tensor on the DF's device."""
        E = torch.clamp(E, self._emin_c, self._emax_c)
        return torch.clamp(_pp_eval(self._jx, self._jc, E), min=1e-300)

    def f_EK_t(self, E, K):
        """f(E, K) of tensors on the DF's device (separable kernel sum)."""
        gE = torch.exp(-0.5 * ((E[..., None] - self._e0) / self._se) ** 2)
        gK = torch.exp(-0.5 * ((K[..., None] - self._k0) / self._sk) ** 2)
        return torch.sum((gE @ self._W) * gK, dim=-1)

    def _host_or_t(self, fn, *args):
        if isinstance(args[0], torch.Tensor):
            return fn(*(self._t(a) for a in args))
        return fn(*(self._t(np.asarray(a, float)) for a in args)
                  ).cpu().numpy()

    def jmax(self, E):
        """Jmax(E): a tensor for a tensor, NumPy for NumPy."""
        return self._host_or_t(self.jmax_t, E)

    def f_EK(self, E, K):
        """DF at (E, K) (QPDistF::distf_EK)."""
        return self._host_or_t(self.f_EK_t, E, K)

    def distf(self, E, J):
        """DF at (E, J) (QPDistF::distf)."""
        return self._host_or_t(
            lambda e, j: self.f_EK_t(e, j / self.jmax_t(e)), E, J)

    def density(self, r):
        """Velocity-space integral of the fitted DF (for validation)."""
        m = self.model
        r = np.atleast_1d(np.asarray(r, float))
        xq, wx = _gauss01(self.nint)
        yq, wy = _gauss01(self.nint)
        Xg, Yg = np.meshgrid(xq, yq, indexing="ij")
        Wg = np.outer(wx, wy)
        out = np.empty(len(r))
        for k, rk in enumerate(r):
            pot = float(m.get_pot(rk))
            vmax2 = 2.0 * (self._Emax - pot)
            if vmax2 <= 0:
                out[k] = 0.0
                continue
            vmax = np.sqrt(vmax2)
            E = pot + 0.5 * vmax2 * (Xg ** 2 + (1 - Xg ** 2) * Yg ** 2)
            J = vmax * np.sqrt(1 - Xg ** 2) * Yg * rk
            K = J / self.jmax(E)
            fac = Wg * 4.0 * np.pi * vmax ** 3 * (1 - Xg ** 2) * Yg
            out[k] = np.sum(fac * self.f_EK(E, np.minimum(K, self.kmax)))
        return out


def _envelope(df, r, pot_r, vmax):
    """ENV_FAC times the max of vt f(E, K) over an ENV_GRID^2 grid of the
    (vr, vt) quarter disk, a particle at a time, on the DF's device in
    chunks of ENV_CHUNK particles."""
    g = torch.linspace(0, 1, ENV_GRID, dtype=F64, device=df.device)
    VG, TG = torch.meshgrid(g, g, indexing="ij")
    q2 = VG ** 2 + TG ** 2
    env = torch.empty(len(r), dtype=F64, device=df.device)
    rt, pt, vt = df._t(r), df._t(pot_r), df._t(vmax)
    for i in range(0, len(r), ENV_CHUNK):
        rr = rt[i:i + ENV_CHUNK, None, None]
        pr = pt[i:i + ENV_CHUNK, None, None]
        vm = vt[i:i + ENV_CHUNK, None, None]
        E = pr + 0.5 * q2[None] * vm ** 2
        K = TG[None] * vm * rr / df.jmax_t(E)
        p = TG[None] * vm * df.f_EK_t(E, torch.clamp(K, 0.0, df.kmax))
        env[i:i + ENV_CHUNK] = ENV_FAC * p.reshape(len(rr), -1).amax(
            dim=1) + 1e-300
    return env.cpu().numpy()


def sample_qp_model(model: SphericalModelTable, n: int, seed: int = 0,
                    zero_com: bool = True, df: QPDistF | None = None,
                    device=None, **qp_kwargs):
    """Equilibrium realization from the QP-fitted DF (gensph --qp): returns
    (x, v, mass) NumPy arrays.

    Positions from the model mass profile; velocities by rejection from
    p(vr, vt) ~ vt f(E, K) at each radius.  The DF (`df`, else fitted here
    on `device`, None: CUDA, raising when there is none) evaluates the
    envelope and the rejection rounds on its device; the draws are NumPy's,
    in exp_tpu's order."""
    rng = np.random.default_rng(seed)
    df = df if df is not None else QPDistF(model, device=device,
                                           **qp_kwargs)
    m = model

    Mr = m.mass / m.total_mass
    keep = np.concatenate([[True], np.diff(Mr) > 0])
    inv_r = CubicSpline(Mr[keep], np.log(m.r[keep]))
    u = rng.uniform(Mr[keep][0], Mr[keep][-1], size=n)
    r = np.exp(inv_r(u))
    pot_r = np.asarray(m.get_pot(r), float)
    vmax = np.sqrt(np.maximum(2.0 * (df._Emax - pot_r), 0.0))

    vr = np.empty(n)
    vt = np.empty(n)
    env_all = _envelope(df, r, pot_r, vmax)
    todo = np.arange(n)
    while todo.size:
        rr, pr, vm = r[todo], pot_r[todo], vmax[todo]
        a1 = rng.uniform(-1, 1, todo.size) * vm
        a2 = rng.uniform(0, 1, todo.size) * vm
        E = pr + 0.5 * (a1 ** 2 + a2 ** 2)
        ok_E = E < df._Emax
        Et, a2t = df._t(E), df._t(a2)
        K = torch.where(torch.as_tensor(ok_E, device=df.device), a2t * df._t(rr) / df.jmax_t(Et),
                        torch.zeros_like(Et))
        pv = (a2t * df.f_EK_t(Et, torch.clamp(K, 0.0, df.kmax))).cpu().numpy()
        y = rng.uniform(0, 1, todo.size) * env_all[todo]
        ok = (y <= pv) & ok_E
        vr[todo[ok]] = a1[ok]
        vt[todo[ok]] = a2[ok]
        todo = todo[~ok]

    ct = rng.uniform(-1, 1, n)
    st = np.sqrt(1 - ct * ct)
    ph = rng.uniform(0, 2 * np.pi, n)
    rhat = np.stack([st * np.cos(ph), st * np.sin(ph), ct], -1)
    x = r[:, None] * rhat
    tmp = rng.standard_normal((n, 3))
    that = tmp - np.sum(tmp * rhat, 1, keepdims=True) * rhat
    that /= np.maximum(np.linalg.norm(that, axis=1, keepdims=True), 1e-12)
    v = vr[:, None] * rhat + vt[:, None] * that
    mass = np.full(n, m.total_mass / n)
    if zero_com:
        x -= x.mean(axis=0)
        v -= v.mean(axis=0)
    return x, v, mass
