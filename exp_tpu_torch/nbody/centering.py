"""Expansion-center tracking (port of exp_tpu/nbody/centering.py; the
reference's Orient/EJ machinery).

The analogue of src/Orient.cc + cudaOrient.cu: keep the K most-bound
particles (by E = pot + v^2/2 — the EL3 set, Orient.H:19-57), estimate the
expansion center as their mass-weighted centroid, and smooth the estimate
over a sliding window (the reference's boxcar + least-squares regression).
The center is a slowly-varying host-side parameter fed back into the step.

The top-K selection is torch.topk on -(E) on the particles' device; only
the centroid and the angular-momentum vector, six numbers, come to the
host on each update.  The regressions stay NumPy float64, as in exp_tpu.

PseudoAccel (include/PseudoAccel.H; Component::getPseudoAccel,
Component.cc:4407-4425): when a component is declared to live in its
moving/rotating expansion frame (`nEJaccel > 0`), the reference estimates
the frame acceleration by a quadratic least-squares fit over the last
Naccel tracked centers (accel = 2a of a t^2 + b t + c, per axis) plus the
axis angular velocity omega = n x dn/dt and its derivative, and subtracts
accel + 2 omega x v + domega/dt x r + omega x (omega x r) from every
self-gravity acceleration (Component.H:913-921 AddAcc — externals,
AddAccExt, are NOT corrected).  The port integrates inertial coordinates
by default (the tracked center only offsets the expansion origin), so the
correction is the same opt-in: PseudoAccel below is fed by EJOrient
updates or prescribed CenterFile samples and its output is subtracted in
the step's force assembly.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch


def _most_bound_centroid(x, v, mass, pot, k: int = 256, world=None):
    """Mass-weighted centroid c and angular momentum L (about c) of the k
    most bound live rows, as (3,) tensors on the particles' device.  On a
    World of several ranks the set is the global top k: each rank's own k
    most bound rows are gathered, and the k most bound of those taken."""
    E = pot + 0.5 * torch.sum(v * v, dim=-1)
    # exclude padding (mass == 0) by pushing it to the end of the ranking
    E = torch.where(mass > 0, E, torch.full_like(E, float("inf")))
    kk = min(k, x.shape[0])
    idx = torch.topk(-E, kk).indices
    if world is not None and world.size > 1:
        from exp_tpu_torch.parallel.distributed import allgather_rows

        cand, _ = allgather_rows(torch.cat([
            E[idx, None], x[idx], v[idx], mass[idx, None]], dim=1), world)
        E, x, v, mass = cand[:, 0], cand[:, 1:4], cand[:, 4:7], cand[:, 7]
        idx = torch.topk(-E, min(k, cand.shape[0])).indices
    w = mass[idx]
    xi = x[idx]
    c = torch.sum(xi * w[:, None], dim=0) / torch.clamp(torch.sum(w),
                                                        min=1e-30)
    # principal axis of the bound set (angular momentum direction), the
    # Orient axis analogue
    L = torch.sum(w[:, None] * torch.linalg.cross(xi - c, v[idx]), dim=0)
    return c, L


def euler_slater(phi, theta, psi=0.0, body=False):
    """The reference's Euler matrix (exputil/euler_slater.cc:46): maps
    inertial coordinates into the frame whose z-axis is the tracked axis
    (body=False); body=True returns the inverse (transpose)."""
    sph, cph = np.sin(phi), np.cos(phi)
    sth, cth = np.sin(theta), np.cos(theta)
    sps, cps = np.sin(psi), np.cos(psi)
    e = np.array([
        [-sps * sph + cth * cph * cps, sps * cph + cth * sph * cps,
         cps * sth],
        [-cps * sph - cth * cph * sps, cps * cph - cth * sph * sps,
         -sps * sth],
        [-sth * cph, -sth * sph, cth]])
    return e.T if body else e


def _axis_to_body(axis):
    """body/orig rotation pair from an axis vector (Orient.cc:327-335:
    phi = atan2(ay, ax), theta = -acos(az/|a|), psi = 0)."""
    a = np.asarray(axis, np.float64)
    nrm = np.linalg.norm(a)
    if nrm <= 0:
        return np.eye(3), np.eye(3)
    phi = np.arctan2(a[1], a[0])
    theta = -np.arccos(np.clip(a[2] / nrm, -1.0, 1.0))
    body = euler_slater(phi, theta, 0.0, body=False)
    return body, body.T


def _regress(hist, time, damp):
    """Least-squares linear regression of a (t, vec) series, evaluated at
    damp*time + (1-damp)*t_front (Orient.cc:577-602)."""
    ts = np.array([t for t, _ in hist])
    ys = np.array([y for _, y in hist])
    N = len(ts)
    sumX = ts.sum()
    sumX2 = (ts * ts).sum()
    sumY = ys.sum(axis=0)
    sumXY = (ys * ts[:, None]).sum(axis=0)
    den = sumX2 * N - sumX * sumX
    if abs(den) < 1e-30:
        return ys.mean(axis=0), 0.0
    slope = (sumXY * N - sumX * sumY) / den
    intercept = (sumX2 * sumY - sumX * sumXY) / den
    est = intercept + slope * (damp * time + (1.0 - damp) * ts[0])
    resid = ys - intercept[None] - slope[None] * ts[:, None]
    sig = float((resid * resid).sum() / N)
    return est, sig


def _quadfit(ts, ys):
    """Ascending quadratic coefficients (c0, c1, c2) of a least-squares
    fit ys ~ c0 + c1 t + c2 t^2.  np.polynomial.Polynomial.fit scales the
    abscissa to [-1, 1] internally, so the Vandermonde stays conditioned
    at any dt (a raw np.polyfit on a small-dt window warns RankWarning)."""
    p = np.polynomial.Polynomial.fit(ts, ys, 2).convert()
    c = p.coef
    return np.pad(c, (0, 3 - len(c))) if len(c) < 3 else c


@dataclass
class PseudoAccel:
    """Frame-acceleration estimator (include/PseudoAccel.H:10-95).

    Keeps the last `nsize` (t, center, axis) samples; when the queue is
    full, the frame acceleration is 2x the quadratic coefficient of a
    least-squares fit a t^2 + b t + c per axis (QuadLS), and the axis
    terms give omega = n x dn/dt and domega/dt = n x d2n/dt2 evaluated
    at the newest sample time.  `center`/`axis` gate which pieces are
    active (Orient::CENTER / Orient::AXIS, mirrored from the EJ
    bitmask)."""

    nsize: int = 8
    center: bool = True
    axis: bool = False
    _queue: deque = field(default_factory=deque)

    def add(self, t, c, a=None):
        rec = (float(t), np.asarray(c, np.float64),
               None if a is None else np.asarray(a, np.float64))
        # one sample per time: a repeated t (the center refresh can run
        # more than once per step) replaces the newest sample instead of
        # stacking duplicates, which would make the quadratic fit
        # rank-deficient (distinct abscissae < 3)
        if self._queue and self._queue[-1][0] == rec[0]:
            self._queue[-1] = rec
            return
        self._queue.append(rec)
        while len(self._queue) > self.nsize:
            self._queue.popleft()

    def __call__(self):
        """-> (accel, omega, domdt), each (3,) float64 (zeros until the
        sample window fills, PseudoAccel.H:64-66)."""
        accel = np.zeros(3)
        omega = np.zeros(3)
        domdt = np.zeros(3)
        if len(self._queue) < self.nsize or self.nsize < 3:
            return accel, omega, domdt
        # shift times to their mean: the quadratic coefficient (and the
        # evaluation at the newest sample) are shift-invariant, and the
        # Vandermonde fit stays well-conditioned for t >> window
        ts = np.array([q[0] for q in self._queue])
        ts = ts - ts.mean()
        if self.center:
            cs = np.array([q[1] for q in self._queue])
            for k in range(3):
                accel[k] = 2.0 * _quadfit(ts, cs[:, k])[2]
        if self.axis and all(q[2] is not None for q in self._queue):
            axs = np.array([q[2] for q in self._queue])
            T = ts[-1]
            n = np.zeros(3); dndt = np.zeros(3); d2 = np.zeros(3)
            for k in range(3):
                _c, b, a = _quadfit(ts, axs[:, k])
                n[k] = a * T * T + b * T + _c
                dndt[k] = 2.0 * a * T + b
                d2[k] = 2.0 * a
            omega = np.cross(n, dndt)
            domdt = np.cross(n, d2)
        return accel, omega, domdt


@dataclass
class EJOrient:
    """EJ center/axis tracker with the reference's sliding-window
    least-squares regression (src/Orient.cc:560-680): per update, the
    most-bound-set centroid (center1) and angular-momentum direction
    (axis1) enter (t, value) deques; the reported center/axis are the
    regression evaluated at damp*t + (1-damp)*t_front.  `body`/`orig`
    are the Euler rotations into/out of the axis frame, applied to
    cylinder components when the AXIS flag is set (Cylinder.cc:800,1419).
    """

    nkeep: int = 256
    window: int = 16
    damp: float = 1.0
    logfile: str | None = None
    #: multi-process: only the primary process appends to the log (the
    #: reference writes on myid==0, Orient.cc); the tracker state itself
    #: must still update identically on every process
    write_log: bool = True
    #: optional frame-acceleration estimator fed the raw per-update
    #: center1/axis1 samples (Orient.cc:696-697)
    pseudo: "PseudoAccel | None" = None
    _histC: deque = field(default_factory=deque)
    _histA: deque = field(default_factory=deque)
    center: np.ndarray = field(default_factory=lambda: np.zeros(3))
    axis: np.ndarray = field(default_factory=lambda: np.array([0.0, 0, 1]))
    body: np.ndarray = field(default_factory=lambda: np.eye(3))
    orig: np.ndarray = field(default_factory=lambda: np.eye(3))
    sigC: float = 0.0
    sigA: float = 0.0
    _log_started: bool = False

    def update(self, ps, time=0.0, world=None) -> np.ndarray:
        c, L = _most_bound_centroid(ps.x, ps.v, ps.mass, ps.pot,
                                    k=self.nkeep, world=world)
        # one device-to-host transfer of the six numbers
        cl = torch.cat([c, L]).detach().cpu().numpy().astype(np.float64)
        c1, L1 = cl[:3].copy(), cl[3:].copy()
        nrm = np.linalg.norm(L1)
        a1 = L1 / nrm if nrm > 0 else np.array(self.axis)
        self._push(time, c1, a1)
        if self.pseudo is not None:
            self.pseudo.add(time, c1, a1)
        self._refresh(time)
        self._log(time, c1, a1)
        return self.center

    def _push(self, time, c1, a1):
        self._histC.append((float(time), c1))
        self._histA.append((float(time), a1))
        while len(self._histC) > self.window:
            self._histC.popleft()
        while len(self._histA) > self.window:
            self._histA.popleft()

    def _refresh(self, time):
        if len(self._histC) >= 2:
            self.center, self.sigC = _regress(self._histC, time, self.damp)
        else:
            self.center = self._histC[-1][1]
        if len(self._histA) >= 2:
            axis, self.sigA = _regress(self._histA, time, self.damp)
        else:
            axis = self._histA[-1][1]
        nrm = np.linalg.norm(axis)
        if nrm > 0:
            self.axis = axis / nrm
            self.body, self.orig = _axis_to_body(self.axis)

    # -- orient log (Orient.H:60-87 column layout, restart Orient.cc:86) --

    def _log(self, time, c1, a1):
        if not self.logfile or not self.write_log:
            return
        import os

        if not self._log_started:
            self._log_started = True
            if os.path.exists(self.logfile):
                os.replace(self.logfile, self.logfile + ".bak")
            with open(self.logfile, "w") as f:
                f.write("# time | axis(reg) x y z | axis(cur) x y z | "
                        "center(reg) x y z | center(cur) x y z | "
                        "sigA sigC\n")
        with open(self.logfile, "a") as f:
            row = ([time] + list(self.axis) + list(a1)
                   + list(self.center) + list(c1) + [self.sigA, self.sigC])
            f.write(" ".join(f"{v:.12e}" for v in row) + "\n")

    def load_log(self, path=None):
        """Restart: refill the regression deques from an orient log
        (the reference reads its logfile back, Orient.cc:86-188)."""
        path = path or self.logfile
        a = np.loadtxt(path, ndmin=2)
        if a.size == 0:
            return
        for row in a[-self.window:]:
            self._push(row[0], row[10:13].copy(), row[4:7].copy())
        self._refresh(float(a[-1, 0]))
        self._log_started = False   # fresh section on next write
        return self


class CenterFile:
    """Prescribed expansion-center trajectory from a file
    (the reference's CenterFile, src/CenterFile.cc; Component `centerfile`
    option): columns `t x y z`, linearly interpolated in time."""

    def __init__(self, path):
        a = np.loadtxt(path, ndmin=2)
        if a.shape[1] < 4:
            raise ValueError(f"centerfile {path}: need columns t x y z")
        order = np.argsort(a[:, 0])
        self.t = a[order, 0]
        self.xyz = a[order, 1:4]

    def __call__(self, t):
        return np.array([np.interp(t, self.t, self.xyz[:, k])
                         for k in range(3)])
