"""pyEXP.util compatibility (port of exp_tpu/pyexp/util.py; reference
pyEXP/UtilWrappers.cc).  Host NumPy; KDdensity builds a scipy cKDTree."""

from __future__ import annotations

import numpy as np

from exp_tpu_torch.analysis import util as _u


def _particles(reader_or_x, mass=None):
    if hasattr(reader_or_x, "Particles"):
        m, x, _ = reader_or_x.Particles()
        return np.asarray(x), np.asarray(m)
    return np.asarray(reader_or_x), mass


def getDensityCenter(reader, stride=1, Nsort=0, Ndens=32):
    """KD-density-weighted center (expui/Centering.cc getDensityCenter);
    accepts a ParticleReader or a position array.  Positional order
    matches the reference binding: (reader, stride, Nsort, Ndens)."""
    x, m = _particles(reader)
    if stride and stride > 1:
        x = x[::stride]
        m = None if m is None else m[::stride]
    return np.asarray(_u.getDensityCenter(x, m, k=max(2, int(Ndens)),
                                          Nsort=int(Nsort)))


def getCenterOfMass(reader):
    x, m = _particles(reader)
    return np.asarray(_u.centerOfMass(x, m))


# snake-case alias kept for the native API
centerOfMass = getCenterOfMass


def particleIterator(reader, func):
    """Apply `func(mass, x, y, z, vx, vy, vz, index)` over the reader's
    particles (UtilWrappers particleIterator)."""
    m, x, v = reader.Particles()
    for i in range(len(m)):
        func(m[i], x[i, 0], x[i, 1], x[i, 2], v[i, 0], v[i, 1], v[i, 2], i)


class KDdensity:
    """k-d-tree kNN density estimator for a particle set
    (expui/KDdensity.H; UtilWrappers.cc:248).  Accepts a ParticleReader
    or a position array; `Ndens` is the kNN count."""

    def __init__(self, reader, Ndens: int = 32):
        from scipy.spatial import cKDTree

        x, m = _particles(reader)
        self._x = np.asarray(x, np.float64)
        self._m = (np.ones(len(self._x)) if m is None
                   else np.asarray(m, np.float64))
        self._k = max(2, min(int(Ndens), len(self._x) - 1))
        self._tree = cKDTree(self._x)

    def _rho(self, pts, self_query=False):
        k = self._k + (1 if self_query else 0)
        d, idx = self._tree.query(np.atleast_2d(pts), k=k)
        rk = d[:, -1]
        vol = 4.0 / 3.0 * np.pi * np.maximum(rk, 1e-30) ** 3
        # kNN mass density: sum of the k neighbor masses over the ball
        msum = self._m[idx[:, (1 if self_query else 0):]].sum(axis=1)
        return msum / vol

    def getDensityAtPoint(self, x, y=None, z=None):
        """Density estimate at (x, y, z), a position list, or an (N, 3)
        array (returns an array for multiple points)."""
        p = np.atleast_2d(np.asarray(x, np.float64)) if y is None \
            else np.array([[x, y, z]], np.float64)
        rho = self._rho(p.reshape(-1, 3))
        return float(rho[0]) if rho.shape[0] == 1 else rho

    def getDensityByIndex(self, i):
        """Density estimate at particle index i (excluding the particle
        itself from its neighbor ball)."""
        return float(self._rho(self._x[int(i)].reshape(1, 3),
                               self_query=True)[0])


def getVersionInfo():
    return _u.getVersionInfo()


def Version():
    return getVersionInfo()


def setMPI(flag: bool = True):
    """No-op: the analysis runs in one process on one device, with no
    per-process MPI toggle (the reference uses this to enable MPI
    reductions inside pyEXP)."""
    return None
