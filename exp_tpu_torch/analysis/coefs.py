"""Time-keyed coefficient containers (port of exp_tpu/analysis/coefs.py, a
host-side NumPy copy; pyEXP `coefs` submodule).

The analogue of expui Coefficients.cc's Coefs family (SphCoefs/CylCoefs/
CubeCoefs, expui/Coefficients.H:294-578): an in-memory time series of
coefficient arrays with HDF5 round-trip (io/coefs.py implements the
pyEXP-compatible schema), time interpolation, and power diagnostics.
"""

from __future__ import annotations

import numpy as np


class Coefs:
    """Time series of coefficient arrays for one component."""

    def __init__(self, geometry="sphere", name="", meta=None):
        self.geometry = geometry
        self.name = name
        self.meta = dict(meta or {})
        self._data: dict[float, np.ndarray] = {}

    # -- construction -------------------------------------------------------

    def add(self, time: float, coef):
        self._data[float(time)] = np.asarray(coef)

    @classmethod
    def from_file(cls, path) -> "Coefs":
        """Read a coefficient file — HDF5 or EXP native binary (the
        reference's Coefs::factory sniffs the same way)."""
        from exp_tpu_torch.io.coefs import open_coefs, _attr_str

        with open(path, "rb") as fh:
            if fh.read(4) != b"\x89HDF":
                from exp_tpu_torch.io.coefs import read_native_coefs

                geom, times, arrs, meta = read_native_coefs(path)
                out = cls(geometry=geom,
                          name=str(meta.get("forceID", "")), meta=meta)
                for t, c in zip(times, arrs):
                    out.add(float(t), c)
                return out

        f = open_coefs(path)
        times, coefs = f.read_all()
        meta = {}
        for k in ("lmax", "nmax", "mmax", "nmaxx", "nmaxy", "nmaxz", "scale"):
            if hasattr(f, k):
                meta[k] = getattr(f, k)
        out = cls(geometry=f.geometry,
                  name=_attr_str(f._f.attrs.get("name", "")), meta=meta)
        for t, c in zip(times, coefs):
            out.add(t, c)
        f.close()
        return out

    def to_file(self, path):
        from exp_tpu_torch.io import coefs as iocoefs

        # geometry dims: prefer the meta attrs, else derive from the
        # stored arrays (a container built purely via add() carries no
        # meta — writing 0 dims would corrupt the file header)
        a = self._data[self.times()[0]] if self._data else None

        def dim(key, derive):
            v = int(self.meta.get(key, 0))
            if v == 0 and a is not None:
                v = int(derive(a))
            return v

        if self.geometry == "sphere":
            f = iocoefs.SphCoefsFile(path, "w", name=self.name,
                                     lmax=dim("lmax",
                                              lambda c: c.shape[1] - 1),
                                     nmax=dim("nmax",
                                              lambda c: c.shape[-1]),
                                     scale=float(self.meta.get("scale", 1.0)))
        elif self.geometry == "cylinder":
            f = iocoefs.CylCoefsFile(path, "w", name=self.name,
                                     mmax=dim("mmax",
                                              lambda c: c.shape[1] - 1),
                                     nmax=dim("nmax",
                                              lambda c: c.shape[-1]))
        elif self.geometry == "cube":
            f = iocoefs.CubeCoefsFile(path, "w", name=self.name,
                                      nmaxx=dim("nmaxx",
                                                lambda c: (c.shape[0] - 1)
                                                // 2),
                                      nmaxy=dim("nmaxy",
                                                lambda c: (c.shape[1] - 1)
                                                // 2),
                                      nmaxz=dim("nmaxz",
                                                lambda c: (c.shape[2] - 1)
                                                // 2))
        elif self.geometry == "slab":
            f = iocoefs.SlabCoefsFile(path, "w", name=self.name,
                                      nmaxx=dim("nmaxx",
                                                lambda c: (c.shape[0] - 1)
                                                // 2),
                                      nmaxy=dim("nmaxy",
                                                lambda c: (c.shape[1] - 1)
                                                // 2),
                                      nmaxz=dim("nmaxz",
                                                lambda c: c.shape[2]))
        else:
            raise ValueError(f"unknown geometry {self.geometry}")
        for t in self.times():
            f.append(t, self._data[t])
        f.close()

    # -- access --------------------------------------------------------------

    def times(self):
        return sorted(self._data)

    def __call__(self, time):
        return self.getCoefStruct(time)

    def getCoefStruct(self, time):
        """Coefficient array at `time` (nearest stored time)."""
        ts = self.times()
        i = int(np.argmin(np.abs(np.asarray(ts) - time)))
        return self._data[ts[i]]

    def interpolate(self, time):
        ts = np.asarray(self.times())
        if time <= ts[0]:
            return self._data[ts[0]]
        if time >= ts[-1]:
            return self._data[ts[-1]]
        j = int(np.searchsorted(ts, time))
        t0, t1 = ts[j - 1], ts[j]
        w = (time - t0) / (t1 - t0)
        return (1 - w) * self._data[t0] + w * self._data[t1]

    def as_array(self):
        """Stacked (T, ...) array in time order."""
        return np.stack([self._data[t] for t in self.times()])

    def deepcopy(self):
        out = Coefs(self.geometry, self.name, self.meta)
        for t, c in self._data.items():
            out.add(t, c.copy())
        return out

    def zerodata(self):
        for t in list(self._data):
            self._data[t] = np.zeros_like(self._data[t])

    # -- diagnostics ---------------------------------------------------------

    def power(self, axis="l"):
        """Power in coefficients vs time (SphCoefs::Power analogue).

        For 'sphere': returns (T, lmax+1) summing |a|^2 over m, n per l
        (or per-m with axis='m').  For other geometries: total power (T,).
        """
        A = self.as_array()
        if self.geometry == "sphere" and A.ndim == 5:
            if axis == "m":
                return np.einsum("tclmn->tm", A**2)
            return np.einsum("tclmn->tl", A**2)
        flat = A.reshape(A.shape[0], -1)
        return np.sum(np.abs(flat) ** 2, axis=1)
