"""pyEXP.coefs compatibility (port of exp_tpu/pyexp/coefs.py; reference
pyEXP/CoefWrappers.cc).

CoefStruct (single-time blob, expui/CoefStruct.H:116-489) and the
time-keyed Coefs container with the reference method names, delegating
to exp_tpu_torch.analysis.coefs / exp_tpu_torch.io.coefs for storage and
HDF5 (host NumPy; the HDF5 calls need h5py).
"""

from __future__ import annotations

import copy as _copy

import numpy as np

from exp_tpu_torch.analysis.coefs import Coefs as _NativeCoefs


def _pack_complex(geometry, a):
    """Native real layout -> the reference's packed complex layout
    (sphere (l(l+1)/2+m, nmax), cylinder (mmax+1, nmax)); other
    geometries return a copy of the native array."""
    from exp_tpu_torch.io.coefs import pack_sph_matrix

    if geometry == "sphere" and a.ndim == 4:
        return pack_sph_matrix(a)
    if geometry == "cylinder" and a.ndim == 3:
        return a[0] + 1j * a[1]
    return np.array(a)


def _complex_to_native(geometry, arr, shape):
    """Packed complex layout -> native real layout with shape `shape`,
    validating the packed dimensions against the target orders."""
    arr = np.asarray(arr)
    if geometry == "sphere":
        from exp_tpu_torch.io.coefs import unpack_sph_matrix

        lmax, nmax = shape[1] - 1, shape[-1]
        rows = (lmax + 1) * (lmax + 2) // 2
        if arr.size != rows * nmax:
            raise ValueError(
                f"packed sphere data has {arr.size} elements; expected "
                f"({rows}, {nmax}) for lmax={lmax}, nmax={nmax}")
        return unpack_sph_matrix(arr.reshape(rows, nmax), lmax, nmax)
    if geometry == "cylinder":
        if arr.size != np.prod(shape[1:]):
            raise ValueError(
                f"packed cylinder data has {arr.size} elements; expected "
                f"{tuple(shape[1:])}")
        arr = arr.reshape(shape[1:])
        return np.stack([arr.real, arr.imag])
    raise ValueError(f"complex packed data undefined for {geometry!r}")


class CoefStruct:
    """Single-time coefficient blob (CoefStruct.H:116).

    Attributes: geometry, coefs (ndarray), time, center, rotation, name.
    The setters/getters mirror the pybind11 surface."""

    def __init__(self, geometry, coefs, time=0.0, center=None, name="",
                 meta=None, rotation=None):
        self.geometry = str(geometry)
        self.coefs = np.asarray(coefs)
        self.time = float(time)
        self.center = (np.zeros(3) if center is None
                       else np.asarray(center, float))
        self.rotation = (np.eye(3) if rotation is None
                         else np.asarray(rotation, float))
        self.name = name
        self.meta = dict(meta or {})

    # reference surface
    def getCoefTime(self):
        return self.time

    def setCoefTime(self, t):
        self.time = float(t)

    def getCoefCenter(self):
        return self.center

    def setCoefCenter(self, c):
        self.center = np.asarray(c, float)

    def getCoefRotation(self):
        return self.rotation

    def setCoefRotation(self, R):
        self.rotation = np.asarray(R, float)

    def getCoefs(self):
        return self.coefs

    def setCoefs(self, mat):
        self.coefs = np.asarray(mat)

    # aliases used in reference scripts
    getMatrix = getCoefs
    setMatrix = setCoefs
    getTensor = getCoefs
    setTensor = setCoefs
    getData = getCoefs
    setData = setCoefs

    def getGeometry(self):
        return self.geometry

    def deepcopy(self):
        return _copy.deepcopy(self)

    def zerodata(self):
        self.coefs = np.zeros_like(self.coefs)

    def create(self):
        """No-op (the reference allocates storage here); kept for script
        compatibility."""
        return self

    def assign(self, mat, *dims):
        """Assign a coefficient matrix (CoefWrappers.cc:961 SphStruct/
        CylStruct::assign): `dims` are the angular/radial orders — e.g.
        (lmax, nmax) sphere, (mmax, nmax) cylinder — checked against both
        the data size and this struct's storage.  Like the reference,
        accepts the packed complex layout for sphere/cylinder structs
        (CoefStruct.H:158/204 take Eigen::MatrixXcd) or the native real
        layout.  Writes IN PLACE so a struct obtained from a Coefs
        container edits the container's stored data too (the reference
        structs share storage with their container)."""
        mat = np.asarray(mat)
        if dims:
            nmax = int(dims[-1])
            if nmax and self.coefs.shape[-1] != nmax:
                raise ValueError(
                    f"assign: declared nmax {nmax} != struct radial order "
                    f"{self.coefs.shape[-1]}")
        if np.iscomplexobj(mat) and not np.iscomplexobj(self.coefs):
            native = _complex_to_native(self.geometry, mat, self.coefs.shape)
        else:
            if mat.size != self.coefs.size:
                raise ValueError(
                    f"assign: data size {mat.size} != struct size "
                    f"{self.coefs.size} (geometry {self.geometry!r})")
            native = mat.reshape(self.coefs.shape)
        try:
            self.coefs[...] = native
        except (ValueError, TypeError):     # read-only / dtype-incompatible
            self.coefs = np.array(native)

    # reference spellings: setMatrix on Sph/Cyl/Tbl structs, setTensor on
    # Cube/Slab (CoefWrappers.cc:1580,1921) — same assign-with-checks
    setMatrix = assign
    setTensor = assign


class Coefs:
    """Time series of CoefStructs with the reference's camelCase surface
    (CoefWrappers.cc), wrapping exp_tpu_torch.analysis.coefs.Coefs."""

    def __init__(self, native: _NativeCoefs):
        self._c = native
        self._structs: dict[float, CoefStruct] = {}

    # -- construction --------------------------------------------------------

    @staticmethod
    def factory(path, stride=1, tmin=-np.inf, tmax=np.inf) -> "Coefs":
        """Read a coefficient HDF5 file (Coefs::factory)."""
        nat = _NativeCoefs.from_file(path)
        out = Coefs(nat)
        ts = nat.times()[::max(1, int(stride))]
        for t in ts:
            if tmin <= t <= tmax:
                out._structs[t] = CoefStruct(nat.geometry, nat._data[t],
                                             time=t, name=nat.name,
                                             meta=nat.meta)
        keep = set(out._structs)
        for t in list(nat._data):
            if t not in keep:
                del nat._data[t]
        return out

    @staticmethod
    def makecoefs(struct: CoefStruct, name="") -> "Coefs":
        """Empty container typed from a CoefStruct (Coefs::makecoefs);
        add() the struct afterwards, as in the reference."""
        nat = _NativeCoefs(geometry=struct.geometry,
                           name=name or struct.name, meta=struct.meta)
        return Coefs(nat)

    def add(self, struct: CoefStruct):
        self._c.add(struct.time, struct.coefs)
        self._structs[float(struct.time)] = struct

    # -- access --------------------------------------------------------------

    def Times(self):
        return self._c.times()

    def getGeometry(self):
        return self._c.geometry

    def getName(self):
        return self._c.name

    def setName(self, name):
        self._c.name = name

    def _nearest_time(self, time):
        ts = self.Times()
        if not ts:
            raise KeyError("coefficient container is empty")
        return ts[int(np.argmin(np.abs(np.asarray(ts) - time)))]

    def _stored_time(self, time):
        """The stored time matching `time` within rounding tolerance
        (the reference's roundTime map lookup); KeyError when absent —
        destructive operations must not guess a slot
        (SphCoefs::setData, Coefficients.cc:698-705)."""
        t = self._nearest_time(time)
        if abs(t - time) > 1e-8 * max(1.0, abs(time)):
            raise KeyError(
                f"time {time} not in container (nearest stored: {t})")
        return t

    def getCoefStruct(self, time) -> CoefStruct:
        t = self._nearest_time(time)
        if t not in self._structs:
            self._structs[t] = CoefStruct(self._c.geometry, self._c._data[t],
                                          time=t, name=self._c.name,
                                          meta=self._c.meta)
        return self._structs[t]

    def getAllCoefs(self):
        """Stacked coefficients with TIME LAST in the reference's packed
        layouts: sphere -> complex (lm, nmax, T) with row l(l+1)/2+m
        (index with Basis.I), cylinder -> complex (mmax+1, nmax, T);
        other geometries return the native real layout with time last."""
        g = self._c.geometry
        return np.stack([_pack_complex(g, self._c._data[t])
                         for t in self.Times()], axis=-1)

    def getData(self, time):
        """Packed complex coefficient array (a copy) at the stored time
        nearest `time` (Coefs::getData, bound as __call__ —
        CoefWrappers.cc:1132): sphere (l(l+1)/2+m, nmax), cylinder
        (mmax+1, nmax); other geometries the native real layout."""
        t = self._nearest_time(time)
        return _pack_complex(self._c.geometry, self._c._data[t])

    __call__ = getData

    def setData(self, time, array):
        """Rewrite the coefficient array at a STORED `time`
        (Coefs::setData, CoefWrappers.cc:1153; KeyError when the time is
        absent, matching SphCoefs::setData).  Accepts either the packed
        complex per-time layout of getAllCoefs (sphere:
        (l(l+1)/2+m, nmax); cylinder: (mmax+1, nmax)) or the native
        real layout."""
        t = self._stored_time(time)
        cur = self._c._data[t]
        arr = np.asarray(array)
        if np.iscomplexobj(arr) and not np.iscomplexobj(cur):
            new = _complex_to_native(self._c.geometry, arr, cur.shape)
        else:
            if arr.size != cur.size:
                raise ValueError(
                    f"setData: data size {arr.size} != stored size "
                    f"{cur.size}")
            new = arr.reshape(cur.shape)
        self._c._data[t] = np.asarray(new, dtype=cur.dtype)
        self._structs.pop(t, None)

    def setCoefs(self, struct: CoefStruct):
        """Replace/insert the struct's time slot."""
        self.add(struct)

    set_coefs = setCoefs

    def zerodata(self):
        self._c.zerodata()
        for s in self._structs.values():
            s.zerodata()

    def deepcopy(self):
        out = Coefs(self._c.deepcopy())
        out._structs = {t: s.deepcopy() for t, s in self._structs.items()}
        return out

    # -- HDF5 ----------------------------------------------------------------

    def WriteH5Coefs(self, path):
        if not str(path).endswith(".h5"):
            path = str(path) + ".h5"
        self._c.to_file(path)

    def ExtendH5Coefs(self, path):
        """Append this container's times to an existing coefficient file
        (read-merge-rewrite; times already present are left untouched)."""
        if not str(path).endswith(".h5"):
            path = str(path) + ".h5"
        existing = _NativeCoefs.from_file(path)
        for t in self.Times():
            if t not in existing._data:
                existing.add(t, self._c._data[t])
        existing.to_file(path)

    # -- diagnostics ---------------------------------------------------------

    def Power(self, min=0, max=np.inf):
        """Power per top-level harmonic index vs time (Coefs::Power):
        (T, lmax+1) for spheres, (T, mmax+1) for cylinders, total for
        cube/slab/table."""
        A = self._c.as_array()
        g = self._c.geometry
        if g == "sphere" and A.ndim == 5:
            P = np.einsum("tclmn->tl", A.astype(float) ** 2)
        elif g == "cylinder" and A.ndim == 4:
            P = np.einsum("tcmn->tm", A.astype(float) ** 2)
        else:
            flat = np.abs(A.reshape(A.shape[0], -1)) ** 2
            return flat.sum(axis=1)[:, None]
        lo = int(np.clip(min, 0, P.shape[1]))
        hi = int(np.clip(max, 0, P.shape[1] - 1)) + 1 if np.isfinite(max) \
            else P.shape[1]
        return P[:, lo:hi]

    def EvenOddPower(self, nodd=-1, min=0, max=np.inf):
        """Cylinder power split by vertical parity (CylCoefs::EvenOddPower).
        Needs the `ncylodd` metadata (number of odd functions per m) in
        the coefficient file/meta."""
        if self._c.geometry != "cylinder":
            raise ValueError("EvenOddPower is cylinder-only")
        if nodd < 0:       # explicit nodd overrides file metadata
            nodd = int(self._c.meta.get("ncylodd", -1))
        if nodd < 0:
            raise ValueError("ncylodd unknown: pass nodd explicitly")
        A = self._c.as_array().astype(float)     # (T, 2, M+1, nmax)
        neven = A.shape[3] - nodd
        Pe = np.einsum("tcmn->tm", A[..., :neven] ** 2)
        Po = np.einsum("tcmn->tm", A[..., neven:] ** 2)
        return Pe, Po

    def PowerDim(self, d, min=0, max=np.inf):
        """Cube/slab power along wavevector axis d ('x'|'y'|'z' or 0|1|2)
        (CubeCoefs::PowerDim)."""
        A = self._c.as_array()
        ax = {"x": 0, "y": 1, "z": 2}.get(d, d)
        mag = np.abs(A.astype(complex)) ** 2
        # reduce all per-snapshot axes except the chosen wavevector axis
        axes = tuple(i for i in range(1, A.ndim) if i != ax + 1)
        return mag.sum(axis=axes)

    def CompareStanzas(self, other: "Coefs") -> bool:
        """True when times and coefficient data agree (h5compare logic)."""
        ta, tb = self.Times(), other.Times()
        if len(ta) != len(tb) or not np.allclose(ta, tb):
            return False
        return all(np.allclose(self._c._data[a], other._c._data[b])
                   for a, b in zip(ta, tb))

    def makeKeys(self, subkey=()):
        """All channel keys extending `subkey` (Coefs::makeKeys)."""
        shape = self._c.as_array().shape[1:]
        sub = tuple(int(s) for s in subkey)
        out = []
        for flat in range(int(np.prod(shape))):
            key = np.unravel_index(flat, shape)
            if tuple(key[:len(sub)]) == sub:
                out.append([int(k) for k in key])
        return out

    # -- units (expui/UnitValidator; list of (type, name, value)) ------------

    def getUnits(self):
        return list(getattr(self._c, "units", []) or [])

    def setUnits(self, units):
        from exp_tpu_torch.analysis.units import UnitValidator

        v = UnitValidator()
        canon = []
        for t, name, value in units:
            ok, ct, cu = v(t, name)
            if not ok:
                raise ValueError(f"unknown unit {t!r}:{name!r}")
            canon.append((ct, cu, float(value)))
        self._c.units = canon

    def removeUnits(self):
        self._c.units = []

    def setGravConstant(self, G):
        us = [u for u in self.getUnits() if u[0] != "G"]
        us.append(("G", "none", float(G)))
        self._c.units = us

    def getGravConstant(self):
        from exp_tpu_torch.analysis.units import grav_constant

        return grav_constant(self.getUnits())


def getAllowedUnitTypes():
    from exp_tpu_torch.analysis.units import UnitValidator

    return UnitValidator().allowed_types()


def getAllowedUnitNames(type_):
    from exp_tpu_torch.analysis.units import UnitValidator

    return UnitValidator().allowed_units(type_)


def getAllowedTypeAliases(type_):
    from exp_tpu_torch.analysis.units import UnitValidator

    return UnitValidator().type_aliases(type_)
