"""Coefficient-file I/O (pyEXP-compatible HDF5 schema; a copy of
exp_tpu/io/coefs.py, NumPy with h5py imported lazily, so that each package
opens the files of the other).

Implements the reference's native HDF5 coefficient format so files written
here can be read by pyEXP's `coefs` module and vice versa
(expui/Coefficients.cc:3100-3160 WriteH5Coefs; SphCoefs::WriteH5Times
:907-944; SphStruct layout CoefStruct.H:149-155):

  /                         attrs: CoefficientOutputVersion, geometry, name,
                                   config; + per-geometry params (lmax, nmax,
                                   scale, forceID)
  /count                    dataset: number of snapshots
  /snapshots/%08d           group per time, attrs Time, Center, Rotation
  /snapshots/%08d/coefficients
        sphere:   complex matrix ((lmax+1)(lmax+2)/2, nmax), row = l(l+1)/2+m,
                  value = cos_coef + i sin_coef (SphericalBasis.cc:1927-1936)
        cylinder: complex matrix (mmax+1, nmax)
"""

from __future__ import annotations

import numpy as np

COEFFICIENT_OUTPUT_VERSION = "1.0"


def _attr_str(v):
    """h5py returns fixed-length string attributes as bytes (files written
    by the reference's HighFive C++ writer do this); normalize to str."""
    return v.decode() if isinstance(v, bytes) else str(v)


def pack_sph_matrix(coef: np.ndarray) -> np.ndarray:
    """(2, lmax+1, lmax+1, nmax) real cos/sin -> packed complex matrix."""
    coef = np.asarray(coef)
    lmax = coef.shape[1] - 1
    nmax = coef.shape[3]
    rows = (lmax + 1) * (lmax + 2) // 2
    out = np.zeros((rows, nmax), dtype=np.complex128)
    L = 0
    for l in range(lmax + 1):
        for m in range(l + 1):
            out[L] = coef[0, l, m] + 1j * coef[1, l, m]
            L += 1
    return out


def unpack_sph_matrix(mat: np.ndarray, lmax: int, nmax: int) -> np.ndarray:
    """Packed complex matrix -> (2, lmax+1, lmax+1, nmax) real cos/sin."""
    out = np.zeros((2, lmax + 1, lmax + 1, nmax))
    L = 0
    for l in range(lmax + 1):
        for m in range(l + 1):
            out[0, l, m] = mat[L].real
            out[1, l, m] = mat[L].imag
            L += 1
    return out


class SphCoefsFile:
    """Writer/reader for spherical coefficient files."""

    geometry = "sphere"

    def __init__(self, path, mode="r", name="", lmax=0, nmax=0,
                 scale=1.0, forceID="sphereSL", config=""):
        import h5py

        self.path = path
        self._h5py = h5py
        if mode == "w":
            self.lmax, self.nmax, self.scale = lmax, nmax, scale
            f = h5py.File(path, "w")
            f.attrs["CoefficientOutputVersion"] = COEFFICIENT_OUTPUT_VERSION
            f.attrs["geometry"] = self.geometry
            f.attrs["name"] = name
            f.attrs["config"] = config
            f.attrs["lmax"] = np.int32(lmax)
            f.attrs["nmax"] = np.int32(nmax)
            f.attrs["scale"] = float(scale)
            f.attrs["forceID"] = forceID
            f.create_dataset("count", data=np.uint32(0))
            f.create_group("snapshots")
            self._f = f
        else:
            f = h5py.File(path, "r+" if mode == "a" else "r")
            if _attr_str(f.attrs["geometry"]) != self.geometry:
                raise ValueError(f"not a sphere coefficient file: {path}")
            self.lmax = int(f.attrs["lmax"])
            self.nmax = int(f.attrs["nmax"])
            self.scale = float(f.attrs["scale"])
            self._f = f

    # -- writing ------------------------------------------------------------

    def append(self, time: float, coef, center=None):
        """coef: (2, lmax+1, lmax+1, nmax) real cos/sin array."""
        f = self._f
        count = int(f["count"][()])
        g = f["snapshots"].create_group(f"{count:08d}")
        g.attrs["Time"] = float(time)
        g.attrs["Center"] = np.zeros(3) if center is None else np.asarray(center)
        g.attrs["Rotation"] = np.eye(3)
        g.create_dataset("coefficients", data=pack_sph_matrix(np.asarray(coef)))
        f["count"][...] = np.uint32(count + 1)

    # -- reading ------------------------------------------------------------

    def times(self):
        snaps = self._f["snapshots"]
        return np.array(sorted(float(snaps[k].attrs["Time"]) for k in snaps))

    def read_all(self):
        """Returns (times (T,), coefs (T, 2, lmax+1, lmax+1, nmax))."""
        snaps = self._f["snapshots"]
        keys = sorted(snaps.keys())
        times = np.array([float(snaps[k].attrs["Time"]) for k in keys])
        coefs = np.stack([
            unpack_sph_matrix(np.asarray(snaps[k]["coefficients"]).view(
                np.complex128).reshape(-1, self.nmax), self.lmax, self.nmax)
            for k in keys])
        order = np.argsort(times)
        return times[order], coefs[order]

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class CylCoefsFile:
    """Writer/reader for cylindrical (m, n) coefficient files."""

    geometry = "cylinder"

    def __init__(self, path, mode="r", name="", mmax=0, nmax=0,
                 scale=1.0, forceID="cylinder", config=""):
        import h5py

        self.path = path
        if mode == "w":
            self.mmax, self.nmax, self.scale = mmax, nmax, scale
            f = h5py.File(path, "w")
            f.attrs["CoefficientOutputVersion"] = COEFFICIENT_OUTPUT_VERSION
            f.attrs["geometry"] = self.geometry
            f.attrs["name"] = name
            f.attrs["config"] = config
            f.attrs["mmax"] = np.int32(mmax)
            f.attrs["nmax"] = np.int32(nmax)
            f.attrs["scale"] = float(scale)
            f.attrs["forceID"] = forceID
            f.create_dataset("count", data=np.uint32(0))
            f.create_group("snapshots")
            self._f = f
        else:
            f = h5py.File(path, "r+" if mode == "a" else "r")
            if _attr_str(f.attrs["geometry"]) != self.geometry:
                raise ValueError(f"not a cylinder coefficient file: {path}")
            self.mmax = int(f.attrs["mmax"])
            self.nmax = int(f.attrs["nmax"])
            # genuine EXP/pyEXP cylinder files carry only mmax/nmax/forceID
            # (expui/Coefficients.cc:1329-1331); scale is our extension
            self.scale = float(f.attrs.get("scale", 1.0))
            self._f = f

    def append(self, time: float, coef, center=None):
        """coef: (2, mmax+1, nmax) real cos/sin array."""
        c = np.asarray(coef)
        mat = c[0] + 1j * c[1]
        f = self._f
        count = int(f["count"][()])
        g = f["snapshots"].create_group(f"{count:08d}")
        g.attrs["Time"] = float(time)
        g.attrs["Center"] = np.zeros(3) if center is None else np.asarray(center)
        g.create_dataset("coefficients", data=mat.astype(np.complex128))
        f["count"][...] = np.uint32(count + 1)

    def times(self):
        snaps = self._f["snapshots"]
        return np.array(sorted(float(snaps[k].attrs["Time"]) for k in snaps))

    def read_all(self):
        snaps = self._f["snapshots"]
        keys = sorted(snaps.keys())
        times = np.array([float(snaps[k].attrs["Time"]) for k in keys])
        mats = np.stack([np.asarray(snaps[k]["coefficients"]).view(
            np.complex128).reshape(self.mmax + 1, self.nmax) for k in keys])
        coefs = np.stack([np.stack([m.real, m.imag]) for m in mats])
        order = np.argsort(times)
        return times[order], coefs[order]

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def open_coefs(path):
    """Factory: open a coefficient file by geometry (Coefs::factory analogue,
    expui/Coefficients.cc:2911-2966; files with a fieldID attribute are
    general field expansions, files with forceID are biorthogonal bases)."""
    import h5py

    with h5py.File(path, "r") as f:
        geom = _attr_str(f.attrs["geometry"])
        is_field = "fieldID" in f.attrs
    if is_field:
        if geom == "sphere":
            return SphFldCoefsFile(path, "r")
        elif geom == "cylinder":
            return CylFldCoefsFile(path, "r")
        raise ValueError(f"unknown field coefficient geometry {geom!r}")
    if geom == "sphere":
        return SphCoefsFile(path, "r")
    elif geom == "cylinder":
        return CylCoefsFile(path, "r")
    elif geom == "cube":
        return CubeCoefsFile(path, "r")
    elif geom == "slab":
        return SlabCoefsFile(path, "r")
    elif geom in ("table", "trajectory"):
        return TableCoefsFile(path, "r", geometry=str(geom))
    raise ValueError(f"unknown coefficient geometry {geom!r}")


class CubeCoefsFile:
    """Writer/reader for cube plane-wave coefficient files (CubeStruct:
    complex (2 nmaxx+1, 2 nmaxy+1, 2 nmaxz+1) tensor per snapshot,
    expui/CoefStruct.cc:63-73)."""

    geometry = "cube"

    def __init__(self, path, mode="r", name="", nmaxx=0, nmaxy=0, nmaxz=0,
                 config=""):
        import h5py

        self.path = path
        if mode == "w":
            self.nmaxx, self.nmaxy, self.nmaxz = nmaxx, nmaxy, nmaxz
            f = h5py.File(path, "w")
            f.attrs["CoefficientOutputVersion"] = COEFFICIENT_OUTPUT_VERSION
            f.attrs["geometry"] = self.geometry
            f.attrs["name"] = name
            f.attrs["config"] = config
            f.attrs["nmaxx"] = np.int32(nmaxx)
            f.attrs["nmaxy"] = np.int32(nmaxy)
            f.attrs["nmaxz"] = np.int32(nmaxz)
            f.attrs["forceID"] = "cube"
            f.create_dataset("count", data=np.uint32(0))
            f.create_group("snapshots")
            self._f = f
        else:
            f = h5py.File(path, "r+" if mode == "a" else "r")
            if _attr_str(f.attrs["geometry"]) != self.geometry:
                raise ValueError(f"not a cube coefficient file: {path}")
            self.nmaxx = int(f.attrs["nmaxx"])
            self.nmaxy = int(f.attrs["nmaxy"])
            self.nmaxz = int(f.attrs["nmaxz"])
            self._f = f

    def append(self, time: float, coef, center=None):
        c = np.asarray(coef).astype(np.complex128)
        f = self._f
        count = int(f["count"][()])
        g = f["snapshots"].create_group(f"{count:08d}")
        g.attrs["Time"] = float(time)
        g.create_dataset("coefficients", data=c)
        f["count"][...] = np.uint32(count + 1)

    def times(self):
        snaps = self._f["snapshots"]
        return np.array(sorted(float(snaps[k].attrs["Time"]) for k in snaps))

    def read_all(self):
        snaps = self._f["snapshots"]
        keys = sorted(snaps.keys())
        times = np.array([float(snaps[k].attrs["Time"]) for k in keys])
        coefs = np.stack([np.asarray(snaps[k]["coefficients"]).view(
            np.complex128).reshape(2 * self.nmaxx + 1, 2 * self.nmaxy + 1,
                                   2 * self.nmaxz + 1) for k in keys])
        order = np.argsort(times)
        return times[order], coefs[order]

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class SlabCoefsFile:
    """Slab coefficient files (SlabStruct, expui/CoefStruct.H:214-251:
    complex (2 nmaxx+1, 2 nmaxy+1, nmaxz) tensor per snapshot)."""

    geometry = "slab"

    def __init__(self, path, mode="r", name="", nmaxx=0, nmaxy=0, nmaxz=0,
                 config=""):
        import h5py

        self.path = path
        if mode == "w":
            self.nmaxx, self.nmaxy, self.nmaxz = nmaxx, nmaxy, nmaxz
            f = h5py.File(path, "w")
            f.attrs["CoefficientOutputVersion"] = COEFFICIENT_OUTPUT_VERSION
            f.attrs["geometry"] = self.geometry
            f.attrs["name"] = name
            f.attrs["config"] = config
            f.attrs["nmaxx"] = np.int32(nmaxx)
            f.attrs["nmaxy"] = np.int32(nmaxy)
            f.attrs["nmaxz"] = np.int32(nmaxz)
            f.attrs["forceID"] = "slabSL"
            f.create_dataset("count", data=np.uint32(0))
            f.create_group("snapshots")
            self._f = f
        else:
            f = h5py.File(path, "r+" if mode == "a" else "r")
            if _attr_str(f.attrs["geometry"]) != self.geometry:
                raise ValueError(f"not a slab coefficient file: {path}")
            self.nmaxx = int(f.attrs["nmaxx"])
            self.nmaxy = int(f.attrs["nmaxy"])
            self.nmaxz = int(f.attrs["nmaxz"])
            self._f = f

    def append(self, time: float, coef, center=None):
        c = np.asarray(coef).astype(np.complex128)
        f = self._f
        count = int(f["count"][()])
        g = f["snapshots"].create_group(f"{count:08d}")
        g.attrs["Time"] = float(time)
        g.create_dataset("coefficients", data=c)
        f["count"][...] = np.uint32(count + 1)

    def times(self):
        snaps = self._f["snapshots"]
        return np.array(sorted(float(snaps[k].attrs["Time"]) for k in snaps))

    def read_all(self):
        snaps = self._f["snapshots"]
        keys = sorted(snaps.keys())
        times = np.array([float(snaps[k].attrs["Time"]) for k in keys])
        coefs = np.stack([np.asarray(snaps[k]["coefficients"]).view(
            np.complex128).reshape(2 * self.nmaxx + 1, 2 * self.nmaxy + 1,
                                   self.nmaxz) for k in keys])
        order = np.argsort(times)
        return times[order], coefs[order]

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class TableCoefsFile:
    """Table/trajectory coefficient files (TblStruct/TrajStruct,
    expui/CoefStruct.H:341-420: a complex data vector per snapshot —
    arbitrary user time series channeled through the MSSA machinery)."""

    def __init__(self, path, mode="r", name="", cols=0, config="",
                 geometry="table"):
        import h5py

        self.geometry = geometry
        self.path = path
        if mode == "w":
            self.cols = int(cols)
            f = h5py.File(path, "w")
            f.attrs["CoefficientOutputVersion"] = COEFFICIENT_OUTPUT_VERSION
            f.attrs["geometry"] = self.geometry
            f.attrs["name"] = name
            f.attrs["config"] = config
            f.attrs["cols"] = np.int32(cols)
            f.attrs["forceID"] = "table"
            f.create_dataset("count", data=np.uint32(0))
            f.create_group("snapshots")
            self._f = f
        else:
            f = h5py.File(path, "r+" if mode == "a" else "r")
            if _attr_str(f.attrs["geometry"]) != self.geometry:
                raise ValueError(
                    f"not a {self.geometry} coefficient file: {path}")
            self.cols = int(f.attrs["cols"])
            self._f = f

    def append(self, time: float, coef, center=None):
        c = np.asarray(coef).reshape(-1).astype(np.complex128)
        f = self._f
        count = int(f["count"][()])
        g = f["snapshots"].create_group(f"{count:08d}")
        g.attrs["Time"] = float(time)
        g.create_dataset("coefficients", data=c)
        f["count"][...] = np.uint32(count + 1)

    def times(self):
        snaps = self._f["snapshots"]
        return np.array(sorted(float(snaps[k].attrs["Time"]) for k in snaps))

    def read_all(self):
        snaps = self._f["snapshots"]
        keys = sorted(snaps.keys())
        times = np.array([float(snaps[k].attrs["Time"]) for k in keys])
        coefs = np.stack([np.asarray(snaps[k]["coefficients"]).view(
            np.complex128).reshape(self.cols) for k in keys])
        order = np.argsort(times)
        return times[order], coefs[order]

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class _FldCoefsFile:
    """Shared machinery for general field-expansion coefficient files
    (SphFldStruct/CylFldStruct, expui/CoefStruct.H:431-520): keyed by a
    `fieldID` attribute instead of forceID (Coefs::factory dispatch,
    Coefficients.cc:2953-2964); complex (nfld, rows, nmax) tensor per
    snapshot, where rows is the packed angular dimension."""

    geometry = ""
    field_id = ""
    ang_attr = ""

    def __init__(self, path, mode="r", name="", nfld=0, angmax=0, nmax=0,
                 scale=1.0, config="", labels=()):
        import h5py

        self.path = path
        if mode == "w":
            self.nfld, self.angmax, self.nmax = int(nfld), int(angmax), int(nmax)
            self.scale = float(scale)
            f = h5py.File(path, "w")
            f.attrs["CoefficientOutputVersion"] = COEFFICIENT_OUTPUT_VERSION
            f.attrs["geometry"] = self.geometry
            f.attrs["fieldID"] = self.field_id
            f.attrs["name"] = name
            f.attrs["config"] = config
            f.attrs["nfld"] = np.int32(nfld)
            f.attrs[self.ang_attr] = np.int32(angmax)
            f.attrs["nmax"] = np.int32(nmax)
            f.attrs["scale"] = float(scale)
            if labels:
                f.attrs["labels"] = list(labels)
            f.create_dataset("count", data=np.uint32(0))
            f.create_group("snapshots")
            self._f = f
        else:
            f = h5py.File(path, "r+" if mode == "a" else "r")
            if _attr_str(f.attrs["geometry"]) != self.geometry \
                    or "fieldID" not in f.attrs:
                raise ValueError(
                    f"not a {self.geometry} field coefficient file: {path}")
            self.nfld = int(f.attrs["nfld"])
            self.angmax = int(f.attrs[self.ang_attr])
            self.nmax = int(f.attrs["nmax"])
            self.scale = float(f.attrs.get("scale", 1.0))
            self.labels = [_attr_str(s) for s in f.attrs.get("labels", [])]
            self._f = f

    def append(self, time: float, coef, center=None):
        """coef: complex (nfld, rows, nmax) tensor."""
        c = np.asarray(coef).astype(np.complex128)
        f = self._f
        count = int(f["count"][()])
        g = f["snapshots"].create_group(f"{count:08d}")
        g.attrs["Time"] = float(time)
        g.attrs["Center"] = np.zeros(3) if center is None \
            else np.asarray(center)
        g.create_dataset("coefficients", data=c)
        f["count"][...] = np.uint32(count + 1)

    def times(self):
        snaps = self._f["snapshots"]
        return np.array(sorted(float(snaps[k].attrs["Time"]) for k in snaps))

    def read_all(self):
        """Returns (times (T,), coefs (T, nfld, rows, nmax) complex)."""
        snaps = self._f["snapshots"]
        keys = sorted(snaps.keys())
        times = np.array([float(snaps[k].attrs["Time"]) for k in keys])
        rows = self._rows()
        coefs = np.stack([np.asarray(snaps[k]["coefficients"]).view(
            np.complex128).reshape(self.nfld, rows, self.nmax)
            for k in keys])
        order = np.argsort(times)
        return times[order], coefs[order]

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class SphFldCoefsFile(_FldCoefsFile):
    """Spherical field-expansion coefficients (SphFldCoefs,
    Coefficients.cc:461-560): packed (l, m) rows like the sphere files."""

    geometry = "sphere"
    field_id = "spherical field"
    ang_attr = "lmax"

    def _rows(self):
        return (self.angmax + 1) * (self.angmax + 2) // 2


class CylFldCoefsFile(_FldCoefsFile):
    """Polar field-expansion coefficients (CylFldCoefs,
    Coefficients.cc:565-665): m rows 0..mmax."""

    geometry = "cylinder"
    field_id = "polar field"
    ang_attr = "mmax"

    def _rows(self):
        return self.angmax + 1


# ---------------------------------------------------------------------------
# EXP native (pre-HDF5) binary coefficient files
# ---------------------------------------------------------------------------

_SPH_MAGIC = 0xc0a57a2    # expui/CoefStruct.cc:386 (SphStruct::read)
_CYL_MAGIC = 0xc0a57a3    # expui/CoefStruct.cc:... (CylStruct::read)


def _sph_prefactors(lmax):
    """exp-native -> 'true normed' prefactors (CoefStruct.cc SphStruct::read
    exp_type block): fac_lm = sqrt((l/2+1/4)/pi (l-m)!/(l+m)!) [* sqrt2]."""
    from scipy.special import gammaln

    fac = np.zeros((lmax + 1, lmax + 1))
    for l in range(lmax + 1):
        for m in range(l + 1):
            f = np.sqrt((0.5 * l + 0.25) / np.pi
                        * np.exp(gammaln(1.0 + l - m) - gammaln(1.0 + l + m)))
            fac[l, m] = f * (np.sqrt(2.0) if m else 1.0)
    return fac


def read_native_coefs(path, geometry=None):
    """Read an EXP native binary outcoef file (the reference's pre-HDF5
    format: readNativeCoefs, expui/Coefficients.cc:796/1289).

    Each record is either new-style (uint32 magic + uint32 YAML size +
    YAML header) or a legacy raw header, followed by the packed
    coefficient doubles.  Returns (geometry, times, coefs, meta) with
    coefs in the package's layouts ((2, L+1, L+1, n) sphere /
    (2, M+1, n) cylinder) and 'true normed' spherical amplitudes
    (native un-normed records get the exp_type prefactors applied,
    matching Coefs::factory)."""
    import io as _io
    import yaml as _yaml

    raw = open(path, "rb").read()
    pos = 0
    times = []
    out = []
    geom = geometry
    meta = {}
    while pos < len(raw):
        if len(raw) - pos < 4:
            break
        magic = np.frombuffer(raw, np.uint32, 1, pos)[0]
        normed = False
        if magic in (_SPH_MAGIC, _CYL_MAGIC):
            hsize = int(np.frombuffer(raw, np.uint32, 1, pos + 4)[0])
            node = _yaml.safe_load(raw[pos + 8:pos + 8 + hsize].decode())
            pos += 8 + hsize
            time = float(node["time"])
            nmax = int(node["nmax"])
            if magic == _SPH_MAGIC:
                geom = geom or "sphere"
                lmax = int(node["lmax"])
                meta.setdefault("scale", float(node.get("scale", 1.0)))
                normed = bool(node.get("normed", False))
            else:
                geom = geom or "cylinder"
                lmax = int(node["mmax"])
        else:
            # legacy raw headers: sphere = char[64] id + 2 doubles + 2 ints
            # (include/coef.H:18); cylinder = double + 2 ints (coef.H:5)
            if geom is None:
                # sniff: a sphere header starts with a printable force id
                head = raw[pos:pos + 16]
                geom = "sphere" if any(32 <= b < 127 for b in head[:4]) \
                    and head[:4] != b"\x00\x00\x00\x00" else "cylinder"
            if geom == "sphere":
                hid = raw[pos:pos + 64].split(b"\0")[0].decode("latin1")
                time, scale = np.frombuffer(raw, np.float64, 2, pos + 64)
                nmax, lmax = np.frombuffer(raw, np.int32, 2, pos + 80)
                meta.setdefault("scale", float(scale))
                meta.setdefault("forceID", hid)
                pos += 88
                time, nmax, lmax = float(time), int(nmax), int(lmax)
            else:
                time = float(np.frombuffer(raw, np.float64, 1, pos)[0])
                lmax, nmax = (int(v) for v in
                              np.frombuffer(raw, np.int32, 2, pos + 8))
                pos += 16
        if geom == "sphere":
            ldim = (lmax + 1) * (lmax + 2) // 2
            # per radial index: (l, m<=l) rows, m=0 real else re+im
            vals_per_ir = (lmax + 1) + 2 * (ldim - (lmax + 1))
            need = nmax * vals_per_ir
            data = np.frombuffer(raw, np.float64, need, pos)
            pos += need * 8
            mat = np.zeros((ldim, nmax), np.complex128)
            k = 0
            for ir in range(nmax):
                L = 0
                for l in range(lmax + 1):
                    for m in range(l + 1):
                        if m == 0:
                            mat[L, ir] = data[k]
                            k += 1
                        else:
                            mat[L, ir] = data[k] + 1j * data[k + 1]
                            k += 2
                        L += 1
            if not normed:
                fac = _sph_prefactors(lmax)
                L = 0
                for l in range(lmax + 1):
                    for m in range(l + 1):
                        mat[L] *= fac[l, m]
                        L += 1
            out.append(unpack_sph_matrix(mat, lmax, nmax))
            meta.setdefault("lmax", lmax)
            meta.setdefault("nmax", nmax)
        else:
            c = np.zeros((2, lmax + 1, nmax))
            for mm in range(lmax + 1):
                c[0, mm] = np.frombuffer(raw, np.float64, nmax, pos)
                pos += nmax * 8
                if mm:
                    c[1, mm] = np.frombuffer(raw, np.float64, nmax, pos)
                    pos += nmax * 8
            out.append(c)
            meta.setdefault("mmax", lmax)
            meta.setdefault("nmax", nmax)
        times.append(time)
    return geom, np.asarray(times), np.stack(out) if out else None, meta
