"""Snapshot reader family (pyEXP `read` submodule).

A host-side NumPy copy of exp_tpu/io/readers.py (the port imports
nothing of exp_tpu).

The analogue of the reference's ParticleReader hierarchy
(exputil/ParticleReader.cc: createReader :99, GadgetNative :103,
GadgetHDF5 :171, PSP family :333-486, Tipsy :488): uniform access to
(x, v, mass) arrays from assorted snapshot formats.
"""

from __future__ import annotations

import numpy as np


class Snapshot:
    """Uniform snapshot view: dict name -> (x, v, mass [, pot])."""

    def __init__(self, time=0.0):
        self.time = float(time)
        self._comp = {}

    def add(self, name, x, v, mass, pot=None):
        self._comp[name] = dict(
            x=np.asarray(x, np.float64), v=np.asarray(v, np.float64),
            mass=np.asarray(mass, np.float64),
            pot=None if pot is None else np.asarray(pot, np.float64))

    def GetTypes(self):
        return list(self._comp)

    def GetParticles(self, name=None):
        if name is None:
            name = next(iter(self._comp))
        c = self._comp[name]
        return c["x"], c["v"], c["mass"]

    def __getitem__(self, name):
        return self._comp[name]


def read_ascii(path, time=0.0, name="comp"):
    """Reference ascii body file (nbodies niattrib ndattrib header) — via
    the shared fast reader (native parser with a NumPy fallback)."""
    from exp_tpu_torch.nbody.particles import read_ascii_arrays

    x, v, mass = read_ascii_arrays(path)
    s = Snapshot(time)
    s.add(name, x, v, mass)
    return s


def read_psp_snapshot(path, dump_index=-1, new_dir=None):
    from exp_tpu_torch.io.psp import read_psp_any

    d = read_psp_any(path, new_dir=new_dir, dump_index=dump_index)
    s = Snapshot(d.time)
    for c in d.components:
        s.add(c.name, c.x, c.v, c.mass, pot=c.pot)
    return s


def read_gadget_hdf5(path):
    """GadgetHDF5 snapshots (PartTypeN groups)."""
    import h5py

    s = None
    with h5py.File(path, "r") as f:
        time = float(f["Header"].attrs.get("Time", 0.0))
        s = Snapshot(time)
        mtab = f["Header"].attrs.get("MassTable", None)
        for key in f:
            if not key.startswith("PartType"):
                continue
            g = f[key]
            if "Coordinates" not in g:
                continue
            x = g["Coordinates"][...]
            v = g["Velocities"][...] if "Velocities" in g else np.zeros_like(x)
            if "Masses" in g:
                m = g["Masses"][...]
            else:
                it = int(key[8:])
                m = np.full(len(x), mtab[it] if mtab is not None else 1.0)
            s.add(key, x, v, m)
    return s


def write_gadget_hdf5(path, snapshot: Snapshot):
    import h5py

    with h5py.File(path, "w") as f:
        h = f.create_group("Header")
        h.attrs["Time"] = snapshot.time
        names = snapshot.GetTypes()
        if len(names) > 5:
            raise ValueError(
                f"gadget HDF5 has 5 usable particle types; snapshot has "
                f"{len(names)} components ({names})")
        npart = [0] * 6
        for i, name in enumerate(names):
            x, v, m = snapshot.GetParticles(name)
            g = f.create_group(f"PartType{i + 1}")
            g.create_dataset("Coordinates", data=x)
            g.create_dataset("Velocities", data=v)
            g.create_dataset("Masses", data=m)
            npart[i + 1] = len(m)
        h.attrs["NumPart_ThisFile"] = np.array(npart, np.int64)
        h.attrs["NumPart_Total"] = np.array(npart, np.int64)


def read_tipsy(path):
    """Native tipsy binary (header + gas/dark/star records; big endian by
    convention, auto-detected)."""
    hdr_t = np.dtype([("time", ">f8"), ("nbodies", ">i4"), ("ndim", ">i4"),
                      ("nsph", ">i4"), ("ndark", ">i4"), ("nstar", ">i4"),
                      ("pad", ">i4")])
    with open(path, "rb") as f:
        raw = f.read()
    h = np.frombuffer(raw, hdr_t, 1, 0)[0]
    swap = not (0 < h["nbodies"] < 2**31 and h["ndim"] in (2, 3))
    if swap:
        hdr_t = hdr_t.newbyteorder()
        h = np.frombuffer(raw, hdr_t, 1, 0)[0]
    e = hdr_t["time"].byteorder
    f4 = np.dtype(f"{e}f4")
    gas_t = np.dtype([("mass", f4), ("pos", f4, (3,)), ("vel", f4, (3,)),
                      ("rho", f4), ("temp", f4), ("hsmooth", f4),
                      ("metals", f4), ("phi", f4)])
    dark_t = np.dtype([("mass", f4), ("pos", f4, (3,)), ("vel", f4, (3,)),
                       ("eps", f4), ("phi", f4)])
    star_t = np.dtype([("mass", f4), ("pos", f4, (3,)), ("vel", f4, (3,)),
                       ("metals", f4), ("tform", f4), ("eps", f4),
                       ("phi", f4)])
    # header size: padded (32 bytes, native writes) vs unpadded XDR
    # 'standard' (28 bytes) — pick the one whose payload size matches
    counts_sizes = ((int(h["nsph"]), gas_t.itemsize),
                    (int(h["ndark"]), dark_t.itemsize),
                    (int(h["nstar"]), star_t.itemsize))
    payload = sum(c * sz for c, sz in counts_sizes)
    off = hdr_t.itemsize
    if len(raw) != off + payload and len(raw) == (off - 4) + payload:
        off -= 4                               # unpadded 28-byte header
    s = Snapshot(float(h["time"]))
    for name, count, dt in (("gas", int(h["nsph"]), gas_t),
                            ("dark", int(h["ndark"]), dark_t),
                            ("star", int(h["nstar"]), star_t)):
        if count <= 0:
            continue
        rec = np.frombuffer(raw, dt, count, off)
        off += dt.itemsize * count
        s.add(name, rec["pos"], rec["vel"], rec["mass"], pot=rec["phi"])
    return s


def write_tipsy(path, snapshot: Snapshot, eps=0.0):
    """Tipsy 'standard' (XDR) binary writer: big-endian, unpadded 28-byte
    header, then gas/dark/star records (utils/PhaseSpace/tipsydefs.h +
    tipsyxdr.c xdr_header/xdr_gas/xdr_dark/xdr_star).  Components named
    'gas' or 'star'/'stars' map to their tipsy type; everything else is
    written as dark matter.  `eps` fills the softening field."""
    f4, f8, i4 = np.dtype(">f4"), np.dtype(">f8"), np.dtype(">i4")
    gas_t = np.dtype([("mass", f4), ("pos", f4, (3,)), ("vel", f4, (3,)),
                      ("rho", f4), ("temp", f4), ("hsmooth", f4),
                      ("metals", f4), ("phi", f4)])
    dark_t = np.dtype([("mass", f4), ("pos", f4, (3,)), ("vel", f4, (3,)),
                       ("eps", f4), ("phi", f4)])
    star_t = np.dtype([("mass", f4), ("pos", f4, (3,)), ("vel", f4, (3,)),
                       ("metals", f4), ("tform", f4), ("eps", f4),
                       ("phi", f4)])
    groups = {"gas": [], "dark": [], "star": []}
    for name in snapshot.GetTypes():
        lo = name.lower()
        kind = ("gas" if lo == "gas"
                else "star" if lo in ("star", "stars") else "dark")
        groups[kind].append(name)

    def pack(kind, dt):
        rows = []
        for name in groups[kind]:
            c = snapshot[name]
            rec = np.zeros(len(c["mass"]), dt)
            rec["mass"], rec["pos"], rec["vel"] = c["mass"], c["x"], c["v"]
            if c.get("pot") is not None:
                rec["phi"] = c["pot"]
            if "eps" in dt.names:
                rec["eps"] = eps
            rows.append(rec)
        # np.concatenate silently converts to NATIVE byte order; cast
        # back so tobytes() stays big-endian
        return (np.concatenate(rows).astype(dt, copy=False) if rows
                else np.zeros(0, dt))

    gas, dark, star = pack("gas", gas_t), pack("dark", dark_t), \
        pack("star", star_t)
    ntot = len(gas) + len(dark) + len(star)
    with open(path, "wb") as fh:
        fh.write(np.asarray(snapshot.time, f8).tobytes())
        for v in (ntot, 3, len(gas), len(dark), len(star)):
            fh.write(np.asarray(v, i4).tobytes())
        fh.write(gas.tobytes())
        fh.write(dark.tobytes())
        fh.write(star.tobytes())


_GADGET_PTYPES = ("Gas", "Halo", "Disk", "Bulge", "Stars", "Bndry")


def _gadget_header_dtype():
    # include/gadget.H:4-44 layout, padded to 256 bytes
    return np.dtype([
        ("npart", np.int32, 6), ("mass", np.float64, 6),
        ("time", np.float64), ("redshift", np.float64),
        ("flag_sfr", np.int32), ("flag_feedback", np.int32),
        ("npartTotal", np.uint32, 6), ("flag_cooling", np.int32),
        ("num_files", np.int32), ("BoxSize", np.float64),
        ("Omega0", np.float64), ("OmegaLambda", np.float64),
        ("HubbleParam", np.float64),
        ("fill", np.uint8, 256 - 6 * 4 - 6 * 8 - 8 * 8 - 4 * 4 - 6 * 4)])


def read_gadget_native(path):
    """Gadget-1 native binary snapshot (SnapFormat=1): Fortran-style
    size-guarded blocks — header, pos (f32x3), vel (f32x3), id (i32),
    mass (f32, only for types with header.mass==0)
    (exputil/ParticleReader.cc:103-330 GadgetNative)."""
    hdt = _gadget_header_dtype()
    with open(path, "rb") as fh:
        raw = fh.read()

    def block(off):
        n1 = int(np.frombuffer(raw, np.int32, 1, off)[0])
        data = raw[off + 4:off + 4 + n1]
        n2 = int(np.frombuffer(raw, np.int32, 1, off + 4 + n1)[0])
        if n1 != n2:
            raise ValueError(f"{path}: corrupt gadget block at {off} "
                             f"({n1} != {n2})")
        return data, off + 8 + n1

    data, off = block(0)
    hdr = np.frombuffer(data, hdt, 1)[0]
    npart = hdr["npart"]
    ntot = int(npart.sum())

    data, off = block(off)
    pos = np.frombuffer(data, np.float32, 3 * ntot).reshape(ntot, 3)
    data, off = block(off)
    vel = np.frombuffer(data, np.float32, 3 * ntot).reshape(ntot, 3)
    data, off = block(off)   # ids (unused)

    # mass block holds entries only for types with header mass == 0
    nm = int(sum(npart[k] for k in range(6) if hdr["mass"][k] == 0
                 and npart[k] > 0))
    masses = None
    if nm:
        data, off = block(off)
        masses = np.frombuffer(data, np.float32, nm)

    s = Snapshot(float(hdr["time"]))
    i = 0
    j = 0
    for k in range(6):
        n = int(npart[k])
        if n == 0:
            continue
        if hdr["mass"][k] == 0:
            mk = masses[j:j + n]
            j += n
        else:
            mk = np.full(n, hdr["mass"][k])
        s.add(_GADGET_PTYPES[k], pos[i:i + n], vel[i:i + n], mk)
        i += n
    return s


def write_gadget_native(path, snapshot: Snapshot):
    """Write a Gadget-1 native binary (per-particle mass block)."""
    names = snapshot.GetTypes()
    ptypes = []
    for nm in names:
        if nm in _GADGET_PTYPES:
            ptypes.append(_GADGET_PTYPES.index(nm))
        else:
            ptypes.append(1)                       # default to Halo
    hdt = _gadget_header_dtype()
    hdr = np.zeros(1, hdt)
    order = np.argsort(ptypes)
    for idx in order:
        k = ptypes[idx]
        c = snapshot[names[idx]]
        hdr["npart"][0][k] += len(c["mass"])
        hdr["npartTotal"][0][k] += len(c["mass"])
    hdr["time"] = snapshot.time
    hdr["num_files"] = 1

    def blk(fh, payload):
        fh.write(np.int32(len(payload)).tobytes())
        fh.write(payload)
        fh.write(np.int32(len(payload)).tobytes())

    xs = np.concatenate([snapshot[names[i]]["x"] for i in order])
    vs = np.concatenate([snapshot[names[i]]["v"] for i in order])
    ms = np.concatenate([snapshot[names[i]]["mass"] for i in order])
    with open(path, "wb") as fh:
        blk(fh, hdr.tobytes())
        blk(fh, xs.astype(np.float32).tobytes())
        blk(fh, vs.astype(np.float32).tobytes())
        blk(fh, np.arange(1, len(ms) + 1, dtype=np.int32).tobytes())
        blk(fh, ms.astype(np.float32).tobytes())


def createReader(kind: str, path, **kw):
    """Reader factory (ParticleReader::createReader, ParticleReader.cc:99)."""
    kind = kind.lower()
    if kind == "pspspl":
        from exp_tpu_torch.io.psp import read_spl

        d = read_spl(path, **kw)
        s = Snapshot(d.time)
        for c in d.components:
            s.add(c.name, c.x, c.v, c.mass, pot=c.pot)
        return s
    if kind in ("psp", "pspout"):
        return read_psp_snapshot(path, **kw)
    elif kind in ("gadgetnative",):
        return read_gadget_native(path)
    elif kind in ("gadgethdf5", "gadget"):
        return read_gadget_hdf5(path)
    elif kind in ("tipsy", "bonsai"):
        return read_tipsy(path)
    elif kind in ("ascii", "bods"):
        return read_ascii(path, **kw)
    raise ValueError(f"unknown reader type {kind!r}")
