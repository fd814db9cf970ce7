"""PSP binary phase-space files (reference-compatible; a copy of
exp_tpu/io/psp.py, which is NumPy only).

Implements the reference's PSP format (include/header.H MasterHeader/
ComponentHeader; Particle::writeBinaryBuffered, exputil/Particle.cc:194-262;
reader magic exputil ParticleReader.H:338-340) so snapshots interchange with
the reference's `exp` outputs and its psp toolbox:

  MasterHeader: double time; int32 ntot; int32 ncomp        (16 bytes)
  per component:
    uint64 cmagic = 0xadbfabc0 | rsize   (rsize = 4 or 8)
    int32 nbod, niatr, ndatr, ninfochar; char info[ninfochar]  (YAML config)
    per particle:
      [uint64 indx  (if indexing)]
      mass, pos[3], vel[3], pot  (rsize floats; pot = pot + potext)
      iatr int32 x niatr, datr rsize x ndatr

An OUT. file may hold several dumps appended back to back (PSPout).
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass, field

PSP_MAGIC = 0xadbfabc0
MMASK = 0xF
NMASK = ~np.uint64(MMASK)


@dataclass
class PSPComponent:
    name: str
    info: str
    mass: np.ndarray
    x: np.ndarray
    v: np.ndarray
    pot: np.ndarray
    indx: np.ndarray | None = None
    iattr: np.ndarray | None = None
    dattr: np.ndarray | None = None


@dataclass
class PSPDump:
    time: float
    components: list[PSPComponent] = field(default_factory=list)

    @property
    def ntot(self):
        return sum(len(c.mass) for c in self.components)


def _component_record_dtype(rsize, niatr, ndatr, indexing):
    f = np.float32 if rsize == 4 else np.float64
    fields = []
    if indexing:
        fields.append(("indx", np.uint64))
    fields += [("mass", f), ("pos", f, (3,)), ("vel", f, (3,)), ("pot", f)]
    if niatr:
        fields.append(("iatr", np.int32, (niatr,)))
    if ndatr:
        fields.append(("datr", f, (ndatr,)))
    return np.dtype(fields)


def write_psp(path, dump: PSPDump, real4=False, indexing=False, append=False):
    """Write one dump (optionally appended to an existing OUT file)."""
    mode = "ab" if append else "wb"
    rsize = 4 if real4 else 8
    with open(path, mode) as fh:
        fh.write(np.float64(dump.time).tobytes())
        fh.write(np.int32(dump.ntot).tobytes())
        fh.write(np.int32(len(dump.components)).tobytes())
        for c in dump.components:
            info = c.info or f"name: {c.name}\n"
            ib = info.encode()
            fh.write(np.uint64(PSP_MAGIC + rsize).tobytes())
            for v in (len(c.mass), 0 if c.iattr is None else c.iattr.shape[1],
                      0 if c.dattr is None else c.dattr.shape[1], len(ib)):
                fh.write(np.int32(v).tobytes())
            fh.write(ib)
            niatr = 0 if c.iattr is None else c.iattr.shape[1]
            ndatr = 0 if c.dattr is None else c.dattr.shape[1]
            rec = np.zeros(len(c.mass),
                           _component_record_dtype(rsize, niatr, ndatr,
                                                   indexing))
            if indexing:
                rec["indx"] = (np.arange(1, len(c.mass) + 1)
                               if c.indx is None else c.indx)
            rec["mass"] = c.mass
            rec["pos"] = c.x
            rec["vel"] = c.v
            rec["pot"] = c.pot
            if niatr:
                rec["iatr"] = c.iattr
            if ndatr:
                rec["datr"] = c.dattr
            fh.write(rec.tobytes())


def _info_indexing(info: str) -> bool:
    """The component config's `indexing` flag, parsed as YAML like the
    reference (PSP.cc PSPspl cconf['indexing']); falls back to a per-line
    scan if the info string is not valid YAML."""
    try:
        import yaml

        conf = yaml.safe_load(info)
        if isinstance(conf, dict):
            v = conf.get("indexing", False)
            return bool(v) if not isinstance(v, str) else \
                v.strip().lower() in ("true", "1", "yes", "on")
    except Exception:
        pass
    for line in str(info).splitlines():
        if line.strip().startswith("indexing"):
            _, _, val = line.partition(":")
            return val.strip().lower() in ("true", "1", "yes", "on")
    return False


def read_psp_any(path, new_dir=None, dump_index=-1):
    """Read a monolithic OUT file or a split SPL master into ONE dump:
    the filename dispatch the reference uses everywhere (psp2rings.cc:
    a path containing 'SPL' is a split master), with multi-dump OUT
    files unwrapped at dump_index.  The single helper behind every
    CLI/reader call site."""
    import os

    if "SPL" in os.path.basename(str(path)):
        return read_spl(path, new_dir=new_dir)
    d = read_psp(path)
    return d[dump_index] if isinstance(d, list) else d


def write_spl(master_path, dump: PSPDump, nparts=2, real4=False,
              indexing=False):
    """Write a dump as a split SPL set (master + per-part blobs).

    Mirrors the reference's per-node checkpoint layout (OutPSN/PSP.cc
    PSPspl): the master holds MasterHeader + per-component [cmagic,
    int nparts, ComponentHeader, nparts x 1024-byte part filenames];
    each part blob is uint32 N + N particle records.  Part files are
    named <master>-<ci>.<k> beside the master."""
    import os

    rsize = 4 if real4 else 8
    d = os.path.dirname(master_path) or "."
    base = os.path.basename(master_path)
    with open(master_path, "wb") as fh:
        fh.write(np.float64(dump.time).tobytes())
        fh.write(np.int32(dump.ntot).tobytes())
        fh.write(np.int32(len(dump.components)).tobytes())
        for ci, c in enumerate(dump.components):
            info = c.info or f"name: {c.name}\n"
            # SPL readers learn the layout from the YAML config
            # (PSP.cc:PSPspl cconf["indexing"]), not from boundary
            # detection like the monolithic reader — the header must
            # MATCH the records, so rewrite a contradicting value
            if _info_indexing(info) != indexing:
                import re

                if re.search(r"^\s*indexing\s*:", info, re.M):
                    info = re.sub(r"^(\s*indexing\s*:).*$",
                                  rf"\1 {str(indexing).lower()}",
                                  info, flags=re.M)
                elif indexing:
                    info = info.rstrip("\n") + "\nindexing: true\n"
            ib = info.encode()
            fh.write(np.uint64(PSP_MAGIC + rsize).tobytes())
            fh.write(np.int32(nparts).tobytes())
            niatr = 0 if c.iattr is None else c.iattr.shape[1]
            ndatr = 0 if c.dattr is None else c.dattr.shape[1]
            for v in (len(c.mass), niatr, ndatr, len(ib)):
                fh.write(np.int32(v).tobytes())
            fh.write(ib)
            rec = np.zeros(len(c.mass),
                           _component_record_dtype(rsize, niatr, ndatr,
                                                   indexing))
            if indexing:
                rec["indx"] = (np.arange(1, len(c.mass) + 1)
                               if c.indx is None else c.indx)
            rec["mass"] = c.mass
            rec["pos"] = c.x
            rec["vel"] = c.v
            rec["pot"] = c.pot
            if niatr:
                rec["iatr"] = c.iattr
            if ndatr:
                rec["datr"] = c.dattr
            bounds = np.linspace(0, len(rec), nparts + 1).astype(int)
            for k in range(nparts):
                pname = f"{base}-{ci}.{k}"
                fh.write(pname.encode().ljust(1024, b"\x00"))
                blob = rec[bounds[k]:bounds[k + 1]]
                with open(os.path.join(d, pname), "wb") as pf:
                    pf.write(np.uint32(len(blob)).tobytes())
                    pf.write(blob.tobytes())


def read_spl(master_path, new_dir=None):
    """Read a split SPL dump (master + part blobs) into a PSPDump.

    new_dir rewrites the directory of the stored part filenames
    (PSP.cc PSPspl::openNextBlob's -d behavior); default is the
    master's own directory."""
    import os

    if new_dir is None:
        new_dir = os.path.dirname(master_path) or "."
    with open(master_path, "rb") as fh:
        data = fh.read()
    time = np.frombuffer(data, np.float64, 1, 0)[0]
    ntot, ncomp = np.frombuffer(data, np.int32, 2, 8)
    off = 16
    dump = PSPDump(time=float(time))
    for _ in range(int(ncomp)):
        cmagic = np.frombuffer(data, np.uint64, 1, off)[0]
        off += 8
        if (int(cmagic) & ~MMASK) != PSP_MAGIC:
            raise ValueError(f"{master_path}: bad SPL component magic")
        rsize = int(cmagic) & MMASK
        nparts = int(np.frombuffer(data, np.int32, 1, off)[0])
        off += 4
        nbod, niatr, ndatr, ninfo = np.frombuffer(data, np.int32, 4, off)
        off += 16
        info = data[off:off + int(ninfo)].split(b"\x00")[0].decode(
            errors="replace")
        off += int(ninfo)
        indexing = _info_indexing(info)
        dt = _component_record_dtype(rsize, int(niatr), int(ndatr), indexing)
        recs = []
        for _k in range(nparts):
            pname = data[off:off + 1024].split(b"\x00")[0].decode()
            off += 1024
            pname = os.path.join(new_dir, os.path.basename(pname))
            with open(pname, "rb") as pf:
                blob = pf.read()
            npart = int(np.frombuffer(blob, np.uint32, 1, 0)[0])
            recs.append(np.frombuffer(blob, dt, npart, 4))
        rec = np.concatenate(recs) if recs else np.zeros(0, dt)
        if len(rec) != int(nbod):
            raise ValueError(f"{master_path}: SPL blobs hold {len(rec)} "
                             f"particles, master says {int(nbod)}")
        name = "comp"
        for line in info.splitlines():
            if line.strip().startswith("name"):
                name = line.split(":", 1)[1].strip()
                break
        dump.components.append(PSPComponent(
            name=name, info=info,
            mass=rec["mass"].astype(np.float64),
            x=rec["pos"].astype(np.float64),
            v=rec["vel"].astype(np.float64),
            pot=rec["pot"].astype(np.float64),
            indx=rec["indx"].copy() if indexing else None,
            iattr=rec["iatr"].copy() if niatr else None,
            dattr=rec["datr"].copy() if ndatr else None))
    return dump


def read_psp(path, dump_index=None):
    """Read PSP dump(s).  Returns a PSPDump, or list of dumps if
    dump_index is None and the file holds several (OUT. style)."""
    dumps = []
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    n = len(data)
    while off + 16 <= n:
        time = np.frombuffer(data, np.float64, 1, off)[0]
        ntot, ncomp = np.frombuffer(data, np.int32, 2, off + 8)
        off += 16
        dump = PSPDump(time=float(time))
        ok = True
        for ci in range(ncomp):
            if off + 8 > n:
                ok = False
                break
            cmagic = np.frombuffer(data, np.uint64, 1, off)[0]
            off += 8
            if (int(cmagic) & ~MMASK) == PSP_MAGIC:
                rsize = int(cmagic) & MMASK
                indexing = True      # reference writes indx iff indexing on;
            else:                    # detect per-size below
                rsize = 8
                indexing = False
                off -= 8             # old headers had no magic
            if off + 16 > n:         # truncated mid-header (live file)
                ok = False
                break
            nbod, niatr, ndatr, ninfo = np.frombuffer(data, np.int32, 4, off)
            off += 16
            if off + int(ninfo) > n:
                ok = False
                break
            info = data[off:off + ninfo].split(b"\x00")[0].decode(
                errors="replace")
            off += ninfo
            # Detect indexing DETERMINISTICALLY by boundary bookkeeping:
            # each candidate record size implies where this component's
            # stanza ends; the true layout is the one whose end lands on a
            # valid continuation (next component's cmagic, the next dump's
            # MasterHeader, or exact EOF).  Mass sanity is only a tiebreak
            # for the (rare) case where both boundaries validate.
            base = rsize * (8 + ndatr) + 4 * niatr
            with_idx = base + 8
            comps_left = ncomp - ci - 1

            def _boundary_ok(off_next):
                if off_next > n:
                    return False
                if comps_left > 0:
                    # next component header: 8-byte cmagic
                    if off_next + 8 > n:
                        return False
                    nm = np.frombuffer(data, np.uint64, 1, off_next)[0]
                    return (int(nm) & ~MMASK) == PSP_MAGIC
                if off_next == n:
                    return True
                # next MasterHeader of a multi-dump OUT file
                if off_next + 16 > n:
                    return False
                t2 = np.frombuffer(data, np.float64, 1, off_next)[0]
                nt2, nc2 = np.frombuffer(data, np.int32, 2, off_next + 8)
                return bool(np.isfinite(t2) and 0 < nc2 < 65536
                            and nt2 >= nc2 > 0)

            ok_noidx = _boundary_ok(off + base * nbod)
            ok_idx = _boundary_ok(off + with_idx * nbod)
            if ok_idx and not ok_noidx:
                indexing = True
            elif ok_noidx and not ok_idx:
                indexing = False
            else:
                # ambiguous (or corrupt): fall back to mass sanity
                nprobe = min(int(nbod), 4)
                if off + with_idx * nprobe > n:   # truncated mid-stanza
                    ok = False
                    break
                rec_i = np.frombuffer(
                    data, _component_record_dtype(rsize, niatr, ndatr, True),
                    nprobe, off)
                rec_n = np.frombuffer(
                    data, _component_record_dtype(rsize, niatr, ndatr, False),
                    nprobe, off)

                def sane(mm):
                    return bool(np.all(np.isfinite(mm)) and np.all(mm >= 0)
                                and np.all(mm < 1e30))
                indexing = (n - off >= with_idx * nbod
                            and sane(rec_i["mass"])
                            and not sane(rec_n["mass"]))
            dt = _component_record_dtype(rsize, niatr, ndatr, indexing)
            if off + dt.itemsize * int(nbod) > n:  # truncated payload
                ok = False
                break
            rec = np.frombuffer(data, dt, nbod, off)
            off += dt.itemsize * nbod
            name = "comp"
            for line in info.splitlines():
                if line.strip().startswith("name"):
                    name = line.split(":", 1)[1].strip()
                    break
            dump.components.append(PSPComponent(
                name=name, info=info,
                mass=rec["mass"].astype(np.float64),
                x=rec["pos"].astype(np.float64),
                v=rec["vel"].astype(np.float64),
                pot=rec["pot"].astype(np.float64),
                indx=rec["indx"].copy() if indexing else None,
                iattr=rec["iatr"].copy() if niatr else None,
                dattr=rec["datr"].copy() if ndatr else None))
        if not ok:
            break
        dumps.append(dump)
    if dump_index is not None:
        return dumps[dump_index]
    return dumps[0] if len(dumps) == 1 else dumps
