"""pyEXP.read compatibility (port of exp_tpu/pyexp/read.py; reference
pyEXP/ParticleReaderWrappers.cc).

ParticleReader with the reference's classmethod factory + iteration
protocol, over exp_tpu_torch.io.readers snapshots (host NumPy).
"""

from __future__ import annotations

import glob as _glob
import re

import numpy as np

from exp_tpu_torch.io import readers as _readers


class ParticleReader:
    """Reference-shaped reader: createReader + SelectType/GetParticles.

    Mirrors exputil/ParticleReader.H:99 createReader and the pybind11
    surface (SelectType, GetTypes, CurrentNumber, CurrentTime,
    Particles/nextParticle)."""

    def __init__(self, snapshot):
        self._snap = snapshot
        types = snapshot.GetTypes()
        self._type = types[0] if types else None

    # -- factory ------------------------------------------------------------

    @staticmethod
    def createReader(type: str, files, myid: int = 0, verbose: bool = False):
        """Create a reader for `files` (str or list; one snapshot's pieces
        are concatenated).  `type` names are the reference's:
        PSPout/PSPspl/GadgetNative/GadgetHDF5/Tipsy/Bonsai plus the
        'ascii' of exp_tpu."""
        if isinstance(files, (str, bytes)):
            files = [files]
        kind = str(type).lower()
        if kind not in ("psp", "pspout", "pspspl", "gadgetnative",
                        "gadgethdf5", "gadget", "tipsy", "bonsai",
                        "ascii", "bods"):
            raise ValueError(f"unknown reader type {type!r}; "
                             f"see getReaders()")
        snaps = [_readers.createReader(kind, f) for f in files]
        snap = snaps[0]
        for s in snaps[1:]:
            for t in s.GetTypes():
                x, v, m = s.GetParticles(t)
                if t in snap.GetTypes():
                    x0, v0, m0 = snap.GetParticles(t)
                    x = np.concatenate([x0, x])
                    v = np.concatenate([v0, v])
                    m = np.concatenate([m0, m])
                snap.add(t, x, v, m)
        return ParticleReader(snap)

    # -- reference surface ---------------------------------------------------

    def GetTypes(self):
        return self._snap.GetTypes()

    def SelectType(self, name: str):
        if name not in self._snap.GetTypes():
            raise ValueError(f"no particle type {name!r}; "
                             f"have {self._snap.GetTypes()}")
        self._type = name

    def CurrentNumber(self) -> int:
        x, v, m = self._snap.GetParticles(self._type)
        return int(len(m))

    def CurrentTime(self) -> float:
        return float(getattr(self._snap, "time", 0.0))

    def Particles(self):
        """(mass, pos, vel) arrays of the selected type."""
        x, v, m = self._snap.GetParticles(self._type)
        return m, x, v

    def NumFiles(self) -> int:
        """Number of files backing the current snapshot (1 here: multiple
        pieces are concatenated at createReader time)."""
        return 1

    def PrintSummary(self, verbose: bool = False):
        """Print a summary of the snapshot (ParticleReaderWrappers.cc)."""
        print(f"time = {self.CurrentTime()}")
        for t in self.GetTypes():
            x, v, m = self._snap.GetParticles(t)
            line = f"  type {t!r}: N={len(m)}  Mtot={float(np.sum(m)):.6g}"
            if verbose:
                c = np.average(x, axis=0, weights=m)
                line += f"  COM=({c[0]:.4g}, {c[1]:.4g}, {c[2]:.4g})"
            print(line)


def parseFileList(path: str, delimit: str = "") -> list:
    """Read a file listing snapshot files, grouped into time batches by a
    numeric suffix (ParticleReader::parseFileList)."""
    with open(path) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    return parseStringList(names, delimit)


def parseStringList(names: list, delimit: str = "") -> list:
    """Group snapshot-piece filenames into per-time batches
    (ParticleReader::parseStringList): pieces that differ only in a
    trailing part-number belong to the same batch.  With `delimit`, the
    stem is everything before the LAST delimiter (the reference's
    behavior); without it, a trailing '_<n>' is stripped."""
    groups: dict = {}
    for n in names:
        if delimit:
            stem = n.rsplit(delimit, 1)[0] if delimit in n else n
        else:
            m = re.match(r"^(.*?)(?:_(\d+))?$", n)
            stem = m.group(1) if m.group(2) is not None else n
        groups.setdefault(stem, []).append(n)
    return [sorted(v) for k, v in sorted(groups.items())]


def getReaders() -> list:
    """Supported reader type names."""
    return ["PSPout", "PSPspl", "GadgetNative", "GadgetHDF5", "Tipsy",
            "Bonsai", "ascii"]


def globFiles(pattern: str) -> list:
    return sorted(_glob.glob(pattern))
