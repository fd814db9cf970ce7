"""pyEXP.field compatibility (port of exp_tpu/pyexp/field.py; reference
pyEXP/FieldWrappers.cc).

FieldGenerator with the reference's calling convention — (basis, coefs)
arguments may be the compat wrappers from this package or the port's
analysis objects — plus lines/histo1d/histo1dlog and the midplane knobs.
Each time's grid is one field evaluation on the basis's device (the
force kernel, K2 or K5, under `backend: pallas`); setMidplane adds one a
scanned height (17 heights).
"""

from __future__ import annotations

import numpy as np

from exp_tpu_torch.analysis.field import FieldGenerator as _NativeFG


def _native_pair(basis, coefs):
    b = basis.native if hasattr(basis, "native") else basis
    c = coefs._c if hasattr(coefs, "_c") else coefs
    return b, c


class FieldGenerator:
    """Reference-shaped field renderer (FieldGenerator.H:14-150)."""

    def __init__(self, times, pmin=(0, 0, 0), pmax=(0, 0, 0),
                 grid=(0, 0, 0)):
        self._fg = _NativeFG(times, pmin, pmax, grid)
        self._midplane = False
        self._colheight = 4.0

    # -- reference knobs -----------------------------------------------------

    def setMidplane(self, flag: bool):
        """Evaluate disk slices at the local density midplane instead of
        z=0 (FieldGenerator::setMidplane)."""
        self._midplane = bool(flag)

    def setColumnHeight(self, h: float):
        """Search height (in disk scale heights) for the midplane scan."""
        self._colheight = float(h)

    # -- rendering -----------------------------------------------------------

    def slices(self, basis, coefs):
        b, c = _native_pair(basis, coefs)
        out = self._fg.slices(b, c)
        if self._midplane:
            out = {t: self._apply_midplane(
                       b, c.interpolate(t) if hasattr(c, "interpolate")
                       else c, fields)
                   for t, fields in out.items()}
        return out

    def volumes(self, basis, coefs):
        b, c = _native_pair(basis, coefs)
        return self._fg.volumes(b, c)

    def points(self, basis, coefs, points):
        b, c = _native_pair(basis, coefs)
        return self._fg.points(b, c, points)

    def lines(self, basis, coefs, beg, end, num=100):
        """Fields along the segment beg -> end (FieldGenerator::lines)."""
        beg = np.asarray(beg, float)
        end = np.asarray(end, float)
        s = np.linspace(0.0, 1.0, int(num))[:, None]
        pts = beg[None, :] * (1 - s) + end[None, :] * s
        out = self.points(basis, coefs, pts)
        for t in out:
            out[t]["arc"] = (s[:, 0] * np.linalg.norm(end - beg))
        return out

    def file_lines(self, basis, coefs, beg, end, num, prefix, outdir="."):
        import os

        res = self.lines(basis, coefs, beg, end, num)
        paths = []
        for i, (t, fields) in enumerate(sorted(res.items())):
            p = os.path.join(outdir, f"{prefix}_{i:05d}.txt")
            cols = sorted(fields)
            data = np.stack([fields[k] for k in cols], axis=-1)
            np.savetxt(p, data, header=" ".join(cols))
            paths.append(p)
        return paths

    def file_slices(self, basis, coefs, prefix, outdir="."):
        b, c = _native_pair(basis, coefs)
        return self._fg.file_slices(b, c, prefix, outdir)

    def file_volumes(self, basis, coefs, prefix, outdir="."):
        b, c = _native_pair(basis, coefs)
        return self._fg.file_volumes(b, c, prefix, outdir)

    # -- histograms ----------------------------------------------------------

    def histo2d(self, reader_or_x, mass=None, axes=(0, 1)):
        x, m = self._particles(reader_or_x, mass)
        return self._fg.histo2d(x, m, axes)

    def histo1d(self, reader_or_x, mass=None, axis=0, nbins=64, log=False):
        """1D mass histogram along `axis` (FieldGenerator::histo1d)."""
        x, m = self._particles(reader_or_x, mass)
        v = np.asarray(x)[:, axis]
        lo = self._fg.pmin[axis]
        hi = self._fg.pmax[axis]
        if log:
            # |v| in log10 bins; the box bounds give only the upper edge
            # (a symmetric box would otherwise collapse the range to a
            # point), the lower edge comes from the data's smallest
            # positive |v|
            v = np.log10(np.maximum(np.abs(v), 1e-30))
            hi = np.log10(max(abs(lo), abs(hi), 1e-30))
            pos = v[v > -29.0]
            lo = float(pos.min()) if pos.size else hi - 6.0
        H, edges = np.histogram(v, bins=int(nbins), range=(lo, hi),
                                weights=np.asarray(m))
        return H, edges

    def histo1dlog(self, reader_or_x, mass=None, axis=0, nbins=64):
        return self.histo1d(reader_or_x, mass, axis, nbins, log=True)

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _particles(reader_or_x, mass):
        if hasattr(reader_or_x, "Particles"):
            m, x, _ = reader_or_x.Particles()
            return x, m
        return reader_or_x, mass

    def _apply_midplane(self, basis, coefs, fields):
        """Replace each 2D slice value with its value at the density-max
        z within +-colheight scale heights, and append a 'midplane'
        surface (FieldGenerator midplane machinery)."""
        h = getattr(basis.force, "hcyl", None) if hasattr(basis, "force") \
            else None
        if h is None:
            return fields
        pts, shape = self._fg._mesh()
        zs = np.linspace(-self._colheight * h, self._colheight * h, 17)
        # scan along the COLLAPSED axis (grid[c] == 0) — hard-coding z
        # would clobber a gridded coordinate for x-z / y-z slices
        scan_ax = next((c_ for c_ in range(3)
                        if not self._fg.grid[c_]), 2)
        c = coefs
        best = None
        bestz = None
        for z in zs:
            p = pts.copy()
            p[:, scan_ax] = z
            f = self._fg._fields_at(basis, c, p)
            d = f["dens"]
            if best is None:
                best = {k: v.copy() for k, v in f.items()}
                bestd = d.copy()
                bestz = np.full_like(d, z)
            else:
                sel = d > bestd
                for k in f:
                    best[k][sel] = f[k][sel]
                bestd[sel] = d[sel]
                bestz[sel] = z
        out = {k: v.reshape(shape) for k, v in best.items()}
        out["midplane"] = bestz.reshape(shape)
        return out
