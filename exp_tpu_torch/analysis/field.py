"""Field rendering (port of exp_tpu/analysis/field.py; pyEXP `field`
submodule).

The analogue of expui/FieldGenerator (FieldGenerator.H:14-150): evaluate
density/potential/force fields from (basis, coefficients) on 2D slices, 3D
volumes, arbitrary point sets, and over time — one batched evaluation a
time on the basis's device (Basis.get_fields: the force kernel, K2 or K5
under `backend: pallas`) instead of the reference's MPI time-partitioning
(FieldGenerator.cc:186-230).  The grids, the VTK and the PVD files are
exp_tpu's, byte for byte for the same arrays.
"""

from __future__ import annotations

import numpy as np


FIELD_NAMES = ("dens", "potl", "accx", "accy", "accz")


class FieldGenerator:
    """Render fields for a list of times.

    Args:
      times: times to render.
      pmin, pmax: lower/upper corners of the grid box (3,).
      grid: number of knots per axis (3,); a 0 entry collapses that axis
            (making a 2D slice) — same convention as the reference.
    """

    def __init__(self, times, pmin, pmax, grid):
        self.times = list(times)
        self.pmin = np.asarray(pmin, dtype=float)
        self.pmax = np.asarray(pmax, dtype=float)
        self.grid = list(grid)

    def _mesh(self):
        axes = []
        shape = []
        for c in range(3):
            n = self.grid[c]
            if n and n > 0:
                axes.append(np.linspace(self.pmin[c], self.pmax[c], n))
                shape.append(n)
            else:
                axes.append(np.array([0.5 * (self.pmin[c] + self.pmax[c])]))
        M = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([m.ravel() for m in M], axis=-1)
        return pts, tuple(s for s in shape)

    def _fields_at(self, basis, coef, pts):
        dens, pot, acc = basis.get_fields(coef, pts)
        return {"dens": dens, "potl": pot, "accx": acc[:, 0],
                "accy": acc[:, 1], "accz": acc[:, 2]}

    def slices(self, basis, coefs):
        """dict time -> dict field -> 2D array (FieldGenerator::slices)."""
        pts, shape = self._mesh()
        out = {}
        for t in self.times:
            c = coefs.interpolate(t) if hasattr(coefs, "interpolate") else coefs
            f = self._fields_at(basis, c, pts)
            out[t] = {k: v.reshape(shape) for k, v in f.items()}
        return out

    def volumes(self, basis, coefs):
        """dict time -> dict field -> 3D array."""
        return self.slices(basis, coefs)

    def points(self, basis, coefs, points):
        """dict time -> dict field -> (N,) array at arbitrary points."""
        pts = np.asarray(points, dtype=float)
        out = {}
        for t in self.times:
            c = coefs.interpolate(t) if hasattr(coefs, "interpolate") else coefs
            out[t] = self._fields_at(basis, c, pts)
        return out

    def file_slices(self, basis, coefs, prefix, outdir="."):
        """Render slices for every time and write legacy-VTK files plus a
        ParaView .pvd time-series index (the reference's
        FieldGenerator::file_slices via VtkGrid + writePVD,
        exputil VtkGrid.H / writePVD.cc)."""
        return self._file_fields(self.slices(basis, coefs), prefix, outdir)

    def file_volumes(self, basis, coefs, prefix, outdir="."):
        """3D volume analogue of file_slices (FieldGenerator::file_volumes)."""
        return self._file_fields(self.volumes(basis, coefs), prefix, outdir)

    def _file_fields(self, rendered, prefix, outdir):
        import os

        paths = []
        for i, (t, fields) in enumerate(sorted(rendered.items())):
            p = os.path.join(outdir, f"{prefix}_{i:05d}.vtk")
            kept = tuple(c for c in range(3)
                         if self.grid[c] and self.grid[c] > 0)
            write_vtk(p, fields, self.pmin, self.pmax, axes=kept)
            paths.append((t, p))
        pvd = os.path.join(outdir, f"{prefix}.pvd")
        write_pvd(pvd, paths)
        return [p for _, p in paths] + [pvd]

    def histo2d(self, x, mass, axes=(0, 1)):
        """Particle surface-density histogram on the grid
        (FieldGenerator::histogram analogue)."""
        a, b = axes
        na = self.grid[a] or 64
        nb = self.grid[b] or 64
        H, xe, ye = np.histogram2d(
            np.asarray(x)[:, a], np.asarray(x)[:, b],
            bins=[na, nb],
            range=[[self.pmin[a], self.pmax[a]], [self.pmin[b], self.pmax[b]]],
            weights=np.asarray(mass))
        dA = (xe[1] - xe[0]) * (ye[1] - ye[0])
        return H / dA


def write_vtk(path, fields, pmin, pmax, axes=None):
    """Legacy-VTK STRUCTURED_POINTS writer (exputil VtkGrid analogue):
    each entry of `fields` (name -> 1/2/3-D array) becomes a scalar
    point-data field; collapsed axes get a single plane.

    `axes`: the world-axis index of each array dimension (e.g. (1, 2)
    for a y-z slice).  Default: the leading world axes — correct for 3-D
    volumes and x-y slices, wrong for x-z / y-z slices, which must say
    which axes survived."""
    names = list(fields)
    a0 = np.asarray(fields[names[0]])
    if axes is None:
        axes = tuple(range(a0.ndim))
    pmin = np.asarray(pmin, dtype=float)
    pmax = np.asarray(pmax, dtype=float)
    shape = [1, 1, 1]
    for dim, world in zip(a0.shape, axes):
        shape[world] = dim
    spacing = [(pmax[c] - pmin[c]) / max(shape[c] - 1, 1) for c in range(3)]
    npts = int(np.prod(shape))
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n"
                "exp_tpu field\nASCII\nDATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {shape[0]} {shape[1]} {shape[2]}\n")
        f.write(f"ORIGIN {pmin[0]:g} {pmin[1]:g} {pmin[2]:g}\n")
        f.write(f"SPACING {spacing[0]:g} {spacing[1]:g} {spacing[2]:g}\n")
        f.write(f"POINT_DATA {npts}\n")
        for name in names:
            a = np.asarray(fields[name]).reshape(shape)
            # VTK point order: x fastest -> write Fortran-ravelled
            flat = a.ravel(order="F")
            f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
            for i in range(0, npts, 8):
                f.write(" ".join(f"{v:.6e}" for v in flat[i:i + 8]) + "\n")


def write_pvd(path, time_paths):
    """ParaView collection (.pvd) time-series index (exputil writePVD.cc)."""
    import os

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n'
                '<VTKFile type="Collection" version="0.1">\n'
                '  <Collection>\n')
        for t, p in time_paths:
            f.write(f'    <DataSet timestep="{t:g}" part="0" '
                    f'file="{os.path.basename(p)}"/>\n')
        f.write('  </Collection>\n</VTKFile>\n')
