"""psp2vtu — PSP snapshot sequence -> XML VTK unstructured-grid point
files (utils/PhaseSpace/psp2vtu.cc): one .vtu per snapshot with per-point
masses, the ndatr columns as attribNN scalars, optional KNN density
(--dens N: mass of the N nearest neighbours over their bounding-sphere
volume), and velocities; each particle is a VTK_VERTEX cell.

Port of exp_tpu/cli/psp2vtu.py: the same flags, lines and files."""

import sys

import numpy as np

from exp_tpu_torch.cli._common import (add_sequence_args,
                                       iter_psp_sequence, make_parser)


def _vtu_write(path, x, arrays, vectors):
    """Minimal XML .vtu writer (ascii appended data): points + per-point
    scalar `arrays` {name: (n,)} and vector `vectors` {name: (n,3)},
    one VTK_VERTEX cell per point (psp2vtu.cc:184-312)."""
    n = len(x)

    def da(name, data, ncomp):
        flat = np.asarray(data, np.float32).reshape(n * ncomp)
        body = " ".join(repr(float(v)) for v in flat)
        return (f'<DataArray type="Float32" Name="{name}" '
                f'NumberOfComponents="{ncomp}" format="ascii">'
                f'{body}</DataArray>')

    point_data = [da(k, v, 1) for k, v in arrays.items()]
    point_data += [da(k, v, 3) for k, v in vectors.items()]
    conn = " ".join(str(i) for i in range(n))
    offs = " ".join(str(i + 1) for i in range(n))
    types = " ".join("1" for _ in range(n))    # VTK_VERTEX
    with open(path, "w") as fh:
        fh.write(
            '<?xml version="1.0"?>\n'
            '<VTKFile type="UnstructuredGrid" version="0.1" '
            'byte_order="LittleEndian">\n'
            '<UnstructuredGrid>\n'
            f'<Piece NumberOfPoints="{n}" NumberOfCells="{n}">\n'
            '<Points>' + da("points", x, 3) + '</Points>\n'
            '<PointData>' + "\n".join(point_data) + '</PointData>\n'
            '<Cells>'
            f'<DataArray type="Int64" Name="connectivity" format="ascii">'
            f'{conn}</DataArray>'
            f'<DataArray type="Int64" Name="offsets" format="ascii">'
            f'{offs}</DataArray>'
            f'<DataArray type="UInt8" Name="types" format="ascii">'
            f'{types}</DataArray>'
            '</Cells>\n'
            '</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')


def _knn_density(x, mass, ndens):
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(x, np.float64))
    d, idx = tree.query(x, k=ndens + 1)       # self + N neighbours
    msum = np.asarray(mass)[idx].sum(axis=1)
    vol = 4.0 / 3.0 * np.pi * np.maximum(d[:, -1], 1e-30) ** 3
    return msum / vol


def main(argv=None):
    ap = make_parser("psp2vtu", __doc__)
    add_sequence_args(ap, suffix_default="vtu")
    ap.add_argument("-N", "--dens", type=int, default=0,
                    help="KNN density with this many neighbours (0: off)")
    a = ap.parse_args(argv)

    nout = 0
    for time, comp in iter_psp_sequence(a):
        arrays = {"masses": comp.mass}
        if a.dens > 0:
            arrays["density"] = _knn_density(comp.x, comp.mass, a.dens)
        if comp.dattr is not None:
            for i in range(comp.dattr.shape[1]):
                arrays[f"attrib{i:02d}"] = comp.dattr[:, i]
        _vtu_write(f"{a.work}/{a.runtag}_{nout:05d}.{a.suffix}",
                   comp.x, arrays, {"velocities": comp.v})
        print(f"wrote {a.runtag}_{nout:05d}.{a.suffix} "
              f"({len(comp.mass)} points, t={time:g})")
        nout += 1
    return 0 if nout else 1


if __name__ == "__main__":
    sys.exit(main() or 0)
