"""psp2range — min/max of every phase-space field of a component
(utils/PhaseSpace/psp2range.cc): mass, position, velocity, potential
and any integer/double attribute columns, per input file.

Port of exp_tpu/cli/psp2range.py: the same flags, lines and files."""

import sys

from exp_tpu_torch.cli._common import make_parser


def _minmax(label, arr):
    import numpy as np

    a = np.asarray(arr)
    if a.ndim == 1:
        print(f"  {label:<10s} {a.min():14.6g} {a.max():14.6g}")
    else:
        for k in range(a.shape[1]):
            print(f"  {label}[{k}]{'':<5s} {a[:, k].min():14.6g} "
                  f"{a[:, k].max():14.6g}")


def main(argv=None):
    ap = make_parser("psp2range", __doc__)
    ap.add_argument("files", nargs="+", help="PSP (OUT or SPL) files")
    ap.add_argument("-c", "--name", default=None,
                    help="component name (default: all components)")
    ap.add_argument("-d", "--dir", default=None,
                    help="rewrite directory location for SPL files")
    a = ap.parse_args(argv)

    from exp_tpu_torch.io.psp import read_psp_any

    for f in a.files:
        dump = read_psp_any(f, new_dir=a.dir)
        print(f"{f}: time={dump.time:.8g}")
        for c in dump.components:
            if a.name is not None and c.name != a.name:
                continue
            print(f" component {c.name!r} ({len(c.mass)} bodies)"
                  f"{'':<6s}{'min':>9s} {'max':>14s}")
            _minmax("mass", c.mass)
            _minmax("pos", c.x)
            _minmax("vel", c.v)
            _minmax("pot", c.pot)
            if c.iattr is not None:
                _minmax("iatr", c.iattr)
            if c.dattr is not None:
                _minmax("datr", c.dattr)
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
