"""pspreal — convert a PSP file between float and double particle
records (utils/PhaseSpace/pspreal.cc): every dump in the input is
rewritten with rsize 4 (default) or 8 (--real8); SPL masters are
assembled to a monolithic output.

Port of exp_tpu/cli/pspreal.py: the same flags, lines and files."""

import os
import sys

from exp_tpu_torch.cli._common import make_parser


def main(argv=None):
    ap = make_parser("pspreal", __doc__)
    ap.add_argument("file", help="input PSP (OUT or SPL) file")
    ap.add_argument("-o", "--output", default=None,
                    help="output file (default: <input>.real[48])")
    ap.add_argument("-8", "--real8", action="store_true",
                    help="write double-precision records (default float)")
    ap.add_argument("-d", "--dir", default=None,
                    help="rewrite directory location for SPL files")
    a = ap.parse_args(argv)

    from exp_tpu_torch.io.psp import read_psp, read_spl, write_psp

    if "SPL" in os.path.basename(a.file):
        dumps = [read_spl(a.file, new_dir=a.dir)]
    else:
        # keep EVERY dump of a multi-dump OUT file (unlike the
        # single-snapshot read_psp_any sites)
        dumps = read_psp(a.file)
        if not isinstance(dumps, list):
            dumps = [dumps]
    out = a.output or a.file + (".real8" if a.real8 else ".real4")
    for i, d in enumerate(dumps):
        indexing = any(c.indx is not None for c in d.components)
        write_psp(out, d, real4=not a.real8, indexing=indexing,
                  append=i > 0)
    print(f"pspreal: wrote {len(dumps)} dump(s) to {out} "
          f"(rsize={8 if a.real8 else 4})")
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
