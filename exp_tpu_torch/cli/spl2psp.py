"""spl2psp — assemble monolithic PSP files from split SPL sets
(utils/PhaseSpace/spl2psp.cc): each SPL.{runtag}.{seq:05d} master +
per-node blobs becomes one {prefix}.{runtag}.{seq:05d} file; --checkpoint
converts SPL.{runtag}.chkpt instead.

Port of exp_tpu/cli/spl2psp.py: the same flags, lines and files."""

import os
import sys

from exp_tpu_torch.cli._common import make_parser


def main(argv=None):
    ap = make_parser("spl2psp", __doc__)
    ap.add_argument("-d", "--dir", default=".",
                    help="input/output directory")
    ap.add_argument("-r", "--runtag", default="run0")
    ap.add_argument("-p", "--prefix", default="OUT",
                    help="output file prefix")
    ap.add_argument("-s", "--seq", type=int, default=0,
                    help="sequence index (single-file mode)")
    ap.add_argument("-1", "--first", type=int, default=None,
                    help="first index of a sequence range")
    ap.add_argument("-2", "--last", type=int, default=None,
                    help="final index of a sequence range")
    ap.add_argument("-c", "--checkpoint", action="store_true",
                    help="convert the SPL checkpoint file")
    a = ap.parse_args(argv)

    from exp_tpu_torch.io.psp import read_spl, write_psp

    if a.checkpoint:
        names = [("SPL.%s.chkpt" % a.runtag,
                  "%s.%s.chkpt" % (a.prefix, a.runtag))]
    else:
        beg = a.seq if a.first is None else a.first
        end = a.seq if a.last is None else a.last
        names = [(f"SPL.{a.runtag}.{n:05d}", f"{a.prefix}.{a.runtag}.{n:05d}")
                 for n in range(beg, end + 1)]
    ndone = 0
    for src, dst in names:
        src = os.path.join(a.dir, src)
        if not os.path.exists(src):
            print(f"spl2psp: can't open master file <{src}>",
                  file=sys.stderr)
            return 1
        dump = read_spl(src)
        indexing = any(c.indx is not None for c in dump.components)
        write_psp(os.path.join(a.dir, dst), dump, indexing=indexing)
        ndone += 1
    print(f"spl2psp: wrote {ndone} PSP file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
