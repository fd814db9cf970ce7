"""tipstd2psp — translate a tipsy 'standard' (XDR) snapshot into PSP
(utils/PhaseSpace/tipstd2psp.cc): gas/dark/star records become PSP
components of the same names, phi carries into the pot field.  The
reverse direction is `snapconvert --to tipsy`.

Port of exp_tpu/cli/tipstd2psp.py: the same flags, lines and files."""

import sys

import numpy as np

from exp_tpu_torch.cli._common import make_parser


def main(argv=None):
    ap = make_parser("tipstd2psp", __doc__)
    ap.add_argument("input", help="tipsy standard binary file")
    ap.add_argument("output", help="PSP file to write")
    ap.add_argument("--time", type=float, default=None,
                    help="override the tipsy header time")
    a = ap.parse_args(argv)

    from exp_tpu_torch.io.psp import PSPComponent, PSPDump, write_psp
    from exp_tpu_torch.io.readers import read_tipsy

    s = read_tipsy(a.input)
    comps = []
    for name in s.GetTypes():
        c = s[name]
        pot = c["pot"] if c.get("pot") is not None \
            else np.zeros(len(c["mass"]))
        comps.append(PSPComponent(name=name, info=f"name: {name}\n",
                                  mass=c["mass"], x=c["x"], v=c["v"],
                                  pot=pot))
    time = a.time if a.time is not None else s.time
    write_psp(a.output, PSPDump(time=time, components=comps))
    print(f"wrote {a.output} ({sum(len(c.mass) for c in comps)} bodies, "
          f"{len(comps)} components, t={time:g})")
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
