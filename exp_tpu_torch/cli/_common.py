"""Shared helpers of the command-line tools (a jax-free copy of
exp_tpu/cli/_common.py: `make_parser`, `load_model`, `load_snapshot` and the
PSP-sequence helpers `add_sequence_args` / `iter_psp_sequence`)."""

from __future__ import annotations

import argparse


def make_parser(prog, desc):
    """The tool's parser.  Every tool accepts --cpu: the parsed namespace's
    `device` is then the CPU (the kernels' plain versions), else the CUDA
    card; with no card and no --cpu the tool refuses (exits with a usage
    error) before it does any work."""
    ap = argparse.ArgumentParser(prog=f"exp_tpu_torch {prog}",
                                 description=desc)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    orig_parse = ap.parse_args

    def parse_args(argv=None, namespace=None):
        from exp_tpu_torch import resolve_device

        a = orig_parse(argv, namespace)
        try:
            a.device = resolve_device("cpu" if a.cpu else None)
        except RuntimeError as e:
            ap.error(f"{e} (--cpu)")
        return a

    ap.parse_args = parse_args
    return ap


def load_model(name_or_file, rmin=1e-4, rmax=20.0, numr=2000):
    """Model file path, or a builtin name 'hernquist[:a=..,M=..]' etc."""
    from exp_tpu_torch.basis import model as M

    if ":" in str(name_or_file) or str(name_or_file) in (
            "hernquist", "plummer", "nfwtrunc", "king"):
        parts = str(name_or_file).split(":")
        kind = parts[0]
        kw = {}
        if len(parts) > 1:
            for item in parts[1].split(","):
                k, v = item.split("=")
                kw[k] = float(v)
        if kind == "hernquist":
            return M.hernquist_model(rmin=rmin, rmax=rmax, numr=numr, **kw)
        elif kind == "plummer":
            return M.plummer_model(rmin=rmin, rmax=rmax, numr=numr, **kw)
        elif kind == "nfwtrunc":
            return M.truncated_powerlaw_model(rmin=rmin, rmax=rmax,
                                              numr=numr, **kw)
        elif kind == "king":
            return M.king_model(numr=numr, **kw)
        raise SystemExit(f"unknown builtin model {kind!r}")
    return M.SphericalModelTable.from_file(name_or_file)


def add_sequence_args(ap, suffix_default):
    """The reference's PSP-sequence option block (psp2bess.cc /
    psp2lagu.cc / psp2rings.cc): iterate {type}.{runtag}.{n:05d}."""
    ap.add_argument("-i", "--beg", type=int, default=0,
                    help="initial snapshot index")
    ap.add_argument("-e", "--end", type=int, default=2 ** 31 - 1,
                    help="final snapshot index")
    ap.add_argument("-c", "--name", default="comp",
                    help="component name")
    ap.add_argument("-d", "--dir", default="./",
                    help="rewrite directory location for SPL files")
    ap.add_argument("-w", "--work", default=".",
                    help="working directory for the output file")
    ap.add_argument("-t", "--type", default="OUT",
                    help="PSP output type (OUT or SPL)")
    ap.add_argument("-T", "--runtag", default="run0")
    ap.add_argument("-s", "--suffix", default=suffix_default,
                    help="output file suffix")
    ap.add_argument("files", nargs="*",
                    help="explicit snapshot files (overrides the "
                         "runtag sequence)")


def iter_psp_sequence(a):
    """Yield (time, component) for each snapshot of the sequence."""
    import os

    from exp_tpu_torch.io.psp import read_psp_any

    if a.files:
        files = a.files
    else:
        files = []
        for n in range(a.beg, a.end + 1):
            f = f"{a.type}.{a.runtag}.{n:05d}"
            if not os.path.exists(f):
                break
            files.append(f)
    for f in files:
        dump = read_psp_any(f, new_dir=a.dir if a.dir != "./" else None)
        comp = next((c for c in dump.components if c.name == a.name),
                    None)
        if comp is None:
            if len(dump.components) == 1:
                comp = dump.components[0]
            else:
                raise SystemExit(f"{f}: no component named {a.name!r} "
                                 f"(has {[c.name for c in dump.components]})")
        yield dump.time, comp


def load_snapshot(path, kind=None):
    """A snapshot of `path` through io.readers.createReader: `kind` names
    the reader, else '.bods' / '.ascii' / '.txt' files are ascii bodies and
    the rest PSP."""
    from exp_tpu_torch.io.readers import createReader

    if kind is None:
        kind = "psp" if not str(path).endswith((".bods", ".ascii", ".txt")) \
            else "ascii"
    return createReader(kind, path)
