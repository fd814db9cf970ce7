"""Shared helpers of the command-line tools (a jax-free copy of
`make_parser` and `load_model` from exp_tpu/cli/_common.py; the PSP
sequence helpers come with the tools that use them, ROADMAP item 14b)."""

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
