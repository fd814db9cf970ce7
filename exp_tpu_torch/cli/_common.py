"""Shared helpers of the command-line tools (a jax-free copy of
`load_model` from exp_tpu/cli/_common.py; the rest of that module comes
with the CLI tools, ROADMAP item 14)."""

from __future__ import annotations


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
