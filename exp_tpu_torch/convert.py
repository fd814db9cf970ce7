"""Carry the JAX package's parameters into the port's objects.

The JAX objects are handed over as plain NumPy arrays and Python scalars
(for example `dataclasses.asdict` of an `exp_tpu.basis.slgrid.SphSLTables`),
so this module imports nothing of `exp_tpu` or `jax`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from exp_tpu_torch.basis.slgrid import SphSLTables

_INT = ("lmax", "nmax", "numr", "cmap")
_FLOAT = ("rmap", "rmin", "rmax", "xmin", "xmax", "dxi")
_ARRAY = ("xi", "r", "p0", "d0", "ev", "ef")


def sph_tables_from_numpy(d: dict) -> SphSLTables:
    """The port's SphSLTables from the fields of the JAX package's
    SphSLTables, given as a dict of arrays and scalars.  The arrays are
    copied as f64, so both packages compute from identical tables."""
    names = {f.name for f in dataclasses.fields(SphSLTables)}
    unknown = set(d) - names
    missing = set(_INT + _FLOAT + _ARRAY) - set(d)
    if unknown or missing:
        raise ValueError(f"SphSLTables fields: unknown {sorted(unknown)}, "
                         f"missing {sorted(missing)}")
    kw = {k: int(d[k]) for k in _INT}
    kw.update({k: float(d[k]) for k in _FLOAT})
    kw.update({k: np.array(d[k], dtype=np.float64) for k in _ARRAY})
    kw["model_key"] = str(d.get("model_key", ""))
    return SphSLTables(**kw)
