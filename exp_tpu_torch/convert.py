"""Carry the JAX package's parameters into the port's objects.

The JAX objects are handed over as plain NumPy arrays and Python scalars
(for example `dataclasses.asdict` of an `exp_tpu.basis.slgrid.SphSLTables`),
or as objects whose fields NumPy can read (a multistep runner's buckets),
so this module imports nothing of `exp_tpu` or `jax`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from exp_tpu_torch import resolve_device
from exp_tpu_torch.basis.empcyl import EmpCylTables
from exp_tpu_torch.basis.slab import SlabTables
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


_CYL_INT = ("mmax", "nmax", "numx", "numy")
_CYL_FLOAT = ("acyl", "hcyl", "rcylmin", "rcylmax", "xmin", "xmax", "dx",
              "ymin", "ymax", "dy")
_CYL_ARRAY = ("pot", "rforce", "zforce", "dens")


def cyl_tables_from_numpy(d: dict) -> EmpCylTables:
    """The port's EmpCylTables from the fields of the JAX package's
    EmpCylTables (EOF or flatdisk), given as a dict of arrays and scalars
    (`dataclasses.asdict`).  The tables are copied as f64."""
    names = {f.name for f in dataclasses.fields(EmpCylTables)}
    unknown = set(d) - names
    missing = set(_CYL_INT + _CYL_FLOAT + _CYL_ARRAY + ("even_count",)) - set(d)
    if unknown or missing:
        raise ValueError(f"EmpCylTables fields: unknown {sorted(unknown)}, "
                         f"missing {sorted(missing)}")
    kw = {k: int(d[k]) for k in _CYL_INT}
    kw.update({k: float(d[k]) for k in _CYL_FLOAT})
    kw.update({k: np.array(d[k], dtype=np.float64) for k in _CYL_ARRAY})
    kw["even_count"] = np.array(d["even_count"], dtype=np.int64)
    kw["key"] = str(d.get("key", ""))
    return EmpCylTables(**kw)


_SLAB_INT = ("nmaxx", "nmaxy", "nmax", "numz")
_SLAB_FLOAT = ("zmax", "h")
_SLAB_ARRAY = ("phi", "dphi", "dens", "zgrid", "sgn")


def slab_tables_from_numpy(d: dict) -> SlabTables:
    """The port's SlabTables from the fields of the JAX package's
    SlabTables, given as a dict of arrays and scalars
    (`dataclasses.asdict`).  The tables are copied as f64."""
    names = {f.name for f in dataclasses.fields(SlabTables)}
    unknown = set(d) - names
    missing = set(_SLAB_INT + _SLAB_FLOAT + _SLAB_ARRAY) - set(d)
    if unknown or missing:
        raise ValueError(f"SlabTables fields: unknown {sorted(unknown)}, "
                         f"missing {sorted(missing)}")
    kw = {k: int(d[k]) for k in _SLAB_INT}
    kw.update({k: float(d[k]) for k in _SLAB_FLOAT})
    kw.update({k: np.array(d[k], dtype=np.float64) for k in _SLAB_ARRAY})
    kw["key"] = str(d.get("key", ""))
    return SlabTables(**kw)


def cube_from_numpy(norm, lap, nmaxx, nmaxy, nmaxz, nminx=0, nminy=0,
                    nminz=0, dtype=torch.float32, backend="einsum",
                    pallas_precision="mixed", pallas_version=2, device=None):
    """The port's Cube from the JAX Cube's arrays (`norm`, `lap`, as NumPy)
    and its static fields, on `device` (None: CUDA, raising when there is
    none)."""
    from exp_tpu_torch.forces.cube import Cube

    device = resolve_device(device)
    shape = (2 * nmaxx + 1, 2 * nmaxy + 1, 2 * nmaxz + 1)
    arrays = {"norm": np.array(norm), "lap": np.array(lap)}
    for name, a in arrays.items():
        if a.shape != shape:
            raise ValueError(f"{name} has shape {a.shape}, expected {shape}")
    return Cube(norm=torch.as_tensor(arrays["norm"], dtype=dtype,
                                     device=device),
                lap=torch.as_tensor(arrays["lap"], dtype=dtype, device=device),
                nmaxx=nmaxx, nmaxy=nmaxy, nmaxz=nmaxz, nminx=nminx,
                nminy=nminy, nminz=nminz, backend=backend,
                pallas_precision=pallas_precision,
                pallas_version=pallas_version)


_PS_FIELDS = ("x", "v", "mass", "acc", "pot", "level", "indx", "scale")


def buckets_from_numpy(buckets, regs=None, device=None):
    """The port's multistep buckets from a JAX runner's, on `device` (None:
    CUDA, raising when there is none): `buckets` is a LevelBuckets (its
    `.buckets`) or a sequence of bucket ParticleSystems, whose fields are
    read as NumPy arrays and kept in their dtypes (`level` and `indx`
    int32).  With `regs`, the component's (L, N) register sequences, returns
    (buckets, [L list, N list]) for MultistepRunner.bigstep."""
    from exp_tpu_torch.nbody.particles import ParticleSystem

    device = resolve_device(device)
    out = []
    for b in getattr(buckets, "buckets", buckets):
        f = {k: np.array(getattr(b, k)) for k in _PS_FIELDS}
        for k in ("level", "indx"):
            if f[k].dtype != np.int32:
                raise TypeError(f"bucket {k} has dtype {f[k].dtype}, "
                                "expected int32")
        out.append(ParticleSystem(**{k: torch.as_tensor(a, device=device)
                                     for k, a in f.items()}))
    if regs is None:
        return out
    return out, [[torch.as_tensor(np.array(c), device=device) for c in side]
                 for side in regs]


def complex_from_numpy(a, dtype=None, device=None) -> torch.Tensor:
    """A complex NumPy array (for example a JAX Cube's coefficients, via
    np.asarray) as a complex tensor on `device` (None: CUDA, raising when
    there is none); `dtype` defaults to the array's own (complex64 or
    complex128)."""
    a = np.array(a)
    if not np.iscomplexobj(a):
        raise TypeError(f"expected a complex array, got {a.dtype}")
    return torch.as_tensor(a, dtype=dtype, device=resolve_device(device))
