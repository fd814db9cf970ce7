"""Struct-of-arrays particle state and body-file I/O (port of
exp_tpu/nbody/particles.py on one device; sharding comes with the
multi-device slice, ROADMAP item 12).

Body-file format matches the reference ascii convention
(Component::read_bodies_and_distribute_ascii, src/Component.cc:1480-1520):
    line 1: <nbodies> <niattrib> <ndattrib>
    then  : mass x y z u v w [iattr...] [dattr...]
PSP binary snapshots (io/psp.py) are read too, sniffed by their magic.
The ascii reader is NumPy's loadtxt: exp_tpu's native strtod parser
(exp_tpu/native) comes with ROADMAP item 14.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from exp_tpu_torch import resolve_device


@dataclass
class ParticleSystem:
    """Particle state as tensors on one device.

    x, v, acc: (N, 3); mass, pot: (N,).  level: (N,) int32 multistep
    level; indx: (N,) int32 1-based particle identity (0 marks zero-mass
    padding rows); scale: (N,) per-particle size scale for the `dts`
    timestep criterion (<= 0 means ignore).
    """

    x: torch.Tensor
    v: torch.Tensor
    mass: torch.Tensor
    acc: torch.Tensor
    pot: torch.Tensor
    level: torch.Tensor
    indx: torch.Tensor
    scale: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @classmethod
    def from_arrays(cls, x, v, mass, dtype=torch.float32,
                    pad_to: int | None = None, indx=None, scale=None,
                    device=None) -> "ParticleSystem":
        """State from host arrays on `device` (None: CUDA, raising when
        there is none); `pad_to` appends zero-mass rows at the origin up
        to a multiple of it."""
        device = resolve_device(device)
        x = np.asarray(x, dtype=np.float64)
        v = np.asarray(v, dtype=np.float64)
        mass = np.asarray(mass, dtype=np.float64)
        n = x.shape[0]
        ix = (np.arange(1, n + 1, dtype=np.int32) if indx is None
              else np.asarray(indx, dtype=np.int32))
        sc = (np.full(n, -1.0) if scale is None
              else np.asarray(scale, dtype=np.float64))
        if pad_to is not None and n % pad_to:
            npad = pad_to - n % pad_to
            x = np.concatenate([x, np.zeros((npad, 3))])
            v = np.concatenate([v, np.zeros((npad, 3))])
            mass = np.concatenate([mass, np.zeros(npad)])
            ix = np.concatenate([ix, np.zeros(npad, np.int32)])
            sc = np.concatenate([sc, np.full(npad, -1.0)])
        m = x.shape[0]

        def tens(a, dt=dtype):
            # a copy: the steps update the state in place, and as_tensor
            # would share a CPU f64 array with the caller
            return torch.tensor(a, dtype=dt, device=device)

        return cls(x=tens(x), v=tens(v), mass=tens(mass),
                   acc=torch.zeros((m, 3), dtype=dtype, device=device),
                   pot=torch.zeros((m,), dtype=dtype, device=device),
                   level=torch.zeros((m,), dtype=torch.int32, device=device),
                   indx=tens(ix, torch.int32), scale=tens(sc))


def _host(a):
    """A host NumPy array of a tensor (any device) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def read_ascii_arrays(path):
    """Host-side ascii body read: (x (n,3), v (n,3), mass (n,)) NumPy,
    f64; columns past the seventh (attributes) are not read."""
    with open(path) as f:
        n = int(f.readline().split()[0])
        data = np.loadtxt(f, max_rows=n, usecols=range(7), ndmin=2)
    if len(data) != n:
        raise ValueError(f"{path}: expected {n} rows, parsed {len(data)}")
    return data[:, 1:4], data[:, 4:7], data[:, 0]


def read_ascii_dattr(path, k: int):
    """Host-side read of dattr column `k` (0-based) of an ascii bodyfile:
    columns are `mass x y z u v w [iattr...] [dattr...]` with the counts in
    the header (Component::read_bodies_and_distribute_ascii)."""
    with open(path) as f:
        header = f.readline().split()
        n, niattrib, ndattrib = (int(header[0]), int(header[1]),
                                 int(header[2]))
        if k < 0 or k >= ndattrib:
            raise ValueError(f"{path}: dattr index {k} out of range "
                             f"(ndattrib={ndattrib})")
        data = np.loadtxt(f, max_rows=n, usecols=(7 + niattrib + k,))
    return np.atleast_1d(data)


def read_ascii_bodies(path, dtype=torch.float32, pad_to=None,
                      scale_dattr: int | None = None,
                      device=None) -> ParticleSystem:
    x, v, mass = read_ascii_arrays(path)
    scale = (read_ascii_dattr(path, scale_dattr)
             if scale_dattr is not None else None)
    return ParticleSystem.from_arrays(x, v, mass, dtype=dtype, pad_to=pad_to,
                                      scale=scale, device=device)


def is_psp_file(path) -> bool:
    """Sniff the PSP binary magic: MasterHeader is 16 bytes (f64 time,
    i32 ntot, i32 ncomp) followed by the first component's cmagic
    0xadbfabc0|rsize (include/header.H; ParticleReader.H:338-340)."""
    from exp_tpu_torch.io.psp import MMASK, PSP_MAGIC

    try:
        with open(path, "rb") as f:
            head = f.read(24)
        if len(head) < 24:
            return False
        cmagic = int(np.frombuffer(head, np.uint64, 1, 16)[0])
        return (cmagic & ~MMASK) == PSP_MAGIC
    except OSError:
        return False


def read_bodies(path, dtype=torch.float32, pad_to=None,
                component: str | None = None,
                scale_dattr: int | None = None,
                device=None) -> ParticleSystem:
    """Read a body file on `device` (None: CUDA, raising when there is
    none), sniffing the format: reference ascii bodyfiles and PSP binary
    phase-space files both work (Component.H:202-204).

    `component`: for multi-component PSP files, select the named component
    (default: single component required).
    `scale_dattr`: 0-based dattr column holding the per-particle `scale`
    for the dts timestep criterion (Particle.H:60-61)."""
    if not is_psp_file(path):
        return read_ascii_bodies(path, dtype=dtype, pad_to=pad_to,
                                 scale_dattr=scale_dattr, device=device)

    from exp_tpu_torch.io.psp import read_psp

    dump = read_psp(path)
    if isinstance(dump, list):              # OUT. multi-dump: use the last
        dump = dump[-1]
    comps = dump.components
    match = [c for c in comps if component is not None
             and c.name == component]
    if match:
        c = match[0]
    elif len(comps) == 1:
        c = comps[0]
    else:
        raise ValueError(
            f"{path}: {len(comps)} components "
            f"({[c.name for c in comps]}) and none named {component!r}")
    scale = (c.dattr[:, scale_dattr]
             if scale_dattr is not None and c.dattr is not None else None)
    return ParticleSystem.from_arrays(c.x, c.v, c.mass, dtype=dtype,
                                      pad_to=pad_to, indx=c.indx,
                                      scale=scale, device=device)


def write_ascii_bodies(path, ps_or_arrays, niattrib=0, ndattrib=0):
    """Write live bodies (a ParticleSystem of tensors or NumPy arrays, or
    (x, v, mass)) as a reference ascii body file, %.16e (exact in f64)."""
    if isinstance(ps_or_arrays, ParticleSystem):
        mass = _host(ps_or_arrays.mass)
        live = mass > 0
        x = _host(ps_or_arrays.x)[live]
        v = _host(ps_or_arrays.v)[live]
        mass = mass[live]
    else:
        x, v, mass = (_host(a) for a in ps_or_arrays)
    table = np.column_stack([mass, x, v])
    with open(path, "w") as f:
        f.write(f"{len(mass)} {niattrib} {ndattrib}\n")
        np.savetxt(f, table, fmt="%.16e")
