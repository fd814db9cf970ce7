"""Struct-of-arrays particle state (port of exp_tpu/nbody/particles.py,
single device; sharding and body-file I/O come with later slices)."""

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
