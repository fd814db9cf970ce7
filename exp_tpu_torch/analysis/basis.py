"""Basis factory + coefficient creation (port of exp_tpu/analysis/basis.py;
pyEXP `basis` submodule).

The analogue of expui BasisFactory/BiorthBasis (expui/BasisFactory.H:247
Basis::factory; BiorthBasis.cc:4517 createFromReader;
BiorthBasis.H:258-275 initFromArray/addFromArray/makeFromArray): build a
basis from a YAML stanza and project particle snapshots onto it.

The force objects of the N-body driver (nbody/simulation.build_force) do
the math, so analysis and simulation share one kernel path: with `backend:
pallas` a projection launches the coefficient kernel (K1, K4, K7, K9) and a
field evaluation the force kernel (K2, K5, K8, K10).  Host arrays go to the
force's device one transfer each (`upload`) and results come back in one
download (`download`).
"""

from __future__ import annotations

import numpy as np
import torch

from exp_tpu_torch.config import ForceConfig
from exp_tpu_torch.nbody.simulation import _fetch, build_force


def force_device(force) -> torch.device:
    """The device a force runs on: where its tables live, else the device
    `build_force` built it for.  A force with neither raises: the analysis
    never picks a device on its own."""
    if isinstance(force, torch.nn.Module):
        for b in force.buffers():
            return b.device
    dev = getattr(force, "device", None)
    if dev is None:
        raise ValueError(
            f"{type(force).__name__} has no tables and no device: build it "
            "with nbody.simulation.build_force or Basis.factory, which take "
            "device=")
    return torch.device(dev)


def upload(device, *arrays):
    """Tensors on `device` of host arrays or tensors, one transfer each,
    each in its own dtype; None stays None."""
    def one(a):
        if a is None or isinstance(a, torch.Tensor):
            return a if a is None else a.to(device)
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(
            device)

    return tuple(one(a) for a in arrays)


def download(tree):
    """A tensor, or a dict/tuple of tensors, as NumPy arrays in one
    device-to-host transfer (nbody/simulation._fetch)."""
    if isinstance(tree, torch.Tensor):
        return _fetch((tree,))[0]
    return _fetch(tree)


class Basis:
    """User-facing basis wrapper: force object + metadata."""

    def __init__(self, force, name="", config=None):
        self.force = force
        self.name = name
        self.config = config or {}

    @property
    def device(self) -> torch.device:
        return force_device(self.force)

    # -- factory ------------------------------------------------------------

    @staticmethod
    def factory(conf, workdir=".", dtype=torch.float64,
                device=None) -> "Basis":
        """Build from a YAML string/dict: {id: ..., parameters: {...}}
        (Basis::factory, BasisFactory.H:247) on `device` (None: CUDA,
        raising when there is none)."""
        if isinstance(conf, str):
            import yaml

            conf = yaml.safe_load(conf)
        fid = conf.get("id")
        params = conf.get("parameters") or {}
        force = build_force(ForceConfig(id=fid, parameters=dict(params)),
                            dtype, workdir=workdir, device=device)
        return Basis(force, name=conf.get("name", fid), config=conf)

    # -- coefficient creation ----------------------------------------------

    def create_coefficients(self, x, mass, time=0.0, center=None,
                            accum_dtype=torch.float64):
        """Project one snapshot; returns the raw coefficient array
        (createFromArray, BiorthBasis.H:258-275)."""
        if np.ndim(mass) == 0 and not isinstance(mass, torch.Tensor):
            x, = upload(self.device, x)
            m = torch.full((x.shape[0],), float(mass), dtype=x.dtype,
                           device=x.device)
        else:
            x, m = upload(self.device, x, mass)
        if center is not None:
            x = x - torch.as_tensor(np.asarray(center), dtype=x.dtype,
                                    device=x.device)
        return download(self.force.coefficients(x, m,
                                                accum_dtype=accum_dtype))

    def create_from_snapshots(self, snaps, times=None, centers=None,
                              accum_dtype=torch.float64):
        """Project a sequence of (x, mass) snapshots -> analysis.coefs.Coefs
        (createFromReader, BiorthBasis.cc:4517-4582)."""
        from exp_tpu_torch.analysis.coefs import Coefs

        out = Coefs(geometry=self.geometry, name=self.name,
                    meta=self._meta())
        for i, (x, mass) in enumerate(snaps):
            t = float(times[i]) if times is not None else float(i)
            c = self.create_coefficients(
                x, mass, time=t,
                center=None if centers is None else centers[i],
                accum_dtype=accum_dtype)
            out.add(t, c)
        return out

    # -- field evaluation ---------------------------------------------------

    def get_fields(self, coef, points):
        """Evaluate (dens, pot, acc) at points (getFields analogue)."""
        pts, coef = upload(self.device, points, coef)
        acc, pot = self.force.acceleration(coef, pts)
        dens = self.force.density(coef, pts)
        return download((dens, pot, acc))

    @property
    def geometry(self):
        from exp_tpu_torch.forces.cube import Cube
        from exp_tpu_torch.forces.cylinder import CylinderForce
        from exp_tpu_torch.forces.slab import SlabForce

        if isinstance(self.force, Cube):
            return "cube"
        if isinstance(self.force, CylinderForce):
            return "cylinder"
        if isinstance(self.force, SlabForce):
            return "slab"
        return "sphere"

    def _meta(self):
        f = self.force
        g = self.geometry
        if g == "sphere":
            return {"lmax": f.lmax, "nmax": f.nmax,
                    "scale": getattr(f, "scale", 1.0)}
        if g == "cylinder":
            return {"mmax": f.mmax, "nmax": f.nmax}
        if g == "slab":
            return {"nmaxx": f.nmaxx, "nmaxy": f.nmaxy, "nmaxz": f.nmax}
        return {"nmaxx": f.nmaxx, "nmaxy": f.nmaxy, "nmaxz": f.nmaxz}
