"""Field expansions over particle attributes (port of
exp_tpu/analysis/field_basis.py; the reference's FieldBasis /
VelocityBasis, expui/FieldBasis.H:23-186, FieldBasis.cc:330-400 — powers
OutVel).

Any per-particle quantity f is projected with the same spherical-harmonic x
radial biorthogonal machinery as the mass density (the reference projects
onto Ylm x OrthoFunction; here the force basis supplies the same
Ylm x radial-table span, shared with the N-body kernels):

    d^f_k = -4 pi sum_i m_i f_i Phi_k(x_i)

The pointwise field estimate is the density-weighted ratio

    f(x) ~ sum_k d^f_k D_k(x) / sum_k d^1_k D_k(x)

(i.e. the BFE representation of rho*f divided by the BFE representation of
rho) — the mass-weighted mean field.  VelocityBasis field sets
(FieldBasis.cc fieldFunc):
  cartesian:   vx, vy, vz
  spherical:   vr, vt (v_theta), vp (v_phi)
  cylindrical: vR, vp, vz
plus v2 (speed squared).

The per-particle values and the projections run on the force's device (one
upload of x, v and mass a snapshot; under `backend: pallas` one launch of
the coefficient kernel a field), the results come back in one download.
"""

from __future__ import annotations

import numpy as np
import torch

from exp_tpu_torch.analysis.basis import download, force_device, upload

#: field name -> callable (x, v) -> per-particle value
_SPHERICAL = ("vr", "vt", "vp")
_CYLINDRICAL = ("vR", "vp", "vz")


def _field_value(name, x, v):
    if name == "vx":
        return v[:, 0]
    if name == "vy":
        return v[:, 1]
    if name == "vz":
        return v[:, 2]
    if name == "v2":
        return torch.sum(v * v, dim=1)
    R = torch.sqrt(x[:, 0] ** 2 + x[:, 1] ** 2) + 1e-18
    if name == "vR":
        return (x[:, 0] * v[:, 0] + x[:, 1] * v[:, 1]) / R
    if name == "vp":
        return (x[:, 0] * v[:, 1] - x[:, 1] * v[:, 0]) / R
    r = torch.sqrt(torch.sum(x * x, dim=1)) + 1e-18
    if name == "vr":
        return torch.sum(x * v, dim=1) / r
    if name == "vt":
        # v_theta = (cos(th) v_R - sin(th) v_z); cos(th)=z/r, sin(th)=R/r
        vR = (x[:, 0] * v[:, 0] + x[:, 1] * v[:, 1]) / R
        return (x[:, 2] * vR - R * v[:, 2]) / r
    raise ValueError(f"unknown field {name!r}")


class FieldBasis:
    """Expand per-particle fields over a force basis.

    `fields`: any of vx/vy/vz/v2 (cartesian), vr/vt/vp (spherical),
    vR/vp/vz (cylindrical), or "spherical"/"cylindrical"/"cartesian" as a
    shorthand for the corresponding velocity set (VelocityBasis)."""

    def __init__(self, force, fields=("vx", "vy", "vz")):
        if isinstance(fields, str):
            fields = {"spherical": _SPHERICAL, "cylindrical": _CYLINDRICAL,
                      "cartesian": ("vx", "vy", "vz")}[fields]
        self.force = force
        self.fields = tuple(fields)
        self.custom = {}    # label -> vectorized fn(x, v) -> (N,)

    def add_field(self, label, fn):
        """Register a derived phase-space field: vectorized
        fn(x (N,3), v (N,3), mass (N,)) -> (N,) (the reference's
        addPSFunction, FieldBasis.cc:41)."""
        self.custom[str(label)] = fn
        self.fields = self.fields + (str(label),)

    def coefficients(self, x, v, mass, accum_dtype=torch.float64):
        """Returns dict: 'dens' + each field name -> coefficient tensor on
        the force's device."""
        host = None
        if self.custom:     # a custom field is a host function
            host = [a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a) for a in (x, v, mass)]
        x, v, m = upload(force_device(self.force), x, v, mass)
        out = {"dens": self.force.coefficients(x, m,
                                               accum_dtype=accum_dtype)}
        for f in self.fields:
            if f in self.custom:
                w = m * upload(m.device, self.custom[f](*host))[0]
            else:
                w = m * _field_value(f, x, v)
            out[f] = self.force.coefficients(x, w, accum_dtype=accum_dtype)
        return out

    def create_from_snapshots(self, snaps, accum_dtype=torch.float64):
        """Project (x, v, mass) snapshots -> dict field -> (T, ...) array
        (the reference's createFromReader over a VelocityBasis)."""
        series = None
        for x, v, mass in snaps:
            c = download(self.coefficients(x, v, mass,
                                           accum_dtype=accum_dtype))
            if series is None:
                series = {k: [] for k in c}
            for k, val in c.items():
                series[k].append(val)
        return {k: np.stack(vs) for k, vs in series.items()}

    def write_coefs(self, path, times, series, name=""):
        """Write a create_from_snapshots result to a field coefficient file
        (SphFldCoefs/CylFldCoefs schema — io.coefs field files)."""
        from exp_tpu_torch.io.coefs import (CylFldCoefsFile,
                                            SphFldCoefsFile,
                                            pack_sph_matrix)

        labels = ["dens"] + [f for f in self.fields]
        first = series[labels[0]]
        if first.ndim == 5:        # (T, 2, L+1, L+1, nmax): spherical
            angmax = first.shape[2] - 1
            nmax = first.shape[4]
            f = SphFldCoefsFile(path, "w", name=name, nfld=len(labels),
                                angmax=angmax, nmax=nmax, labels=labels)
            pack = pack_sph_matrix
        elif first.ndim == 4 and first.shape[1] == 2:
            # (T, 2, M+1, nmax): polar
            angmax = first.shape[2] - 1
            nmax = first.shape[3]
            f = CylFldCoefsFile(path, "w", name=name, nfld=len(labels),
                                angmax=angmax, nmax=nmax, labels=labels)

            def pack(c):
                return c[0] + 1j * c[1]
        else:
            raise ValueError(
                f"write_coefs supports spherical/polar coefficient shapes; "
                f"got {first.shape} (slab/cube field series have no "
                f"reference field-file schema)")
        with f:
            for i, t in enumerate(np.asarray(times)):
                tensor = np.stack([pack(series[k][i]) for k in labels])
                f.append(float(t), tensor)

    @staticmethod
    def read_coefs(path, native_layout=True):
        """Read a field coefficient file -> (times, dict label -> series).

        native_layout=True (default) unpacks each label back to the REAL
        layout evaluate()/the force expect — sphere (T, 2, L+1, L+1, nmax),
        polar (T, 2, M+1, nmax) — so write_coefs/read_coefs round-trips;
        False returns the file's packed complex (T, rows, nmax) arrays."""
        from exp_tpu_torch.io.coefs import (SphFldCoefsFile, open_coefs,
                                            unpack_sph_matrix)

        with open_coefs(path) as f:
            times, coefs = f.read_all()
            labels = list(getattr(f, "labels", []))
            sph = isinstance(f, SphFldCoefsFile)
            angmax = int(getattr(f, "angmax", 0))
            nmax = int(getattr(f, "nmax", coefs.shape[-1]))
        if not labels:
            labels = [f"f{i}" for i in range(coefs.shape[1])]

        def unpack(c):              # (T, rows, nmax) complex -> native real
            if not native_layout:
                return c
            if sph:
                return np.stack([unpack_sph_matrix(a, angmax, nmax)
                                 for a in c])
            return np.stack([c.real, c.imag], axis=1)

        return times, {k: unpack(coefs[:, i]) for i, k in enumerate(labels)}

    def evaluate(self, coefs: dict, points):
        """Field estimates at points: dict field -> (N,) array."""
        pts, *cs = upload(force_device(self.force), points, coefs["dens"],
                          *(coefs[f] for f in self.fields))
        dens = self.force.density(cs[0], pts)
        dens = torch.where(torch.abs(dens) > 1e-30, dens,
                           torch.full_like(dens, 1e-30))
        out = {"dens": dens}
        for f, c in zip(self.fields, cs[1:]):
            out[f] = self.force.density(c, pts) / dens
        return download(out)
