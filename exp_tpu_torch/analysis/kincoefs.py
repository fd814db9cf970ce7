"""Kinematic Fourier coefficient series of disk snapshots.

A host-side NumPy copy of exp_tpu/analysis/kincoefs.py (the port imports
nothing of exp_tpu).

The reference's psp2bess / psp2lagu / psp2rings toolbox
(utils/PhaseSpace/psp2bess.cc, psp2lagu.cc, psp2rings.cc, Bess.H/.cc):
expand the surface density and the cylindrical velocity fields
(vr, vt, vz) of a component in azimuthal harmonics e^{im phi} times a
radial set — orthonormal Bessel functions J_m(alpha_mn R/rmax), 1st-order
associated Laguerre functions L^1_n(2r/a) e^{-r/a}, or plain radial ring
bins — and write the reference's binary coefficient files.

All accumulations are vectorized: per harmonic the (N, nmax) basis
matrix contracts against the (4, N) field matrix in one matmul.
"""

from __future__ import annotations

import numpy as np

BESS_MAGIC = 0x501ace
LAGU_MAGIC = 0x501acf

#: C++ struct layouts (default alignment pads the 4-byte magic to 8)
BESS_HEADER = np.dtype([("magic", "u4"), ("_pad", "u4"), ("time", "f8"),
                        ("rmax", "f8"), ("nmax", "i4"), ("mnum", "i4")])
LAGU_HEADER = np.dtype([("magic", "u4"), ("_pad", "u4"), ("time", "f8"),
                        ("rscl", "f8"), ("nmax", "i4"), ("mnum", "i4")])
RING_HEADER = np.dtype([("time", "f8"), ("nrings", "i4"), ("mnum", "i4")])


def cylindrical_kinematics(x, v):
    """R, phi, and the cylindrical velocity components (vr, vt, vz)."""
    x = np.asarray(x, np.float64)
    v = np.asarray(v, np.float64)
    R = np.hypot(x[:, 0], x[:, 1])
    phi = np.arctan2(x[:, 1], x[:, 0])
    c, s = np.cos(phi), np.sin(phi)
    vr = c * v[:, 0] + s * v[:, 1]
    vt = -s * v[:, 0] + c * v[:, 1]
    return R, phi, vr, vt, v[:, 2]


class BessBasis:
    """Orthonormal Bessel functions of integral order on [0, 1]
    (utils/PhaseSpace/Bess.H): J_m(x alpha_mn) / N_mn with alpha_mn the
    n-th zero of J_m and N_mn = sqrt(J_{m+1}(alpha_mn)^2 / 2)."""

    def __init__(self, m, nmax):
        from scipy.special import jn_zeros, jv

        self.m, self.nmax = int(m), int(nmax)
        self.roots = jn_zeros(self.m, self.nmax)
        self.norm = np.sqrt(0.5) * np.abs(jv(self.m + 1, self.roots))

    def __call__(self, x):
        """(len(x), nmax) basis matrix at x in [0, 1]."""
        from scipy.special import jv

        return jv(self.m, np.multiply.outer(np.asarray(x), self.roots)) \
            / self.norm


class LaguBasis:
    """Orthonormal 1st-order Laguerre functions (psp2lagu.cc Laguerre):
    L^1_n(2r/a) e^{-r/a} / (a sqrt(1+n) / 2)."""

    def __init__(self, rscl, nmax):
        self.rscl, self.nmax = float(rscl), int(nmax)
        self.norm = 0.5 * self.rscl * np.sqrt(1.0 + np.arange(self.nmax))

    def __call__(self, r):
        from scipy.special import eval_genlaguerre

        r = np.asarray(r, np.float64)
        L = np.stack([eval_genlaguerre(n, 1, 2.0 * r / self.rscl)
                      for n in range(self.nmax)], axis=-1)
        return L * (np.exp(-r / self.rscl)[..., None] / self.norm)


def _fourier_kinematic(mass, R, phi, vr, vt, vz, basis_eval, mmax,
                       rcut=None):
    """cos/sin kinematic coefficients against a radial basis.

    Returns (cos_c, sin_c) of shape (mmax+1, 4, nmax); fields are
    ordered [density, vr, vt, vz] as in BessCoefs::add.  sin_c[0] is
    identically zero (the m=0 sine row is absent from the file)."""
    mass = np.asarray(mass, np.float64)
    if rcut is not None:
        keep = R <= rcut
        mass, R, phi = mass[keep], R[keep], phi[keep]
        vr, vt, vz = vr[keep], vt[keep], vz[keep]
    F = np.stack([np.ones_like(mass), vr, vt, vz])        # (4, N)
    cos_c, sin_c = [], []
    angnorm = 0.5 * 2.0 / np.sqrt(np.pi)                  # 0.5*M_2_SQRTPI
    for m in range(mmax + 1):
        B = basis_eval(m)(R)                              # (N, nmax)
        fact = mass * (angnorm * (np.sqrt(0.5) if m == 0 else 1.0))
        cos_c.append((F * (fact * np.cos(m * phi))) @ B)
        sin_c.append((F * (fact * np.sin(m * phi))) @ B if m
                     else np.zeros_like(cos_c[-1]))
    return np.stack(cos_c), np.stack(sin_c)


def bess_coefs(mass, x, v, rmax, mmax=4, nmax=8):
    """psp2bess.cc BessCoefs: coefficients vs the Bessel set, particles
    beyond rmax excluded; basis carries the 1/rmax normalization."""
    R, phi, vr, vt, vz = cylindrical_kinematics(x, v)

    def make(m):
        b = BessBasis(m, nmax)
        return lambda r: b(r / rmax) / rmax
    return _fourier_kinematic(mass, R, phi, vr, vt, vz, make, mmax,
                              rcut=rmax)


def lagu_coefs(mass, x, v, rscl, mmax=4, nmax=8):
    """psp2lagu.cc LaguCoefs: coefficients vs the Laguerre set (the
    radial set is m-independent; no radial cut)."""
    R, phi, vr, vt, vz = cylindrical_kinematics(x, v)
    b = LaguBasis(rscl, nmax)
    return _fourier_kinematic(mass, R, phi, vr, vt, vz, lambda m: b, mmax)


def ring_coefs(mass, x, v, rmin, rmax, nbins, mmin=1, mmax=4):
    """psp2rings.cc: per-ring mass-weighted mean Fourier amplitudes of
    (vr, vt, vz).  Returns (cos_c, sin_c) of shape
    (mmax-mmin+1, 3, nbins)."""
    mass = np.asarray(mass, np.float64)
    R, phi, vr, vt, vz = cylindrical_kinematics(x, v)
    dp = (rmax - rmin) / nbins
    iv = np.floor((R - rmin) / dp).astype(int)
    keep = (iv >= 0) & (iv < nbins)
    iv, mass, phi = iv[keep], mass[keep], phi[keep]
    V = np.stack([vr[keep], vt[keep], vz[keep]])          # (3, N)
    bmass = np.bincount(iv, weights=mass, minlength=nbins)
    cos_c = np.zeros((mmax - mmin + 1, 3, nbins))
    sin_c = np.zeros_like(cos_c)
    safe = np.where(bmass > 0, bmass, 1.0)
    for j, m in enumerate(range(mmin, mmax + 1)):
        wc, ws = mass * np.cos(m * phi), mass * np.sin(m * phi)
        for k in range(3):
            cos_c[j, k] = np.bincount(iv, weights=V[k] * wc,
                                      minlength=nbins) / safe
            if m:
                sin_c[j, k] = np.bincount(iv, weights=V[k] * ws,
                                          minlength=nbins) / safe
    return cos_c, sin_c


def _write_mblocks(fh, cos_c, sin_c, m0=0):
    """One per-harmonic block: int m, cos rows, (m>0) sin rows."""
    for j in range(cos_c.shape[0]):
        m = m0 + j
        fh.write(np.int32(m).tobytes())
        fh.write(np.ascontiguousarray(cos_c[j], np.float64).tobytes())
        if m:
            fh.write(np.ascontiguousarray(sin_c[j], np.float64).tobytes())


def write_bess_coefs(fh, time, rmax, cos_c, sin_c):
    """Append one BessCoefs::write block (psp2bess.cc:105-123)."""
    h = np.zeros(1, BESS_HEADER)
    h["magic"], h["time"], h["rmax"] = BESS_MAGIC, time, rmax
    h["nmax"], h["mnum"] = cos_c.shape[2], cos_c.shape[0]
    fh.write(h.tobytes())
    _write_mblocks(fh, cos_c, sin_c)


def write_lagu_coefs(fh, time, rscl, cos_c, sin_c):
    """Append one LaguCoefs::write block (psp2lagu.cc:160-184)."""
    h = np.zeros(1, LAGU_HEADER)
    h["magic"], h["time"], h["rscl"] = LAGU_MAGIC, time, rscl
    h["nmax"], h["mnum"] = cos_c.shape[2], cos_c.shape[0]
    fh.write(h.tobytes())
    _write_mblocks(fh, cos_c, sin_c)


def write_ring_preamble(fh, rmin, rmax, nbins):
    """Ring-edge table at the head of the .ring_coefs file
    (psp2rings.cc:137-147): int nbins, nbins lower edges, nbins upper."""
    fh.write(np.int32(nbins).tobytes())
    edges = np.linspace(rmin, rmax, nbins + 1)
    fh.write(edges[:-1].astype(np.float64).tobytes())
    fh.write(edges[1:].astype(np.float64).tobytes())


def write_ring_coefs(fh, time, cos_c, sin_c, mmin=1):
    """Append one RingCoefs::write block (psp2rings.cc:36-57)."""
    h = np.zeros(1, RING_HEADER)
    h["time"], h["nrings"], h["mnum"] = time, cos_c.shape[2], cos_c.shape[0]
    fh.write(h.tobytes())
    _write_mblocks(fh, cos_c, sin_c, m0=mmin)


def _read_mblocks(buf, off, mnum, nfield, nrad):
    cos_c, sin_c, ms = [], [], []
    for _ in range(mnum):
        m = int(np.frombuffer(buf, np.int32, 1, off)[0])
        off += 4
        c = np.frombuffer(buf, np.float64, nfield * nrad, off)
        off += 8 * nfield * nrad
        if m:
            s = np.frombuffer(buf, np.float64, nfield * nrad, off)
            off += 8 * nfield * nrad
        else:
            s = np.zeros(nfield * nrad)
        ms.append(m)
        cos_c.append(c.reshape(nfield, nrad))
        sin_c.append(s.reshape(nfield, nrad))
    return ms, np.stack(cos_c), np.stack(sin_c), off


def read_bess_coefs(path):
    """All snapshots of a psp2bess output file.  Returns a list of
    dicts with time/rmax/ms/cos/sin."""
    with open(path, "rb") as fh:
        buf = fh.read()
    out, off = [], 0
    while off + BESS_HEADER.itemsize <= len(buf):
        h = np.frombuffer(buf, BESS_HEADER, 1, off)[0]
        if int(h["magic"]) != BESS_MAGIC:
            raise ValueError(f"{path}: bad bess magic at {off}")
        off += BESS_HEADER.itemsize
        ms, c, s, off = _read_mblocks(buf, off, int(h["mnum"]), 4,
                                      int(h["nmax"]))
        out.append({"time": float(h["time"]), "rmax": float(h["rmax"]),
                    "ms": ms, "cos": c, "sin": s})
    return out


def read_lagu_coefs(path):
    with open(path, "rb") as fh:
        buf = fh.read()
    out, off = [], 0
    while off + LAGU_HEADER.itemsize <= len(buf):
        h = np.frombuffer(buf, LAGU_HEADER, 1, off)[0]
        if int(h["magic"]) != LAGU_MAGIC:
            raise ValueError(f"{path}: bad lagu magic at {off}")
        off += LAGU_HEADER.itemsize
        ms, c, s, off = _read_mblocks(buf, off, int(h["mnum"]), 4,
                                      int(h["nmax"]))
        out.append({"time": float(h["time"]), "rscl": float(h["rscl"]),
                    "ms": ms, "cos": c, "sin": s})
    return out


def read_ring_coefs(path):
    """Ring preamble + all snapshot blocks of a psp2rings output."""
    with open(path, "rb") as fh:
        buf = fh.read()
    nbins = int(np.frombuffer(buf, np.int32, 1, 0)[0])
    lo = np.frombuffer(buf, np.float64, nbins, 4)
    hi = np.frombuffer(buf, np.float64, nbins, 4 + 8 * nbins)
    off = 4 + 16 * nbins
    out = []
    while off + RING_HEADER.itemsize <= len(buf):
        h = np.frombuffer(buf, RING_HEADER, 1, off)[0]
        off += RING_HEADER.itemsize
        ms, c, s, off = _read_mblocks(buf, off, int(h["mnum"]), 3,
                                      int(h["nrings"]))
        out.append({"time": float(h["time"]), "ms": ms, "cos": c, "sin": s})
    return {"redge_lo": lo, "redge_hi": hi, "blocks": out}
