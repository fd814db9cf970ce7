"""The port's disk, cube and slab analysis (exp_tpu_torch/analysis: basis on
a cylinder, cube and slabSL stanza, diskeof, kincoefs) against exp_tpu's on
the same seeded inputs: tests/test_diskeof.py::test_accumulate_and_rotate
and the non-CLI cases of tests/test_kincoefs.py on both packages, and the
pallas backend's plain versions (K4/K5, K7/K8, K9/K10) against exp_tpu's
Pallas kernels in interpret mode through Basis.

The port runs on the CPU (`device="cpu"`).  Both packages build their EOF
tables once (mmax 2, nmax 6, 128 x 64, as tests/test_diskeof.py) and read
them back from their own cache for the second backend.  Tolerances:
  * F64 (1e-10 of the largest value): the f64 'xla' cylinder (measured
    ~1e-15), diskeof's series, D, rotation and grids on it;
  * HOST (1e-12): the kinematic series, host NumPy copies on equal inputs;
  * K4_REL (2e-6 of max|c|), K5_ABS (2e-6 of max|a|): K4/K5's plain versions
    against exp_tpu's kernels in interpret mode (ROADMAP §3: G 1.3e-6, acc
    1.1e-6);
  * K7_REL, K8_REL (2e-6 of the largest value): the cube's (ROADMAP §3:
    2.6e-7, 3.0e-7);
  * K9_REL, K10_REL (2e-5 of the largest value): the slab's (ROADMAP §3:
    5.2e-6, 7.2e-6);
  * files from the same arrays byte-equal.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.analysis import diskeof as JDE
from exp_tpu.analysis import kincoefs as JK
from exp_tpu.analysis.basis import Basis as JBasis

from exp_tpu_torch.analysis import diskeof as TDE
from exp_tpu_torch.analysis import kincoefs as TK
from exp_tpu_torch.analysis.basis import Basis as TBasis


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """numpy's and scipy's BLAS and torch at one thread while this module
    runs: several test workers share the CPUs, and a BLAS call at eight
    spinning threads a worker runs tens of times slower there than alone.
    The old limits come back at the end of the module.  JAX's persistent
    compilation cache, a directory every worker reads and writes without
    a lock, is off meanwhile (ROADMAP §3, F1)."""
    n, cache = torch.get_num_threads(), jax.config.jax_enable_compilation_cache
    torch.set_num_threads(1)
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)
    jax.config.update("jax_enable_compilation_cache", cache)
    compilation_cache.reset_cache()


F64 = 1e-10
HOST = 1e-12
K4_REL, K5_ABS = 2e-6, 2e-6
K7_REL, K8_REL = 2e-6, 2e-6
K9_REL, K10_REL = 2e-5, 2e-5
ACYL, HCYL = 0.01, 0.002


def close(t, j, tol, scale=None):
    """max|t - j| <= tol * max|j| (or tol * scale)."""
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    s = np.abs(j).max() if scale is None else scale
    err = np.abs(t - j).max() if t.size else 0.0
    print(f"max|d| {err:.3e} of scale {s:.3e} (tolerance {tol:.1e})")
    assert err <= tol * s, f"max|d| {err:.3e} > {tol:.1e} x {s:.3e}"
    return err


def _disk(n, seed=0, m2=0.0):
    """tests/test_diskeof.py's exponential disk with an m = 2 overdensity."""
    rng = np.random.default_rng(seed)
    R = -ACYL * (np.log(rng.uniform(size=n)) + np.log(rng.uniform(size=n)))
    z = HCYL * np.arctanh(rng.uniform(-1, 1, n) * 0.999999)
    phi = rng.uniform(0, 2 * np.pi, n)
    if m2:
        keep = rng.uniform(size=n) < 0.5 * (1 + m2 * np.cos(2 * phi))
        R, z, phi = R[keep], z[keep], phi[keep]
    x = np.stack([R * np.cos(phi), R * np.sin(phi), z], 1)
    return x, np.full(len(R), 1.0 / n)


def cyl_conf(backend):
    return {"id": "cylinder", "parameters": {
        "mmax": 2, "nmax": 6, "lmaxfid": 12, "nmaxfid": 10, "acyl": ACYL,
        "hcyl": HCYL, "rcylmax": 20.0, "ncylnx": 128, "ncylny": 64,
        "rnum": 100, "tnum": 40, "cachename": "eof.h5",
        "backend": backend}}


@pytest.fixture(scope="module")
def cyl(tmp_path_factory):
    """(exp_tpu, port) Basis pairs on the 'xla' and 'pallas' backends; each
    package builds its tables once and reads its cache the second time."""
    out = {}
    for who, B, kw in (("j", JBasis, {}), ("t", TBasis, {"device": "cpu"})):
        d = str(tmp_path_factory.mktemp(f"cyl_{who}"))
        out[who] = {be: B.factory(cyl_conf(be), workdir=d, **kw)
                    for be in ("xla", "pallas")}
    return out


def test_cylinder_basis(cyl):
    """create_coefficients and get_fields on the disk: the 'xla' backend
    to F64, the 'pallas' backend's K4/K5 plain versions against exp_tpu's
    interpret-mode kernels to K4_REL / K5_ABS."""
    x, mass = _disk(20000, seed=1, m2=0.4)
    g = np.linspace(-0.05, 0.05, 24)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), np.full(X.size, 1e-3)], 1)
    for be, ctol, atol in (("xla", F64, F64), ("pallas", K4_REL, K5_ABS)):
        jb, tb = cyl["j"][be], cyl["t"][be]
        assert tb.geometry == jb.geometry == "cylinder"
        assert tb._meta() == jb._meta()
        cj = jb.create_coefficients(x, mass)
        close(tb.create_coefficients(x, mass), cj, ctol)
        fj, ft = jb.get_fields(cj, pts), tb.get_fields(cj, pts)
        close(ft[0], fj[0], F64)               # density: plain torch
        close(ft[1], fj[1], atol)
        close(ft[2], fj[2], atol)


def test_accumulate_and_rotate(cyl, tmp_path):
    """diskeof over 3 snapshots of 20,000 on the f64 'xla' forces: the
    series, D, the rotation and the rotated grids equal exp_tpu's (F64);
    tests/test_diskeof.py's gates (D symmetric PSD, the projection against
    the force's own pass at rtol 2e-3 / atol 2e-5, Urot orthogonal and the
    amplitudes kept to 1e-12), also against K4's plain version."""
    fj, ft = cyl["j"]["xla"].force, cyl["t"]["xla"].force
    snaps = [(0.1 * t, *reversed(_disk(20000, seed=t, m2=0.4)))
             for t in range(3)]
    times, cc, ss, D = TDE.accumulate(ft, iter(snaps))
    ref = JDE.accumulate(fj, iter(snaps))
    np.testing.assert_array_equal(times, ref[0])
    for a, b in zip((cc, ss, D), ref[1:]):
        close(a, b, F64)
    assert cc.shape == (3, 3, 6) and np.allclose(times, [0.0, 0.1, 0.2])
    for m in range(3):
        assert np.allclose(D[m], D[m].T)
        assert np.linalg.eigvalsh(D[m]).min() > -1e-10
    t0, m0, x0 = snaps[0]
    for f in (ft, cyl["t"]["pallas"].force):
        own = f.coefficients_local(torch.tensor(x0, dtype=torch.float32),
                                   torch.tensor(m0, dtype=torch.float32),
                                   accum_dtype=torch.float64).numpy()
        np.testing.assert_allclose(cc[0], own[0], rtol=2e-3, atol=2e-5)
        np.testing.assert_allclose(ss[0], own[1], rtol=2e-3, atol=2e-5)

    svals, Urot, rotC, rotS = TDE.rotate(cc, ss, D)
    jr = JDE.rotate(*ref[1:])
    for a, b in zip((svals, rotC, rotS), (jr[0], jr[2], jr[3])):
        close(a, b, F64)
    assert np.all(np.diff(svals, axis=1) <= 1e-12)
    for m in range(3):
        np.testing.assert_allclose(Urot[m] @ Urot[m].T, np.eye(6),
                                   atol=1e-12)
        np.testing.assert_allclose(np.linalg.norm(rotC[:, m], axis=1),
                                   np.linalg.norm(cc[:, m], axis=1),
                                   rtol=1e-12)
    dens, pot = TDE.rotated_grids(ft, Urot, rotC, rotS, 2, 0.05, 12)
    dj, pj = JDE.rotated_grids(fj, Urot, rotC, rotS, 2, 0.05, 12)
    close(dens, dj, F64)
    close(pot, pj, F64)
    U, cosm, sinm, inside = TDE.basis_rows(ft, x0[:100])
    Uj = JDE.basis_rows(fj, x0[:100])
    for a, b in zip((U, cosm, sinm), Uj[:3]):
        close(a, b, F64)
    np.testing.assert_array_equal(inside, Uj[3])

    paths = {}
    for who, w in (("t", TDE.write_coef_tables), ("j", JDE.write_coef_tables)):
        paths[who] = (tmp_path / f"rot_{who}", tmp_path / f"orig_{who}")
        w(*paths[who], times, cc, ss, rotC, rotS)
    for pt, pj in zip(paths["t"], paths["j"]):
        assert pt.read_bytes() == pj.read_bytes()


# ---------------------------------------------------------------------------
# tests/test_kincoefs.py (the non-CLI cases)
# ---------------------------------------------------------------------------

def _pattern_disk(n=40000, seed=0, rmax=0.04):
    rng = np.random.default_rng(seed)
    R = rng.uniform(0.2 * rmax, 0.9 * rmax, n)
    phi = rng.uniform(-np.pi, np.pi, n)
    x = np.stack([R * np.cos(phi), R * np.sin(phi), np.zeros(n)], 1)
    vt = 1.0 + 0.5 * np.cos(2 * phi) + 0.25 * np.sin(2 * phi)
    v = np.stack([-vt * np.sin(phi), vt * np.cos(phi), np.zeros(n)], 1)
    return np.full(n, 1.0 / n), x, v


def test_kinematic_bases_match():
    """BessBasis and LaguBasis equal exp_tpu's; orthonormal as in
    tests/test_kincoefs.py."""
    rmax = 0.04
    R = np.linspace(0, rmax, 20001)[1:]
    for m in (0, 2):
        b = TK.BessBasis(m, 5)
        close(b(R / rmax), JK.BessBasis(m, 5)(R / rmax), HOST)
        B = b(R / rmax) / rmax
        G = (B * R[:, None]).T @ B * (R[1] - R[0])
        assert np.allclose(G, np.eye(5), atol=2e-3)
    r = np.linspace(0, 0.4, 40001)[1:]
    B = TK.LaguBasis(0.01, 5)(r)
    close(B, JK.LaguBasis(0.01, 5)(r), HOST)
    G = (B * r[:, None]).T @ B * (r[1] - r[0])
    assert np.allclose(G, np.eye(5), atol=2e-3)


def test_kinematic_coefs_match(tmp_path):
    """ring, bess and lagu coefficients of the m = 2 pattern disk equal
    exp_tpu's (HOST), with tests/test_kincoefs.py's pattern gates; the
    binary files of the same arrays are byte-equal and each package reads
    the other's."""
    mass, x, v = _pattern_disk()
    rmax = 0.04
    ring = TK.ring_coefs(mass, x, v, 0.0, rmax, 10, mmin=1, mmax=3)
    bess = TK.bess_coefs(mass, x, v, rmax, mmax=2, nmax=8)
    lagu = TK.lagu_coefs(mass, x, v, 0.02, mmax=3, nmax=6)
    for a, b in zip(ring + bess + lagu,
                    JK.ring_coefs(mass, x, v, 0.0, rmax, 10, mmin=1, mmax=3)
                    + JK.bess_coefs(mass, x, v, rmax, mmax=2, nmax=8)
                    + JK.lagu_coefs(mass, x, v, 0.02, mmax=3, nmax=6)):
        close(a, b, HOST)
    pop = slice(2, 9)
    assert np.allclose(ring[0][1, 1, pop], 0.25, atol=0.03)
    assert np.allclose(ring[1][1, 1, pop], 0.125, atol=0.03)
    p2 = np.linalg.norm(lagu[0][2, 2]) + np.linalg.norm(lagu[1][2, 2])
    p1 = np.linalg.norm(lagu[0][1, 2]) + np.linalg.norm(lagu[1][1, 2])
    assert p2 > 10 * p1

    assert TK.BESS_HEADER.itemsize == 32 and TK.RING_HEADER.itemsize == 16
    for K, R in ((TK, JK), (JK, TK)):
        tag = K.__name__.split(".")[0]
        with open(tmp_path / f"b_{tag}", "wb") as fh:
            K.write_bess_coefs(fh, 1.5, rmax, *bess)
        with open(tmp_path / f"l_{tag}", "wb") as fh:
            K.write_lagu_coefs(fh, 0.25, 0.02, *lagu)
        with open(tmp_path / f"r_{tag}", "wb") as fh:
            K.write_ring_preamble(fh, 0.0, rmax, 10)
            K.write_ring_coefs(fh, 3.0, *ring, mmin=1)
        bb = R.read_bess_coefs(tmp_path / f"b_{tag}")
        np.testing.assert_array_equal(bb[0]["cos"], bess[0])
        assert R.read_lagu_coefs(tmp_path / f"l_{tag}")[0]["rscl"] == 0.02
        rb = R.read_ring_coefs(tmp_path / f"r_{tag}")
        np.testing.assert_array_equal(rb["blocks"][0]["sin"], ring[1])
    for k in "blr":
        assert ((tmp_path / f"{k}_exp_tpu_torch").read_bytes()
                == (tmp_path / f"{k}_exp_tpu").read_bytes())


# ---------------------------------------------------------------------------
# the cube and the slab through Basis: K7/K8 and K9/K10's plain versions
# against exp_tpu's kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cube", "slab"])
def test_periodic_basis_pallas(tmp_path, case):
    """create_coefficients and get_fields on a cube (nmax 2) and a slabSL
    (nmax 1 x 1 x 3) stanza under `backend: pallas`, 600
    particles: the coefficients to K7_REL / K9_REL of the largest, the
    fields to K8_REL / K10_REL of the largest."""
    rng = np.random.default_rng(7)
    if case == "cube":
        conf = {"id": "cube", "parameters": {
            "nmaxx": 2, "nmaxy": 2, "nmaxz": 2, "backend": "pallas"}}
        x = rng.uniform(0, 1, (600, 3))
        x[:, 0] = (x[:, 0] + 0.1 * np.sin(2 * np.pi * x[:, 0])) % 1.0
        ctol, ftol = K7_REL, K8_REL
    else:
        conf = {"id": "slabSL", "parameters": {
            "nmaxx": 1, "nmaxy": 1, "nmaxz": 3, "backend": "pallas"}}
        x = np.concatenate([rng.uniform(0, 1, (600, 2)),
                            rng.normal(0, 0.01, (600, 1))], 1)
        ctol, ftol = K9_REL, K10_REL
    mass = np.full(len(x), 1.0 / len(x))
    jb = JBasis.factory(conf, workdir=str(tmp_path))
    tb = TBasis.factory(conf, workdir=str(tmp_path), device="cpu")
    assert tb.geometry == jb.geometry == case and tb._meta() == jb._meta()
    cj = jb.create_coefficients(x, mass)
    close(tb.create_coefficients(x, mass), cj, ctol)
    pts = x[:200]
    fj, ft = jb.get_fields(cj, pts), tb.get_fields(cj, pts)
    close(ft[0], fj[0], F64)
    close(ft[1], fj[1], ftol)
    close(ft[2], fj[2], ftol)
