"""The port's analysis library (exp_tpu_torch/analysis: basis, field,
field_basis, crossval, wake, mssa, edmd, util, units, orbit) against
exp_tpu's on the same seeded inputs: the flows of tests/test_analysis.py,
tests/test_wake.py and tests/test_orbit_om.py on both packages, the README's
analysis flow stage by stage, and the pallas backend's plain versions
against exp_tpu's Pallas kernels in interpret mode.

The port runs on the CPU (`device="cpu"`).  Tolerances:
  * F64 (1e-10 of the largest value): the f64 matmul/gather sphere
    backends and every field, coefficient and cross-validation number
    derived from them (measured ~1e-15 to 5e-13);
  * host NumPy/SciPy copies (mssa, edmd, util, orbit, units, wigner_d): the
    same code on the same inputs, held to 1e-12 (they agree bit for bit
    here);
  * K1_REL (2e-7 of max|c|): K1's plain version against exp_tpu's K1 in
    interpret mode, both f32 sums in another order (measured 7.1e-8 on the
    2,048-particle Lmax 2 halo; ROADMAP §3 reads 3e-8 on 4,004 particles at
    lmax 4); a velocity field's coefficients to K1_REL of max|c_dens|
    max|v|, the scale of their sums of |m v|;
  * K2_ABS (1.5e-6, ROADMAP §3's figure): K2's plain version against
    exp_tpu's K2 in interpret mode, absolute on the acceleration and the
    potential (measured 8.3e-8);
  * files: VTK and PVD from the same arrays byte-equal; coefficient files
    read back equal.
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.analysis import util as j_util
from exp_tpu.analysis.basis import Basis as JBasis
from exp_tpu.analysis.coefs import Coefs as JCoefs
from exp_tpu.analysis.edmd import Koopman as JKoopman
from exp_tpu.analysis.field import FieldGenerator as JFieldGenerator
from exp_tpu.analysis.mssa import expMSSA as JexpMSSA
from exp_tpu.basis.model import hernquist_model
from exp_tpu.ic.eddington import sample_spherical_model

from exp_tpu_torch.analysis import util as t_util
from exp_tpu_torch.analysis.basis import Basis as TBasis
from exp_tpu_torch.analysis.coefs import Coefs as TCoefs
from exp_tpu_torch.analysis.edmd import Koopman as TKoopman
from exp_tpu_torch.analysis.field import FieldGenerator as TFieldGenerator
from exp_tpu_torch.analysis.mssa import expMSSA as TexpMSSA


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
K1_REL = 2e-7
K2_ABS = 1.5e-6
N_PALLAS = 2048


def close(t, j, tol, scale=None):
    """max|t - j| <= tol * max|j| (or tol * scale)."""
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    s = np.abs(j).max() if scale is None else scale
    err = np.abs(t - j).max() if t.size else 0.0
    print(f"max|d| {err:.3e} of scale {s:.3e} (tolerance {tol:.1e})")
    assert err <= tol * s, f"max|d| {err:.3e} > {tol:.1e} x {s:.3e}"
    return err


def close_dict(t, j, tol):
    assert list(t) == list(j)
    for k in j:
        close(t[k], j[k], tol)


def conf(backend=None, lmax=2, nmax=8):
    p = {"modelname": "halo.model", "Lmax": lmax, "nmax": nmax,
         "numr": 800, "rmapping": 1.0}
    if backend:
        p["backend"] = backend
    return {"id": "sphereSL", "parameters": p}


@pytest.fixture(scope="module")
def halo(tmp_path_factory):
    """tests/test_analysis.py's halo: a Hernquist model file, 10,000
    particles (seed 3), Lmax 2, nmax 8 on both packages."""
    d = tmp_path_factory.mktemp("analysis")
    m = hernquist_model(rmin=1e-4, rmax=20.0, numr=1000)
    m.to_file(d / "halo.model")
    x, v, mass = sample_spherical_model(m, 10000, seed=3)
    jb = JBasis.factory(conf(), workdir=str(d))
    tb = TBasis.factory(conf(), workdir=str(d), device="cpu")
    return d, x, v, mass, jb, tb


@pytest.fixture(scope="module")
def pallas_pair(halo):
    d = halo[0]
    return (JBasis.factory(conf("pallas"), workdir=str(d)),
            TBasis.factory(conf("pallas"), workdir=str(d), device="cpu"))


def _snaps(x, mass, n=12):
    return [(x * (1.0 + 0.01 * np.sin(0.3 * t)), mass) for t in range(n)]


# ---------------------------------------------------------------------------
# tests/test_analysis.py flows
# ---------------------------------------------------------------------------

def test_basis_factory_and_coefs(halo, tmp_path):
    """create_from_snapshots on 12 jittered snapshots (F64), the HDF5
    round trip each way between the packages, the power and metadata."""
    d, x, v, mass, jb, tb = halo
    assert tb.geometry == jb.geometry == "sphere"
    assert tb._meta() == jb._meta()
    assert tb.device == torch.device("cpu")
    times = np.arange(12) * 0.1
    cj = jb.create_from_snapshots(_snaps(x, mass), times=times)
    ct = tb.create_from_snapshots(_snaps(x, mass), times=times)
    np.testing.assert_array_equal(ct.times(), cj.times())
    A = ct.as_array()
    assert A.shape == (12, 2, 3, 3, 8)
    close(A, cj.as_array(), F64)

    pt, pj = tmp_path / "t.h5", tmp_path / "j.h5"
    ct.to_file(str(pt))
    cj.to_file(str(pj))
    np.testing.assert_array_equal(JCoefs.from_file(str(pt)).as_array(), A)
    back = TCoefs.from_file(str(pj))
    np.testing.assert_array_equal(back.as_array(), cj.as_array())
    assert back.geometry == "sphere"

    P = ct.power()
    close(P, cj.power(), F64)
    assert P.shape == (12, 3)
    assert np.all(P[:, 0] > 10 * P[:, 1:].sum(axis=1))

    # a scalar mass and a center: the same coefficients as the arrays
    c1 = tb.create_coefficients(x + 0.5, float(mass[0]), center=[0.5] * 3)
    close(c1, jb.create_coefficients(x + 0.5, float(mass[0]),
                                     center=[0.5] * 3), F64)


def test_field_generator(halo):
    """FieldGenerator.slices and .points on both packages (F64)."""
    d, x, v, mass, jb, tb = halo
    c = jb.create_coefficients(x, mass)
    out = {}
    for who, b, FG, C in (("j", jb, JFieldGenerator, JCoefs),
                          ("t", tb, TFieldGenerator, TCoefs)):
        coefs = C(geometry="sphere", meta=b._meta())
        coefs.add(0.0, c)
        fg = FG([0.0], pmin=[-2, -2, 0], pmax=[2, 2, 0], grid=[32, 32, 0])
        out[who] = (fg.slices(b, coefs)[0.0],
                    fg.points(b, coefs, np.array([[0.5, 0, 0],
                                                  [1.0, 0, 0]]))[0.0])
    (sj, pj), (st, pt) = out["j"], out["t"]
    close_dict(st, sj, F64)
    close_dict(pt, pj, F64)
    assert st["dens"].shape == (32, 32)
    assert np.isfinite(st["potl"]).all()
    cidx = np.unravel_index(np.argmax(st["dens"]), st["dens"].shape)
    assert abs(cidx[0] - 15.5) < 4 and abs(cidx[1] - 15.5) < 4
    assert pt["potl"][0] < pt["potl"][1] < 0


def _signals():
    rng = np.random.default_rng(0)
    T = 200
    t = np.arange(T)
    s1 = np.sin(2 * np.pi * t / 20.0)
    s2 = 0.3 * np.sin(2 * np.pi * t / 7.0)
    noise = 0.02 * rng.standard_normal((T, 2))
    A = np.stack([s1 + noise[:, 0], s1 * 0.5 + s2 + noise[:, 1]], axis=1)
    return A, s1


def _table(C, A):
    coefs = C(geometry="table")
    for i in range(len(A)):
        coefs.add(float(i), A[i])
    return coefs


def test_mssa_separates_signals():
    """expMSSA on two channels: contributions, the [0, 1] reconstruction
    and the w-correlation equal exp_tpu's (HOST); exp_tpu's gates."""
    A, s1 = _signals()
    res = {}
    for who, C, M in (("j", JCoefs, JexpMSSA), ("t", TCoefs, TexpMSSA)):
        coefs = _table(C, A)
        m = M({"c": coefs}, window=50, numpc=8)
        res[who] = (m.contributions(),
                    m.reconstruct_coefs(coefs, groups=[0, 1]).as_array(),
                    m.wcorr(6))
    for a, b in zip(res["t"], res["j"]):
        close(a, b, HOST)
    contrib, R, W = res["t"]
    assert contrib[:2].sum() > 0.6
    assert np.corrcoef(R[:, 0], s1)[0, 1] > 0.98
    assert W.shape == (6, 6) and np.allclose(np.diag(W), 1.0)


def test_mssa_dft_kmeans_autogroup():
    """pcDFT, channelDFT, singleDFT, kmeans and auto_group equal
    exp_tpu's (HOST; the same cluster ids and groups)."""
    rng = np.random.default_rng(1)
    T = 240
    t = np.arange(T)
    p1, p2 = 24.0, 9.0
    s1 = np.sin(2 * np.pi * t / p1)
    s2 = 0.6 * np.sin(2 * np.pi * t / p2)
    A = np.stack([s1 + 0.01 * rng.standard_normal(T),
                  s2 + s1 * 0.2 + 0.01 * rng.standard_normal(T)], axis=1)
    res = {}
    for who, C, M in (("j", JCoefs, JexpMSSA), ("t", TCoefs, TexpMSSA)):
        m = M({"c": _table(C, A)}, window=60, numpc=8)
        res[who] = (m.pcDFT(), m.channelDFT(groups=[0, 1]),
                    m.singleDFT(("c", 0)), m.kmeans(2, stride=1),
                    m.auto_group(threshold=0.25, ncomp=6))
    (pt, ct, st, kt, gt), (pj, cj, sj, kj, gj) = res["t"], res["j"]
    for a, b in zip(pt + st, pj + sj):
        close(a, b, HOST)
    close(ct[0], cj[0], HOST)
    close(ct[1][("c", 0)], cj[1][("c", 0)], HOST)
    np.testing.assert_array_equal(kt[0], kj[0])
    close(kt[1], kj[1], HOST)
    assert gt == gj
    freq, P = pt
    om1 = 2 * np.pi / p1
    assert abs(freq[np.argmax(P[1:, 0]) + 1] - om1) < 0.35 * om1
    assert kt[0][0] == kt[0][1] and len(set(kt[0])) == 2
    assert 0 in gt[0] and 1 in gt[0]


def test_koopman_recovers_frequency():
    """Koopman's frequencies and reconstruction equal exp_tpu's (HOST);
    exp_tpu's gates."""
    T, dt = 120, 0.1
    t = np.arange(T) * dt
    A = np.stack([np.cos(2.0 * t), np.sin(2.0 * t) + 0.5 * np.cos(5.0 * t)],
                 axis=1)
    res = {}
    for who, C, K in (("j", JCoefs, JKoopman), ("t", TCoefs, TKoopman)):
        k = K({"c": _table(C, A)}, numev=6, window=10)
        res[who] = (k.frequencies(dt), k.reconstruction())
    close(res["t"][0], res["j"][0], HOST)
    close(res["t"][1], res["j"][1], HOST)
    freqs, rec = np.abs(res["t"][0]), res["t"][1]
    assert np.min(np.abs(freqs - 2.0)) < 0.05
    assert np.min(np.abs(freqs - 5.0)) < 0.05
    assert np.abs(rec.T - A[: rec.shape[1]]).max() < 0.05


def test_centers():
    """centerOfMass, getDensityCenter and kmeans equal exp_tpu's."""
    rng = np.random.default_rng(1)
    x = np.vstack([rng.normal([1, 2, 3], 0.1, (2000, 3)),
                   rng.uniform(-10, 10, (500, 3))])
    m = np.ones(len(x))
    com = t_util.centerOfMass(x, m)
    dc = t_util.getDensityCenter(x, m, k=16)
    close(com, j_util.centerOfMass(x, m), HOST)
    close(dc, j_util.getDensityCenter(x, m, k=16), HOST)
    centers, labels = t_util.kmeans(x, 2, seed=2)
    cj, lj = j_util.kmeans(x, 2, seed=2)
    close(centers, cj, HOST)
    np.testing.assert_array_equal(labels, lj)
    assert np.linalg.norm(dc - [1, 2, 3]) < 0.2
    assert np.linalg.norm(dc - [1, 2, 3]) < np.linalg.norm(com - [1, 2, 3])
    assert t_util.getVersionInfo()["framework"] == "exp_tpu_torch"


def test_cross_validation(halo):
    """cross_validate (F64) and kl_divergence_radial (HOST) against
    exp_tpu's; exp_tpu's bounds on the port's numbers."""
    from exp_tpu.analysis.crossval import cross_validate as jcv
    from exp_tpu.analysis.crossval import kl_divergence_radial as jkl
    from exp_tpu_torch.analysis.crossval import (cross_validate,
                                                 kl_divergence_radial)

    d, x, v, mass, jb, tb = halo
    out = cross_validate(tb.force, x, mass, ntest=256, eps=5e-3)
    ref = jcv(jb.force, x, mass, ntest=256, eps=5e-3)
    assert list(out) == list(ref)
    for k in ref:
        close(out[k], ref[k], F64)
    assert out["ferr_all_med"] < 0.08
    assert out["perr_all_med"] < 0.02
    kl0 = kl_divergence_radial(x, mass, x, mass)
    kl1 = kl_divergence_radial(x, mass, x * 1.5, mass)
    close(kl1, jkl(x, mass, x * 1.5, mass), HOST)
    assert kl0 < 1e-10 and kl1 > 0.05


def _vtk_fields():
    return {"dens": np.arange(12.0).reshape(3, 4), "potl": -np.ones((3, 4))}


@pytest.mark.parametrize("axes", [None, (1, 2)])
def test_vtk_and_pvd(tmp_path, axes):
    """write_vtk / write_pvd on the same arrays: the same bytes as
    exp_tpu's (an x-y slice by default, a y-z slice with axes)."""
    from exp_tpu.analysis.field import write_pvd as jpvd
    from exp_tpu.analysis.field import write_vtk as jvtk
    from exp_tpu_torch.analysis.field import write_pvd, write_vtk

    pt, pj = tmp_path / "t.vtk", tmp_path / "j.vtk"
    write_vtk(pt, _vtk_fields(), [0, 0, 0], [1, 1, 0], axes=axes)
    jvtk(pj, _vtk_fields(), [0, 0, 0], [1, 1, 0], axes=axes)
    assert pt.read_bytes() == pj.read_bytes()
    txt = pt.read_text()
    want = "DIMENSIONS 3 4 1" if axes is None else "DIMENSIONS 1 3 4"
    assert want in txt and "SCALARS dens" in txt
    body = txt.split("LOOKUP_TABLE default\n")[1].split()[:3]
    np.testing.assert_allclose([float(v) for v in body], [0.0, 4.0, 8.0])
    write_pvd(tmp_path / "t.pvd", [(0.0, str(pt)), (0.5, str(pt))])
    jpvd(tmp_path / "j.pvd", [(0.0, str(pt)), (0.5, str(pt))])
    pvd = (tmp_path / "t.pvd").read_bytes()
    assert pvd == (tmp_path / "j.pvd").read_bytes()
    assert pvd.count(b"<DataSet") == 2 and b'timestep="0.5"' in pvd


def test_file_slices_and_histo2d(halo, tmp_path):
    """file_slices and file_volumes through each package's own fields:
    the same files but for the last printed digit (the fields agree to
    F64; %.6e rounds them), and the same PVD bytes; histo2d equal."""
    d, x, v, mass, jb, tb = halo
    c = jb.create_coefficients(x, mass)
    paths = {}
    for who, b, FG in (("j", jb, JFieldGenerator), ("t", tb, TFieldGenerator)):
        out = tmp_path / who
        out.mkdir()
        # 1,024 points a grid, the shape test_field_generator compiled
        fg = FG([0.0, 1.0], pmin=[-1, -1, -1], pmax=[1, 1, 1],
                grid=[32, 0, 32])
        paths[who] = (fg.file_slices(b, c, "sl", str(out)),
                      FG([0.0], [-1, -1, -1], [1, 1, 1],
                         [8, 8, 16]).file_volumes(b, c, "vol", str(out)),
                      fg.histo2d(x, mass, axes=(0, 2)))
    for pt, pj in zip(paths["t"][0] + paths["t"][1],
                      paths["j"][0] + paths["j"][1]):
        bt, bj = open(pt, "rb").read(), open(pj, "rb").read()
        if pt.endswith(".pvd"):
            assert bt == bj
            continue
        head_t, _, num_t = bt.partition(b"LOOKUP_TABLE")
        head_j, _, num_j = bj.partition(b"LOOKUP_TABLE")
        assert head_t == head_j
        vt = np.array([float(w) for w in num_t.split() if
                       w[:1] in b"-0123456789"])
        vj = np.array([float(w) for w in num_j.split() if
                       w[:1] in b"-0123456789"])
        np.testing.assert_allclose(vt, vj, rtol=2e-6, atol=1e-300)
    close(paths["t"][2], paths["j"][2], HOST)


def test_slab_table_coef_files(tmp_path):
    """Slab, table and trajectory coefficient files written by one
    package read back equal by the other."""
    from exp_tpu.io.coefs import SlabCoefsFile as JSlab
    from exp_tpu.io.coefs import TableCoefsFile as JTable
    from exp_tpu.io.coefs import open_coefs as jopen
    from exp_tpu_torch.io.coefs import SlabCoefsFile, TableCoefsFile
    from exp_tpu_torch.io.coefs import open_coefs

    rng = np.random.default_rng(5)
    cs = rng.normal(size=(3, 5, 5, 4)) + 1j * rng.normal(size=(3, 5, 5, 4))
    data = rng.normal(size=(4, 6))
    for W, R in ((SlabCoefsFile, jopen), (JSlab, open_coefs)):
        p = tmp_path / f"slab_{W.__module__}.h5"
        w = W(str(p), "w", name="s", nmaxx=2, nmaxy=2, nmaxz=4)
        for i in range(3):
            w.append(float(i), cs[i])
        w.close()
        r = R(str(p))
        times, back = r.read_all()
        r.close()
        np.testing.assert_array_equal(times, [0, 1, 2])
        np.testing.assert_array_equal(back, cs)
    for W, R in ((TableCoefsFile, jopen), (JTable, open_coefs)):
        for geom in ("table", "trajectory"):
            p = tmp_path / f"{geom}_{W.__module__}.h5"
            w = W(str(p), "w", name="t", cols=6, geometry=geom)
            for i in range(4):
                w.append(float(i), data[i])
            w.close()
            r = R(str(p))
            assert r.geometry == geom
            times, back = r.read_all()
            r.close()
            np.testing.assert_array_equal(back.real, data)


def test_velocity_field_basis(halo, tmp_path):
    """FieldBasis over the halo's basis: a rotating halo's coefficients
    and field estimates equal exp_tpu's (F64); exp_tpu's gates; a custom
    field; write_coefs by each package read back equal by the other."""
    from exp_tpu.analysis.field_basis import FieldBasis as JFB
    from exp_tpu_torch.analysis.field_basis import FieldBasis as TFB

    d, x, v, mass, jb, tb = halo
    om = 0.3
    vrot = np.stack([-om * x[:, 1], om * x[:, 0], np.zeros(len(x))], -1)
    pts = np.array([[1.0, 0, 0], [0, 1.5, 0], [0.5, 0.5, 0.0]])
    fj, ft = JFB(jb.force, fields="spherical"), TFB(tb.force,
                                                    fields="spherical")
    for fb in (fj, ft):
        fb.add_field("Lz", lambda x, v, m: x[:, 0] * v[:, 1]
                     - x[:, 1] * v[:, 0])
    cj = {k: np.asarray(c) for k, c in fj.coefficients(x, vrot,
                                                       mass).items()}
    ct = ft.coefficients(x, vrot, mass)
    assert all(isinstance(c, torch.Tensor) for c in ct.values())
    close_dict({k: c.numpy() for k, c in ct.items()}, cj, F64)
    out = ft.evaluate(ct, pts)
    close_dict(out, fj.evaluate(cj, pts), F64)
    Rp = np.hypot(pts[:, 0], pts[:, 1])
    np.testing.assert_allclose(out["vp"], om * Rp, rtol=0.35)
    assert np.abs(out["vr"]).max() < 0.1 * om
    assert np.isfinite(out["vt"]).all()

    snaps = [(x * s, vrot, mass) for s in (1.0, 1.01)]
    st, sj = ft.create_from_snapshots(snaps), fj.create_from_snapshots(snaps)
    close_dict(st, sj, F64)
    for W, R, ser in ((ft, JFB, st), (fj, TFB, sj)):
        p = str(tmp_path / f"fld_{type(W).__module__}.h5")
        W.write_coefs(p, [0.0, 0.5], ser, name="halo")
        times, back = R.read_coefs(p)
        np.testing.assert_array_equal(times, [0.0, 0.5])
        close_dict(back, ser, HOST)


def test_unit_validator_and_h5_units(tmp_path):
    """UnitValidator and the Units dataset: the port's answers equal
    exp_tpu's, and a file written by one reads back equal by the other."""
    import h5py

    from exp_tpu.analysis import units as JU
    from exp_tpu_torch.analysis import units as TU

    v, vj = TU.UnitValidator(), JU.UnitValidator()
    for a in (("Len", "kiloparsec"), ("M", "solar_mass"), ("t", "Myr"),
              ("grav", "unitless"), ("bogus", "kpc"), ("length", "furlong")):
        assert v(*a) == vj(*a)
    assert v("Len", "kiloparsec") == (True, "length", "kpc")
    assert sorted(v.allowed_types()) == sorted(vj.allowed_types())
    units = [("Len", "kpc", 1.0), ("M", "Msun", 1e12), ("t", "Gyr", 1.0),
             ("grav", "none", 1.0)]
    for W, R in ((TU.write_units, JU.read_units),
                 (JU.write_units, TU.read_units)):
        p = str(tmp_path / f"u_{W.__module__}.h5")
        with h5py.File(p, "w") as f:
            W(f, units)
        with h5py.File(p, "r") as f:
            u = R(f)
        assert ("length", "kpc", 1.0) in u
        assert TU.grav_constant(u) == JU.grav_constant(u) == 1.0
    assert TU.grav_constant([]) == 1.0


# ---------------------------------------------------------------------------
# the pallas backend: K1 and K2's plain versions against exp_tpu's kernels
# in interpret mode, through the analysis entry points
# ---------------------------------------------------------------------------

def test_pallas_basis_against_interpret(halo, pallas_pair):
    """Basis, FieldBasis and BiorthWake on a `backend: pallas` stanza:
    the coefficients (K1) to K1_REL, the fields (K2) to K2_ABS."""
    from exp_tpu.analysis.field_basis import FieldBasis as JFB
    from exp_tpu.analysis.wake import BiorthWake as JW
    from exp_tpu_torch.analysis.field_basis import FieldBasis as TFB
    from exp_tpu_torch.analysis.wake import BiorthWake as TW

    d, x, v, mass, _, _ = halo
    jb, tb = pallas_pair
    xs, vs, ms = x[:N_PALLAS], v[:N_PALLAS], mass[:N_PALLAS]
    cj = jb.create_coefficients(xs, ms)
    ct = tb.create_coefficients(xs, ms)
    close(ct, cj, K1_REL)
    pts = x[-300:]
    fj, ft = jb.get_fields(cj, pts), tb.get_fields(cj, pts)
    close(ft[0], fj[0], F64)                   # density: plain torch, f64
    close(ft[1], fj[1], K2_ABS, scale=1.0)
    close(ft[2], fj[2], K2_ABS, scale=1.0)

    # a velocity field's weights m v change sign, so its f32 sums are held
    # against the scale of the sums of |m v|: max|c_dens| max|v|
    vj = JFB(jb.force).coefficients(xs, vs, ms)
    vt = TFB(tb.force).coefficients(xs, vs, ms)
    close(vt["dens"].numpy(), np.asarray(vj["dens"]), K1_REL)
    for k in ("vx", "vy", "vz"):
        close(vt[k].numpy(), np.asarray(vj[k]), K1_REL,
              scale=np.abs(np.asarray(vj["dens"])).max() * np.abs(vs).max())
    rj = JW(jb.force).reconstruct(cj, pts, L1=1)
    rt = TW(tb.force).reconstruct(cj, pts, L1=1)
    close(rt[0], rj[0], F64)
    close(rt[1], rj[1], F64)
    close(rt[2], rj[2], K2_ABS, scale=1.0)
    close(rt[3], rj[3], K2_ABS, scale=1.0)


def test_pallas_cross_validation(halo, pallas_pair):
    """cross_validate through K1 and K2's plain versions: each bin's
    relative field errors within 1e-5 of exp_tpu's interpret-mode run's
    (measured 8.6e-7: the kernels' f32 differences, over the direct
    field), the same radii and counts, and the potential bound."""
    from exp_tpu.analysis.crossval import cross_validate as jcv
    from exp_tpu_torch.analysis.crossval import cross_validate

    d, x, v, mass, _, _ = halo
    jb, tb = pallas_pair
    xs, ms = x[:N_PALLAS], mass[:N_PALLAS] * (len(x) / N_PALLAS)
    out = cross_validate(tb.force, xs, ms, ntest=128, eps=5e-3, nbins=6)
    ref = jcv(jb.force, xs, ms, ntest=128, eps=5e-3, nbins=6)
    np.testing.assert_array_equal(out["r"], ref["r"])
    np.testing.assert_array_equal(out["counts"], ref["counts"])
    for k in ("ferr_med", "ferr_p90", "perr_med"):
        close(out[k], ref[k], 1e-5, scale=1.0)
    assert out["perr_all_med"] < 0.05


# ---------------------------------------------------------------------------
# the README's analysis flow, stage by stage on both packages
# ---------------------------------------------------------------------------

def test_readme_analysis_flow(halo, tmp_path):
    """README "Analysis": factory -> create_from_snapshots ->
    Coefs.to_file / from_file -> expMSSA -> FieldGenerator.slices ->
    Koopman, each stage's output against exp_tpu's (F64 for the basis
    stages, HOST for the host stages on equal inputs)."""
    d, x, v, mass, _, _ = halo
    out = {}
    for who, B, C, M, FG, K, kw in (
            ("j", JBasis, JCoefs, JexpMSSA, JFieldGenerator, JKoopman, {}),
            ("t", TBasis, TCoefs, TexpMSSA, TFieldGenerator, TKoopman,
             {"device": "cpu"})):
        basis = B.factory(
            "id: sphereSL\nparameters: {modelname: halo.model, Lmax: 2, "
            "nmax: 8, numr: 800, rmapping: 1.0, backend: gather}\n",
            workdir=str(d), **kw)
        coefs = basis.create_from_snapshots(_snaps(x, mass, 16),
                                            times=np.arange(16) * 0.1)
        p = str(tmp_path / f"{who}.h5")
        coefs.to_file(p)
        back = C.from_file(p)
        keys = [(0, 0, 0, n) for n in range(4)] + [(0, 2, 0, 0)]
        m = M({"halo": back}, window=6, numpc=4, keys={"halo": keys})
        rec = m.reconstruct_coefs(back, groups=list(range(4)))
        sl = FG([0.0, 0.5], pmin=[-1, -1, 0], pmax=[1, 1, 0],
                grid=[16, 16, 0]).slices(basis, back)
        k = K({"halo": back}, numev=4, keys={"halo": keys}, window=4)
        out[who] = [coefs.as_array(), back.as_array(), m.singular_values(),
                    rec.as_array(), sl[0.5]["dens"], sl[0.5]["potl"],
                    k.reconstruction()]
    tols = [F64] * 7
    for a, b, tol in zip(out["t"], out["j"], tols):
        close(a, b, tol)


# ---------------------------------------------------------------------------
# tests/test_wake.py
# ---------------------------------------------------------------------------

def test_wigner_d_matches():
    from exp_tpu.analysis.wake import wigner_d as jw
    from exp_tpu_torch.analysis.wake import wigner_d

    for l in (1, 2, 3, 5):
        close(wigner_d(l, 1.1), jw(l, 1.1), HOST, scale=1.0)
        d = wigner_d(l, 1.1)
        assert np.abs(d @ d.T - np.eye(2 * l + 1)).max() < 1e-12


def test_wake_band_split():
    """CBsphere (lmax 3, nmax 4): accumulate, reconstruct and lband equal
    exp_tpu's (F64); monopole + wake gives the full field (1e-5 as
    tests/test_wake.py)."""
    from exp_tpu.analysis.wake import BiorthWake as JW
    from exp_tpu.analysis.wake import lband as jlband
    from exp_tpu.basis.analytic import make_analytic_force as jmake
    from exp_tpu_torch.analysis.wake import BiorthWake, lband
    from exp_tpu_torch.basis.analytic import make_analytic_force

    force = make_analytic_force("CBsphere", lmax=3, nmax=4, device="cpu")
    w, wj = BiorthWake(force), JW(jmake("CBsphere", lmax=3, nmax=4))
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.3, (5000, 3))
    mass = np.full(len(x), 1.0 / len(x))
    coef = w.accumulate(x, mass)
    cj = np.asarray(wj.accumulate(x, mass))
    close(coef.numpy(), cj, F64)
    pts = rng.normal(0, 0.4, (64, 3))
    r = w.reconstruct(coef, pts, L1=1)
    for a, b in zip(r, wj.reconstruct(cj, pts, L1=1)):
        close(a, b, F64)
    d0, dw, p0, pw = r
    pt = torch.as_tensor(pts)
    full_d = force.density(coef, pt).numpy()
    full_p = force.acceleration(coef, pt)[1].numpy()
    assert np.abs(d0 + dw - full_d).max() < 1e-5 * np.abs(full_d).max()
    assert np.abs(p0 + pw - full_p).max() < 1e-5 * np.abs(full_p).max()
    c_hi = lband(coef, 2, 3)
    assert isinstance(c_hi, torch.Tensor) and float(c_hi[:, :2].max()) == 0
    np.testing.assert_array_equal(lband(cj, 2, 3),
                                  np.asarray(jlband(cj, 2, 3)))


def test_orientation_recovers_tilt():
    """A pure (2, 0) multipole tilted by beta: the port's solver finds
    exp_tpu's angles (HOST) and theta = beta with cost -1."""
    from exp_tpu.analysis.wake import BiorthWake as JW
    from exp_tpu.basis.analytic import make_analytic_force as jmake
    from exp_tpu_torch.analysis.wake import BiorthWake, wigner_d
    from exp_tpu_torch.basis.analytic import make_analytic_force

    beta = 0.6
    d2 = wigner_d(2, beta)
    coef = np.zeros((2, 3, 3, 2))
    fac1 = math.sqrt((0.5 * 2 + 0.25) / math.pi)
    for m in range(3):
        amp = d2[2 + m, 2]
        if m == 0:
            coef[0, 2, 0, 0] = amp / fac1
        else:
            fac2 = fac1 * math.sqrt(
                math.exp(math.lgamma(2 - m + 1) - math.lgamma(2 + m + 1)))
            coef[0, 2, m, 0] = amp / fac2
    o = BiorthWake(make_analytic_force("CBsphere", lmax=2, nmax=2,
                                       device="cpu")).orientation(
        torch.as_tensor(coef), 2, 0)
    oj = JW(jmake("CBsphere", lmax=2, nmax=2)).orientation(coef, 2, 0)
    close_dict(o, oj, HOST)
    th = o["theta"][0] % np.pi
    assert min(th, np.pi - th) == pytest.approx(beta, abs=1e-5)
    assert o["cost"][0] == pytest.approx(-1.0, abs=1e-6)


# ---------------------------------------------------------------------------
# tests/test_orbit_om.py (the orbit cases; the Osipkov-Merritt sampler is
# ic/eddington, held in tests/test_torch_tables.py's sampler tests)
# ---------------------------------------------------------------------------

def _models():
    from exp_tpu.basis.model import SphericalModelTable as JM
    from exp_tpu_torch.basis.model import SphericalModelTable as TM
    from exp_tpu_torch.basis.model import hernquist_model as thern

    r = np.geomspace(1e-4, 1e3, 4000)
    args = (r, np.zeros_like(r) + 1e-12, np.full_like(r, 1.0), -1.0 / r)
    return ((TM(*args), JM(*args)),
            (thern(rmin=1e-4, rmax=50.0, numr=2000),
             hernquist_model(rmin=1e-4, rmax=50.0, numr=2000)))


def test_orbits_match():
    """SphericalOrbit on a Kepler and a Hernquist model: peri, apo,
    frequencies, actions, the angle grid, get_angle, get_w1, pot_trans
    and find_orb equal exp_tpu's (HOST); the Kepler closure of
    tests/test_orbit_om.py."""
    from exp_tpu.analysis.orbit import SphericalOrbit as JO
    from exp_tpu.analysis.orbit import find_orb as jfind
    from exp_tpu_torch.analysis.orbit import SphericalOrbit, find_orb

    (kt, kj), (ht, hj) = _models()
    for E, kappa in ((-0.5, 0.3), (-0.5, 0.95)):
        o, oj = SphericalOrbit(kt, E, kappa=kappa), JO(kj, E, kappa=kappa)
        close(o.frequencies(), oj.frequencies(), HOST)
        close(o.actions(), oj.actions(), HOST)
        wr, wp = o.frequencies()
        assert wr == pytest.approx(wp, rel=1e-4)
        assert sum(o.actions()) == pytest.approx(1.0 / np.sqrt(-2 * E),
                                                 rel=1e-4)
    for kappa in (0.5, 1.0):
        o, oj = SphericalOrbit(ht, -0.35, kappa=kappa), JO(hj, -0.35,
                                                           kappa=kappa)
        close([o.peri, o.apo, o.Tr, o.dphi], [oj.peri, oj.apo, oj.Tr,
                                              oj.dphi], HOST)
        close(o.frequencies(), oj.frequencies(), HOST)
        assert o.resonance(1, -2) == oj.resonance(1, -2)
    o, oj = SphericalOrbit(ht, -0.35, kappa=0.5), JO(hj, -0.35, kappa=0.5)
    g, gj = o.compute_angles(), oj.compute_angles()
    close_dict(g, gj, HOST)
    assert o.get_angle("r", o.Tr / 2) == oj.get_angle("r", oj.Tr / 2)
    assert o.get_w1(0.5 * (o.peri + o.apo), 1.0) == oj.get_w1(
        0.5 * (oj.peri + oj.apo), 1.0)
    close(o.pot_trans(2, -1, lambda r: np.stack([r, r * r], -1)),
          oj.pot_trans(2, -1, lambda r: np.stack([r, r * r], -1)), HOST)
    res, rj = find_orb(ht, o.peri, o.apo), jfind(hj, oj.peri, oj.apo)
    for k in ("energy", "kappa", "radial_period"):
        assert res[k] == pytest.approx(rj[k], rel=HOST, abs=HOST)
    assert res["kappa"] == pytest.approx(0.5, abs=1e-6)


def test_analysis_entry_points_without_device_raise_when_no_cuda(
        halo, monkeypatch):
    """Basis.factory without a device runs on CUDA, and raises here."""
    d = halo[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TBasis.factory(conf("pallas"), workdir=str(d))


def test_tableless_force_keeps_the_device_it_was_built_for(halo):
    """A force without tables (shells, direct) runs on the device that
    build_force was given, not on the CPU: Basis.factory's device reaches
    the Basis, its uploads and FieldBasis's coefficients (the meta device
    stands in for the card here).  A tableless force built by hand has no device and the
    analysis refuses it.  On the CPU a shells Basis agrees with exp_tpu's
    (F64)."""
    from exp_tpu_torch.analysis.basis import force_device, upload
    from exp_tpu_torch.analysis.field_basis import FieldBasis
    from exp_tpu_torch.forces.shells import ShellsForce

    d, x, v, mass = halo[:4]
    shells = {"id": "shells", "parameters": {"rmax": 20.0, "nbins": 64}}
    direct = {"id": "direct", "parameters": {"soft": 1e-2}}
    for stanza in (shells, direct):
        b = TBasis.factory(stanza, workdir=str(d), device="meta")
        assert b.device == torch.device("meta")
        assert force_device(b.force) == torch.device("meta")
        xm, mm = upload(b.device, x, mass)
        assert xm.device.type == mm.device.type == "meta"
        fc = FieldBasis(b.force).coefficients(x, v, mass)
        leaves = [t for c in fc.values()
                  for t in (c if isinstance(c, tuple) else (c,))]
        assert {t.device.type for t in leaves} == {"meta"}
    with pytest.raises(ValueError, match="no tables and no device"):
        force_device(ShellsForce(rmax=20.0, nbins=64))
    tb = TBasis.factory(shells, workdir=str(d), device="cpu")
    jb = JBasis.factory(shells, workdir=str(d))
    c, cj = tb.create_coefficients(x, mass), jb.create_coefficients(x, mass)
    close(c, cj, F64)
    pts = x[:512]
    for t, j in zip(tb.get_fields(c, pts), jb.get_fields(cj, pts)):
        close(t, j, F64)
