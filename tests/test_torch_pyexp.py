"""The port's pyEXP drop-in (exp_tpu_torch/pyexp) against exp_tpu's
(exp_tpu/pyexp): every flow of tests/test_pyexp_compat.py on both packages,
on its snapshot (a 3,000-particle Hernquist sample, seed 9; sphereSL Lmax 2,
nmax 6, numr 400; the cylinder stanza YAML_DISK), with the port at
`device="cpu"`.  Each package builds its bases once a module; each flow
makes its own inputs.

Tolerances (tests/test_torch_analysis.py:72-75):
  * F64 (1e-10 of the largest value): the f64 gather sphere and the f64
    'xla' cylinder, and every coefficient, field, Gram matrix and orbit
    derived from them;
  * HOST (1e-12): host NumPy on equal inputs (MSSA, eDMD, units, the
    pseudo-acceleration, KDdensity, the index helpers).  The MSSA and eDMD
    flows run both host paths on the series of the port's basis (the
    projections themselves are held at F64 by the flows above);
  * K1_REL (2e-6 of max|c|) and K2_ABS (1.5e-6, absolute): a `backend:
    pallas` pair, exp_tpu's K1 / K2 in interpret mode against the port's
    plain versions.  K2_ABS is tests/test_torch_analysis.py's; its K1_REL
    (2e-7) holds that file's 2,048-row halo, while this 3,000-row sample
    measures 6.6e-7 (4.8e-7 at numr 800) with both packages' K1 tables
    equal bit for bit: the f32 sums run in another order;
  * IntegrateOrbits returns float32 orbits, as exp_tpu's does: the f64
    trajectories agree to F64, so the returned arrays differ by at most one
    f32 rounding (F32, 2^-23 of the largest value);
  * files: HDF5 written by one package read back by the other equal.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

import exp_tpu.pyexp as jEXP
import exp_tpu_torch.pyexp as tEXP
from exp_tpu.basis.model import hernquist_model
from exp_tpu.ic.eddington import sample_spherical_model
from exp_tpu.nbody.particles import write_ascii_bodies


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
K1_REL = 2e-6
K2_ABS = 1.5e-6
F32 = 2.0 ** -23

YAML_SPHERE = """
id: sphereSL
parameters:
  modelname: hernquist
  Lmax: 2
  nmax: 6
  numr: 400
"""

YAML_DISK = """
id: cylinder
parameters:
  mmax: 2
  nmax: 4
  lmaxfid: 12
  nmaxfid: 8
  acyl: 0.01
  hcyl: 0.002
  ncylnx: 64
  ncylny: 32
  rnum: 60
  tnum: 30
"""


def close(t, j, tol, scale=None):
    """max|t - j| <= tol * max|j| (or tol * scale)."""
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    s = np.abs(j).max() if scale is None else scale
    err = np.abs(t - j).max() if t.size else 0.0
    print(f"max|d| {err:.3e} of scale {s:.3e} (tolerance {tol:.1e})")
    assert err <= tol * s, f"max|d| {err:.3e} > {tol:.1e} x {s:.3e}"
    return err


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    d = tmp_path_factory.mktemp("pyexp")
    m = hernquist_model(rmin=1e-3, rmax=20.0)
    x, v, mass = sample_spherical_model(m, 3000, seed=9)
    path = d / "halo.bods"
    write_ascii_bodies(path, (x, v, mass))
    return str(path), x, v, mass


@pytest.fixture(scope="module")
def bases():
    """(exp_tpu's basis, the port's) of YAML_SPHERE."""
    return (jEXP.basis.Basis.factory(YAML_SPHERE),
            tEXP.basis.Basis.factory(YAML_SPHERE, device="cpu"))


@pytest.fixture(scope="module")
def pallas_bases():
    conf = YAML_SPHERE + "  backend: pallas\n"
    return (jEXP.basis.Basis.factory(conf),
            tEXP.basis.Basis.factory(conf, device="cpu"))


@pytest.fixture(scope="module")
def disks():
    return (jEXP.basis.Basis.factory(YAML_DISK),
            tEXP.basis.Basis.factory(YAML_DISK, device="cpu"))


def _series(pkg, basis, mass, x, times, scale, name="halo"):
    """Coefs of createFromArray at each time on x * scale(i, t), or on
    x @ scale(i, t).T where that is a matrix."""
    coefs = None
    for i, t in enumerate(times):
        s = np.asarray(scale(i, t))
        xt = x @ s.T if s.ndim == 2 else x * s
        st = basis.createFromArray(mass, xt, time=float(t))
        if coefs is None:
            coefs = pkg.coefs.Coefs.makecoefs(st, name)
        coefs.add(st)
    return coefs


def _copy(pkg, coefs):
    """`pkg`'s Coefs holding the same series (equal host inputs for the
    host paths)."""
    import importlib

    native = importlib.import_module(
        pkg.__name__.split(".")[0] + ".analysis.coefs").Coefs
    nat = coefs._c if hasattr(coefs, "_c") else coefs
    out = native(geometry=nat.geometry, name=nat.name, meta=dict(nat.meta))
    for t in nat.times():
        out.add(t, np.array(nat._data[t]))
    return pkg.coefs.Coefs(out) if hasattr(coefs, "_c") else out


# ---------------------------------------------------------------------------
# reader, projection, accumulation, fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["gather", "pallas"])
def test_reader_and_create_from_reader(snapshot, bases, pallas_bases, which):
    """createReader -> createFromReader on both packages: the f64 gather
    basis to F64, the pallas pair (K1) to K1_REL."""
    path, x, v, mass = snapshot
    pair = bases if which == "gather" else pallas_bases
    out = []
    for pkg, b in zip((jEXP, tEXP), pair):
        reader = pkg.read.ParticleReader.createReader("ascii", path)
        assert reader.CurrentNumber() == 3000
        assert reader.GetTypes() == ["comp"]
        reader.SelectType("comp")
        coefs = b.createFromReader(reader)
        assert coefs.Times() == [0.0]
        assert coefs.getGeometry() == "sphere"
        out.append(coefs.getCoefStruct(0.0).getCoefs())
    cj, ct = out
    assert abs(ct[0, 0, 0, 0]) > np.abs(ct[0, 1:]).max()
    close(ct, cj, F64 if which == "gather" else K1_REL)


def test_accumulation_api_matches_oneshot(snapshot, bases):
    path, x, v, mass = snapshot
    got = []
    for b in bases:
        one = b.createFromArray(mass, x, time=1.5)
        b.initFromArray()
        b.addFromArray(mass[:1000], x[:1000])
        b.addFromArray(mass[1000:], x[1000:])
        st = b.makeFromArray(time=1.5)
        assert st.getCoefTime() == 1.5
        close(st.getCoefs(), one.getCoefs(), F64)
        b.initFromArray()
        b.accumulate(x[:, 0], x[:, 1], x[:, 2], mass)
        acc = b.makeFromArray(time=1.5)
        got.append((one.getCoefs(), st.getCoefs(), acc.getCoefs()))
    for t, j in zip(got[1], got[0]):
        close(t, j, F64)


@pytest.mark.parametrize("which", ["gather", "pallas"])
def test_get_fields_labels_and_values(snapshot, bases, pallas_bases, which):
    """getFields' label set and columns, getMass, and the field types: the
    gather basis to F64, the pallas pair (K2 on each of the two field
    evaluations) to K2_ABS."""
    path, x, v, mass = snapshot
    pair = bases if which == "gather" else pallas_bases
    st = pair[0].createFromArray(mass, x)
    pts = x[:64]
    out = []
    for b in pair:
        b.set_coefs(st.getCoefs())
        labels = b.getFieldLabels()
        assert labels[:6] == ["dens m=0", "dens m>0", "dens",
                              "potl m=0", "potl m>0", "potl"]
        one = b.getFields(1.0, 0.0, 0.0)
        assert one.shape == (len(labels),) and one[5] < 0
        cols = {}
        # the columns of each field type are host NumPy of the same fields:
        # the pallas pair evaluates the spherical type alone
        for ft in (("spherical", "cylindrical", "cartesian")
                   if which == "gather" else ("spherical",)):
            b.setFieldType(ft)
            cols[ft] = (b.getFieldLabels(),
                        b.getFields(pts[:, 0], pts[:, 1], pts[:, 2]))
        b.setFieldType("none")
        assert b.getFieldLabels() == labels[:6]
        b.setFieldType("spherical")
        out.append((one, cols, b.getMass(25.0), b(0.5, 0.2, 0.1)))
    (oj, cj, mj, pj), (ot, ct, mt, pt) = out
    if which == "gather":
        close(ot, oj, F64)
        close(pt, pj, F64)
        assert abs(mt - mj) <= F64 * abs(mj)
        for ft in cj:
            assert ct[ft][0] == cj[ft][0]
            close(ct[ft][1], cj[ft][1], F64)
    else:
        for ft in cj:
            assert ct[ft][0] == cj[ft][0]
            # the density columns are plain tables on both sides; the
            # potential and force columns come from K2
            close(ct[ft][1][:, :3], cj[ft][1][:, :3], F64)
            close(ct[ft][1][:, 3:], cj[ft][1][:, 3:], K2_ABS, scale=1.0)
    assert abs(mt - float(mass.sum())) / float(mass.sum()) < 0.05


def test_ortho_and_basis_dump(bases):
    gj, gt = (b.orthoCheck() for b in bases)
    assert len(gt) == len(gj) == 3
    for a, b in zip(gt, gj):
        close(a, b, F64)
        np.testing.assert_allclose(a, -np.eye(a.shape[0]), atol=5e-2)
    tj, tt = (b.getBasis(-2, 1, 64) for b in bases)
    assert len(tt) == 3 and set(tt[0][0]) == {"potential", "density",
                                              "rforce"}
    for l in range(3):
        for n in tj[l]:
            for k in tj[l][n]:
                close(tt[l][n][k], tj[l][n][k], F64)


def test_selector_and_accel(snapshot, bases):
    """setSelector's functor gets NumPy rows; getAccel's columns."""
    path, x, v, mass = snapshot
    out = []
    for b in bases:
        seen = []

        def up(m, p, vv):
            seen.append(type(p))
            return p[2] > 0

        b.setSelector(up)
        st_up = b.createFromArray(mass, x, time=0.0)
        b.clrSelector()
        assert set(seen) == {np.ndarray}
        st_all = b.createFromArray(mass, x, time=0.0)
        b.set_coefs(st_all)
        a = b.getAccel(0.5, 0.0, 0.0)
        aa = b.getAccel([0.5, 1.0], [0.0, 0.0], [0.0, 0.0])
        assert a.shape == (3,) and a[0] < 0 and aa.shape == (2, 3)
        out.append((st_up.getCoefs(), a, aa, b.getAccelArray(x[:64])))
    for t, j in zip(out[1], out[0]):
        close(t, j, F64)
    sel = x[:, 2] > 0
    close(out[1][0], bases[1].createFromArray(mass[sel], x[sel]).getCoefs(),
          F64)


def test_noninertial_pseudo_accel(snapshot, bases):
    """setNonInertial + setNonInertialAccel (host NumPy); getAccel then
    subtracts the pseudo-acceleration."""
    path, x, v, mass = snapshot
    t = np.linspace(0.0, 1.0, 21)
    acc_true = np.array([0.3, -0.2, 0.1])
    pos = 0.5 * acc_true[None, :] * t[:, None] ** 2
    out = []
    for b in bases:
        b.set_coefs(b.createFromArray(mass, x))
        b.setNonInertial(8, t, pos=pos)
        ps = b.setNonInertialAccel(0.5)
        np.testing.assert_allclose(ps, acc_true, rtol=1e-6, atol=1e-9)
        out.append((ps, b.getAccel(0.5, 0.1, 0.0)))
        b.setInertial()
        assert np.all(b.pseudo == 0.0)
    close(out[1][0], out[0][0], HOST)
    close(out[1][1], out[0][1], F64)


def test_coef_covariance(snapshot, bases, tmp_path):
    """enableCoefCovariance / getCoefCovariance (each partition a
    projection) and the HDF5 file each way through CovarianceReader."""
    path, x, v, mass = snapshot
    res = []
    for who, b in zip("jt", bases):
        b.enableCoefCovariance(True, sampT=8)
        st = b.createFromArray(mass, x, time=0.0)
        mu, C = b.getCoefCovariance()
        full = st.getCoefs().ravel()
        assert np.abs(mu - full).max() / np.abs(full).max() < 0.2
        f = str(tmp_path / f"covar_{who}.h5")
        b.writeCoefCovariance(f, time=0.0)
        b.writeCoefCovariance(f, time=0.0)
        b.enableCoefCovariance(False)
        res.append((mu, C, f))
    close(res[1][0], res[0][0], F64)
    close(res[1][1], res[0][1], F64)
    for pkg in (jEXP, tEXP):
        for mu, C, f in res:
            rdr = pkg.basis.CovarianceReader(f)
            assert rdr.Times() == [0.0] and rdr.basisIDname() == "sphereSL"
            counts, masses, coefs, C2 = rdr.getCoefCovariance(0.0)
            assert coefs.shape[0] == 8 and counts.sum() == len(mass)
            np.testing.assert_allclose(masses.sum(), mass.sum(), rtol=1e-12)
            np.testing.assert_allclose(C2, C, rtol=1e-12, atol=1e-30)
            s2 = pkg.basis.CovarianceReader(f, stride=2).getCoefCovariance(
                0.0)
            assert s2[2].shape[0] == 4
    a, b = (pkg.basis.CovarianceReader(res[0][2], stride=2)
            .getCoefCovariance(0.0)[3] for pkg in (jEXP, tEXP))
    close(b, a, HOST)


def test_make_from_function(bases):
    """makeFromFunction's quadrature particles (the density callable gets
    NumPy scalars) and computeQuadrature."""
    def rho(x, y, z, t):
        r = np.sqrt(x * x + y * y + z * z)
        return 1.0 / (2 * np.pi * r * (1 + r) ** 3)

    out = []
    for b in bases:
        st = b.makeFromFunction(rho, {"knots": 32}, time=0.0)
        M = b.computeQuadrature(lambda x, y, z: rho(x, y, z, 0.0),
                                {"knots": 32})
        out.append((st.getCoefs(), M))
    close(out[1][0], out[0][0], F64)
    assert abs(out[1][1] - out[0][1]) <= HOST * abs(out[0][1])
    c = out[1][0]
    assert abs(c[0, 0, 0, 0]) > 30 * np.abs(c[0, 1:]).max()


# ---------------------------------------------------------------------------
# coefficients: I/O, power, units, packed layouts
# ---------------------------------------------------------------------------

def test_coefs_io_power_units(snapshot, bases, tmp_path):
    path, x, v, mass = snapshot
    res = []
    for who, pkg, b in zip("jt", (jEXP, tEXP), bases):
        coefs = _series(pkg, b, mass, x, [0.0, 0.5, 1.0],
                        lambda i, t: 1 + 0.02 * i)
        P = coefs.Power()
        assert P.shape == (3, 3) and (P[:, 0] > P[:, 1]).all()
        coefs.setUnits([("length", "kpc", 1.0), ("mass", "Msun", 1e12),
                        ("time", "Myr", 10.0), ("G", "none", 1.0)])
        assert coefs.getGravConstant() == 1.0
        with pytest.raises(ValueError):
            coefs.setUnits([("length", "cubits", 1.0)])
        f = str(tmp_path / f"halo_{who}.h5")
        coefs.WriteH5Coefs(f)
        st2 = b.createFromArray(mass, x, time=2.0)
        more = pkg.coefs.Coefs.makecoefs(st2, "halo")
        more.add(st2)
        more.ExtendH5Coefs(f)
        res.append((coefs, P, f))
    close(res[1][1], res[0][1], F64)
    assert res[1][0].getUnits() == res[0][0].getUnits()
    # each package reads the other's file
    for pkg, (coefs, _, f) in zip((tEXP, jEXP), res):
        back = pkg.coefs.Coefs.factory(f)
        assert len(back.Times()) == 4
        for t in coefs.Times():
            close(back.getCoefStruct(t).getCoefs(),
                  coefs.getCoefStruct(t).getCoefs(), HOST)
    assert tEXP.coefs.Coefs.factory(res[1][2]).CompareStanzas(
        tEXP.coefs.Coefs.factory(res[0][2]))
    for fn in ("getAllowedUnitTypes",):
        assert getattr(tEXP.coefs, fn)() == getattr(jEXP.coefs, fn)()
    for fn in ("getAllowedUnitNames", "getAllowedTypeAliases"):
        assert (getattr(tEXP.coefs, fn)("length")
                == getattr(jEXP.coefs, fn)("length"))


def test_get_all_coefs_and_set_data(snapshot, bases):
    """getAllCoefs' packed complex layout, getData / setData, and the
    struct's assign aliases, on both packages."""
    path, x, v, mass = snapshot
    res = []
    for pkg, b in zip((jEXP, tEXP), bases):
        coefs = _series(pkg, b, mass, x, [0.0], lambda i, t: 1.0)
        allc = coefs.getAllCoefs()
        assert allc.shape == (6, 6, 1) and np.iscomplexobj(allc)
        c = coefs.getCoefStruct(0.0).getCoefs()
        np.testing.assert_array_equal(allc[b.I(1, 1), :, 0].real, c[0, 1, 1])
        coefs.setData(0.0, 2.0 * allc[:, :, 0])
        allc2 = coefs.getAllCoefs()
        raw = np.asarray(coefs.getCoefStruct(0.0).getCoefs())
        coefs.setData(0.0, raw / 2.0)
        with pytest.raises(KeyError):
            coefs.setData(1.0, allc[:, :, 0])
        with pytest.raises(ValueError):
            coefs.setData(0.0, np.zeros((3, 4), complex))
        live = coefs.getCoefStruct(0.0)
        packed = coefs.getData(0.0)
        live.setMatrix(0.5 * packed)
        d = coefs.getData(0.0)
        d *= 0.0
        st2 = live.deepcopy()
        st2.setTensor(np.asarray(live.getCoefs()) * 3.0)
        res.append((allc, allc2, coefs(0.0), st2.getCoefs()))
    for t, j in zip(res[1], res[0]):
        close(t, j, F64)


def test_even_odd_power_and_file_lists():
    """EvenOddPower with an explicit nodd, makeKeys, PowerDim, and the
    reader's file-list helpers (host NumPy / pure Python)."""
    out = []
    for pkg in (jEXP, tEXP):
        nat = type(pkg.coefs.Coefs.makecoefs(
            pkg.coefs.CoefStruct("cylinder", np.zeros((2, 2, 4))))._c)(
            geometry="cylinder", name="d",
            meta={"mmax": 1, "nmax": 4, "ncylodd": 0})
        c = np.zeros((2, 2, 4))
        c[0, 0] = [1.0, 1.0, 2.0, 2.0]
        nat.add(0.0, c)
        coefs = pkg.coefs.Coefs(nat)
        Pe, Po = coefs.EvenOddPower(nodd=2)
        assert Pe[0, 0] == 2.0 and Po[0, 0] == 8.0
        groups = pkg.read.parseStringList(
            ["run.00010.0", "run.00010.1", "run.00011.0"], delimit=".")
        plain = pkg.read.parseStringList(
            ["snap_0", "snap_1", "other_0", "other_1"])
        out.append((Pe, Po, coefs.makeKeys([0, 1]), coefs.PowerDim(1),
                    groups, plain, pkg.read.getReaders()))
    for t, j in zip(out[1], out[0]):
        if isinstance(j, np.ndarray):
            close(t, j, HOST)
        else:
            assert t == j


def test_index_helpers_and_version(bases):
    jb, tb = bases
    for l in range(3):
        for m in range(l + 1):
            assert tb.I(l, m) == jb.I(l, m)
            assert tb.invI(tb.I(l, m)) == jb.invI(jb.I(l, m)) == (l, m)
    for fn in ("getName", "basisIDname", "getFieldType"):
        assert getattr(tb, fn)() == getattr(jb, fn)()
    v = tEXP.util.getVersionInfo()
    assert v == tEXP.util.Version() and v["framework"] == "exp_tpu_torch"
    assert tEXP.util.setMPI(True) is None
    assert tEXP.read.globFiles(__file__) == jEXP.read.globFiles(__file__)


# ---------------------------------------------------------------------------
# MSSA and eDMD
# ---------------------------------------------------------------------------

def test_mssa_workflow(snapshot, bases, tmp_path):
    """expMSSA on the 24-time series of the port's basis, both MSSA faces
    on the same series, to HOST."""
    path, x, v, mass = snapshot
    ct = _series(tEXP, bases[1], mass, x, range(24),
                 lambda i, t: 1 + 0.05 * np.sin(
                     np.linspace(0, 2 * np.pi, 24)[i]))
    out = []
    for who, pkg, c in (("j", jEXP, _copy(jEXP, ct)), ("t", tEXP, ct)):
        ssa = pkg.mssa.expMSSA({"halo": (c, None, [])}, window=8, numpc=4)
        ev = ssa.eigenvalues()
        assert len(ev) == 4 and (np.diff(ev) <= 1e-9).all()
        ssa.reconstruct([0, 1])
        rec = ssa.getReconstructed()
        assert len(rec["halo"].Times()) == 24
        k0 = ssa.getAllKeys()[0]
        assert len(k0) == 5
        f, p = ssa.singleDFT(k0)
        pre = str(tmp_path / f"st_{who}")
        ssa.saveState(pre)
        ssa.restoreState(pre)
        km = ssa.kmeans(2)
        assert set(cl for cl, d in km.values()) <= {0, 1}
        assert set(cl for cl, d in ssa.kmeansChannel(k0, 2).values()) \
            <= {0, 1}
        out.append((ev, np.abs(ssa.getPC()), ssa.getTotVar(),
                    ssa.getTotPow(), ssa.cumulative(),
                    rec["halo"].getAllCoefs(), ssa.getRC(k0), f, p,
                    ssa.wCorrAll(), ssa.wCorrKey(k0), ssa.wCorr(name="halo"),
                    ssa.contrib(), np.abs(ssa.getU()), ssa.getAllKeys()))
    for t, j in zip(out[1], out[0]):
        if isinstance(j, list):
            assert t == j
        else:
            close(t, j, HOST)


def test_wcorr_png_needs_matplotlib(snapshot, bases, tmp_path):
    """wcorrPNG renders with matplotlib where it is installed, and raises
    ImportError where it is not."""
    path, x, v, mass = snapshot
    c = _series(tEXP, bases[1], mass, x, range(12),
                lambda i, t: 1 + 0.05 * np.sin(0.5 * i))
    ssa = tEXP.mssa.expMSSA({"halo": (c, None, [])}, window=4, numpc=3)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            ssa.wcorrPNG(str(tmp_path / "wc"))
        return
    assert os.path.exists(ssa.wcorrPNG(str(tmp_path / "wc")))


def test_multi_name_mssa_and_edmd(snapshot, bases):
    """Two datasets of different shapes (a sphere series and a table):
    per-name keys and reconstructions on both packages."""
    path, x, v, mass = snapshot
    from exp_tpu_torch.analysis.coefs import Coefs as TNative

    rng = np.random.default_rng(1)
    series = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    halo = _series(tEXP, bases[1], mass, x, range(20),
                   lambda i, t: 1 + 0.02 * np.sin(i))
    tbl = TNative(geometry="table", name="tbl")
    for i in range(20):
        tbl.add(float(i), series[i])
    out = []
    for pkg, h, tb in ((jEXP, _copy(jEXP, halo), _copy(jEXP, tbl)),
                       (tEXP, halo, tbl)):
        ssa = pkg.mssa.expMSSA({"halo": (h, None, []),
                                "tbl": (tb, None, [])}, window=6, numpc=3)
        ssa.reconstruct([0, 1])
        rec = ssa.getReconstructed()
        assert rec["halo"]._c.as_array().shape[1:] == (2, 3, 3, 6)
        assert rec["tbl"].as_array().shape[1:] == (3,)
        koop = pkg.edmd.Koopman({"halo": (h, None, []),
                                 "tbl": (tb, None, [])}, numev=3)
        koop.reconstruct()
        kr = koop.getReconstructedKoopman()
        assert kr["halo"]._c.as_array().shape[1:] == (2, 3, 3, 6)
        out.append((ssa.getAllKeys(), rec["halo"]._c.as_array(),
                    rec["tbl"].as_array(), koop.getAllKeys(),
                    kr["halo"]._c.as_array(), kr["tbl"].as_array()))
    for t, j in zip(out[1], out[0]):
        if isinstance(j, list):
            assert t == j
        else:
            close(t, j, HOST)


def test_edmd_workflow(snapshot, bases, tmp_path):
    path, x, v, mass = snapshot
    ct = _series(tEXP, bases[1], mass, x, range(16),
                 lambda i, t: 1 + 0.03 * np.cos(0.7 * i))
    out = []
    for who, pkg, c in (("j", jEXP, _copy(jEXP, ct)), ("t", tEXP, ct)):
        koop = pkg.edmd.Koopman({"halo": (c, None, [])}, numev=4)
        koop.reconstruct()
        rec = koop.getReconstructedKoopman()
        assert (koop.getReconstructed.__func__
                is koop.getReconstructedKoopman.__func__)
        freq, power = koop.channelDFT(dt=1.0)
        dom = freq[np.argmax(power.sum(axis=1))]
        assert abs(dom - 0.7) < 2 * np.pi / 16
        F, G = koop.contrib()
        koop.saveState(str(tmp_path / who))
        koop.restoreState(str(tmp_path / who))
        out.append((koop.eigenvalues(), rec["halo"].getAllCoefs(), freq,
                    power, F, G, np.abs(koop.getModes())))
    for t, j in zip(out[1], out[0]):
        close(t, j, HOST)


def test_koopman_modes_and_background(snapshot, bases):
    """expMSSA.getKoopmanModes / getReconstructedKoopman / cumulative, and
    zerodata + background."""
    path, x, v, mass = snapshot

    def rot(i, t):
        ph = 2 * np.pi * 0.9 * t
        return np.array([[np.cos(ph), -np.sin(ph), 0],
                         [np.sin(ph), np.cos(ph), 0], [0, 0, 1.0]])

    times = np.linspace(0.0, 1.0, 12)
    ct = _series(tEXP, bases[1], mass, x, times, rot)
    out = []
    for pkg, c in ((jEXP, _copy(jEXP, ct)), (tEXP, ct)):
        mssa = pkg.mssa.expMSSA({"halo": (c, [])}, window=6, numpc=6)
        ev, modes = mssa.getKoopmanModes(tol=1e-10)
        assert np.abs(np.abs(ev[0]) - 1.0) < 0.2
        rec = mssa.getReconstructedKoopman(0)
        orig = np.array(c.getAllCoefs())
        c.zerodata()
        assert np.abs(np.array(c.getAllCoefs())).max() == 0.0
        mssa.background()
        np.testing.assert_array_equal(np.array(c.getAllCoefs()), orig)
        out.append((mssa.cumulative(), ev, np.abs(modes),
                    rec["halo"].getAllCoefs()))
    for t, j in zip(out[1], out[0]):
        close(t, j, HOST)


# ---------------------------------------------------------------------------
# fields, orbits, the cylinder
# ---------------------------------------------------------------------------

def test_field_generator(snapshot, bases, tmp_path):
    """slices, lines, points, file_lines and histo1d / histo1dlog /
    histo2d on both packages."""
    path, x, v, mass = snapshot
    out = []
    for who, pkg, b in zip("jt", (jEXP, tEXP), bases):
        coefs = _series(pkg, b, mass, x, [0.0, 1.0],
                        lambda i, t: 1 + 0.01 * i)
        fg = pkg.field.FieldGenerator([0.0, 0.5], (-2, -2, 0), (2, 2, 0),
                                      (16, 16, 0))
        sl = fg.slices(b, coefs)
        assert sl[0.0]["dens"].shape == (16, 16)
        ln = fg.lines(b, coefs, (0.1, 0, 0), (3.0, 0, 0), 64)
        assert (np.diff(ln[0.0]["potl"]) > 0).all()
        d = tmp_path / who
        d.mkdir()
        paths = fg.file_lines(b, coefs, (0.1, 0, 0), (3.0, 0, 0), 64, "ln",
                              str(d))
        H, edges = fg.histo1d(x, mass, axis=0, nbins=8)
        Hl, el = fg.histo1dlog(x, mass, axis=1, nbins=8)
        reader = pkg.read.ParticleReader.createReader("ascii", path)
        H2 = fg.histo2d(reader)
        out.append((sl, ln, [open(p).read() for p in paths],
                    (H, edges, Hl, el), H2))
    (sj, lj, fj, hj, h2j), (st, lt, ft, ht, h2t) = out
    for t in sj:
        for k in sj[t]:
            close(st[t][k], sj[t][k], F64)
    for k in lj[0.0]:
        close(lt[0.0][k], lj[0.0][k], F64)
    assert len(ft) == len(fj) == 2
    for a, b in zip(ht, hj):
        close(a, b, HOST)
    for a, b in zip(h2t, h2j):
        close(a, b, HOST)


def test_integrate_orbits(snapshot, bases):
    """IntegrateOrbits in AllTimeAccel (a circular orbit at r = 1, 50
    steps) and SingleTimeAccel (eight orbits, 10 steps) on both packages:
    exp_tpu's leapfrog evaluates its fields once a step, and each of its
    evaluations compiles anew, so the runs are short."""
    path, x, v, mass = snapshot
    out = []
    for pkg, b in zip((jEXP, tEXP), bases):
        coefs = _series(pkg, b, mass, x, [0.0, 2.0],
                        lambda i, t: 1 + 0.01 * i)
        b.set_coefs(coefs.getCoefStruct(0.0))
        vc = np.sqrt(b.getMass(1.0))
        ps = np.array([[1.0, 0, 0, 0, vc, 0.0]])
        T, O = pkg.basis.IntegrateOrbits(0.0, 1.0, 0.02, ps, [(b, coefs)],
                                         pkg.basis.AllTimeAccel(), nout=10)
        r = np.linalg.norm(O[:, 0, :3], axis=1)
        assert abs(r.max() - 1.0) < 0.2 and abs(r.min() - 1.0) < 0.2
        ps8 = np.concatenate([x[:8], v[:8]], axis=1)
        T8, O8 = pkg.basis.IntegrateOrbits(
            0.0, 0.5, 0.05, ps8, [(b, coefs)],
            pkg.basis.SingleTimeAccel(1.0), nout=5)
        assert O.dtype == O8.dtype == np.float32
        out.append((T, O, T8, O8))
    close(out[1][0], out[0][0], HOST)
    close(out[1][2], out[0][2], HOST)
    close(out[1][1], out[0][1], F32)
    close(out[1][3], out[0][3], F32)


def test_cylinder_geometry_and_midplane(disks):
    """The disk basis through both drop-ins: the cylindrical labels, the
    m-split fields, the coefficients, Power and a midplane slice."""
    rng = np.random.default_rng(4)
    n = 2000
    R = rng.exponential(0.01, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    x = np.stack([R * np.cos(ph), R * np.sin(ph),
                  0.001 + rng.normal(0, 0.002, n)], -1)
    mass = np.full(n, 1.0 / n)
    out = []
    for pkg, b in zip((jEXP, tEXP), disks):
        assert b.getFieldType() == "cylindrical"
        assert b.getFieldLabels()[6:] == ["rad force", "ver force",
                                          "azi force"]
        coefs = _series(pkg, b, mass, x, [0.0, 1.0],
                        lambda i, t: 1 + 0.01 * i, name="disk")
        st = coefs.getCoefStruct(0.0)
        assert st.getGeometry() == "cylinder"
        b.set_coefs(st)
        f1 = b.getFields(0.02, 0.0, 0.001)
        # one time between the two stored ones: the scan runs on the
        # interpolated coefficients
        fg = pkg.field.FieldGenerator([0.5], (-0.03, -0.03, 0),
                                      (0.03, 0.03, 0), (12, 12, 0))
        fg.setMidplane(True)
        fg.setColumnHeight(3.0)
        sl = fg.slices(b, coefs)
        mp = sl[0.5]["midplane"]
        assert mp.shape == (12, 12) and np.abs(mp).max() <= 0.006 + 1e-12
        out.append((st.getCoefs(), coefs.Power(), coefs.getAllCoefs(), f1,
                    sl))
    for t, j in zip(out[1][:4], out[0][:4]):
        close(t, j, F64)
    for t in out[0][4]:
        for k in out[0][4][t]:
            if k == "midplane":
                np.testing.assert_array_equal(out[1][4][t][k],
                                              out[0][4][t][k])
            else:
                close(out[1][4][t][k], out[0][4][t][k], F64)


def test_ortho_and_basis_all_geometries(disks):
    """orthoCheck / getBasis on the cylinder, the slab and the cube."""
    slab = "{id: slabSL, parameters: {nmaxx: 2, nmaxy: 2, nmaxz: 4}}"
    cube = "{id: cube, parameters: {nmaxx: 1, nmaxy: 1, nmaxz: 1}}"
    pairs = {"cylinder": disks,
             "slab": (jEXP.basis.Basis.factory(slab),
                      tEXP.basis.Basis.factory(slab, device="cpu")),
             "cube": (jEXP.basis.Basis.factory(cube),
                      tEXP.basis.Basis.factory(cube, device="cpu"))}
    for geom, (jb, tb) in pairs.items():
        gj, gt = jb.orthoCheck(), tb.orthoCheck()
        assert len(gt) == len(gj)
        for a, b in zip(gt, gj):
            close(a, b, F64)
        if geom == "cube":
            np.testing.assert_allclose(gt[0], np.eye(27), atol=1e-12)
            assert tb.index3D(tb.index1D(1, -1, 0)) == (1, -1, 0)
            assert tb.invI3(5) == jb.invI3(5)
        elif geom == "slab":
            bj, bt = jb.getBasis(numgrid=64), tb.getBasis(numgrid=64)
            for i in range(3):
                for jj in range(3):
                    for n in bj[i][jj]:
                        for k in bj[i][jj][n]:
                            close(bt[i][jj][n][k], bj[i][jj][n][k], F64)
        else:
            # exp_tpu evaluates each (m, n) function at float32 points
            # with a field call of its own (24 calls here, each compiled
            # anew): the port's table against its own field evaluation
            tab = tb.getBasis(logxmin=-2.5, logxmax=-1.0, numgrid=16)
            assert sorted(tab) == [0, 1, 2] and sorted(tab[1]) == [0, 1, 2, 3]
            R = np.logspace(-2.5, -1.0, 16)
            z = np.linspace(-10 ** 0.5, 10 ** 0.5, 4)   # logzmax 0.5
            pts = np.stack([np.repeat(R, 4), np.zeros(64), np.tile(z, 16)],
                           -1).astype(np.float32)
            c = np.zeros((2, 3, 4), np.float32)
            c[0, 1, 2] = 1.0
            d, p, _ = tb.native.get_fields(c, pts)
            assert tab[1][2]["potential"].shape == (16, 4)
            close(tab[1][2]["potential"].ravel(), p, F64)
            close(tab[1][2]["density"].ravel(), d, F64)


# ---------------------------------------------------------------------------
# util, reader summary, FieldBasis
# ---------------------------------------------------------------------------

def test_kddensity_and_reader_summary(snapshot, capsys):
    path, x, v, mass = snapshot
    out = []
    for pkg in (jEXP, tEXP):
        reader = pkg.read.ParticleReader.createReader("ascii", path)
        assert reader.NumFiles() == 1
        reader.PrintSummary(verbose=True)
        text = capsys.readouterr().out
        kd = pkg.util.KDdensity(reader, Ndens=16)
        rho_in = kd.getDensityAtPoint(0.3, 0.0, 0.0)
        rho_out = kd.getDensityAtPoint([8.0, 0.0, 0.0])
        assert rho_in > 30 * rho_out > 0
        seen = []
        pkg.util.particleIterator(reader, lambda *a: seen.append(a[0]))
        out.append((text, [rho_in, rho_out, kd.getDensityByIndex(0)],
                    kd.getDensityAtPoint(x[:16]),
                    pkg.util.getDensityCenter(reader, 2, 0, 16),
                    pkg.util.getCenterOfMass(reader), reader.CurrentTime(),
                    np.asarray(seen)))
    assert out[1][0] == out[0][0] and "N=3000" in out[1][0]
    for t, j in zip(out[1][1:], out[0][1:]):
        close(t, j, HOST)


def test_field_basis_compat(snapshot):
    """VelocityBasis with addPSFunction (the functor gets NumPy rows), the
    one-shot and incremental projections, getFields and orthoCheck."""
    path, x, v, mass = snapshot
    conf = "{parameters: {modelname: hernquist, lmax: 2, nmax: 6, dof: 3}}"
    out = []
    for pkg, kw in ((jEXP, {}), (tEXP, {"device": "cpu"})):
        fb = pkg.basis.VelocityBasis(conf, **kw)
        fb.addPSFunction(lambda m, pos, vel: [float(vel @ vel)], ["v2"])
        reader = pkg.read.ParticleReader.createReader("ascii", path)
        coefs = fb.createFromReader(reader)
        assert {"dens", "vr", "vt", "vp", "v2"} <= set(coefs)
        assert pkg is jEXP or all(isinstance(c, np.ndarray)
                                  for c in coefs.values())
        one = fb.getFields(coefs, 0.5, 0.0, 0.0)
        fb.initFromArray()
        fb.addFromArray(mass, np.concatenate([x, v], axis=1))
        inc = fb.makeFromArray()
        out.append((coefs, one, inc, fb.orthoCheck()))
    (cj, oj, ij, gj), (ct, ot, it, gt) = out
    for k in cj:
        close(ct[k], cj[k], F64)
        close(it[k], ij[k], F64)
        close(ot[k], oj[k], F64)
    for a, b in zip(gt, gj):
        close(a, b, F64)
    assert abs(ot["vr"]) < 0.2 * np.sqrt(ot["v2"])


def test_flat_field_basis_compat():
    """FieldBasis at dof 2 (the flat disk's f64 tables) on both packages."""
    rng = np.random.default_rng(3)
    n = 2000
    R = rng.exponential(0.01, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    x = np.stack([R * np.cos(ph), R * np.sin(ph), np.zeros(n)], -1)
    v = np.stack([-np.sin(ph), np.cos(ph), np.zeros(n)], -1) * 0.3
    mass = np.full(n, 1.0 / n)
    conf = "{parameters: {dof: 2, mmax: 2, nmax: 4, ascl: 0.01}}"
    out = []
    for pkg, kw in ((jEXP, {}), (tEXP, {"device": "cpu"})):
        fb = pkg.basis.FieldBasis(conf, **kw)
        fb.initFromArray()
        fb.addFromArray(mass, np.concatenate([x, v], axis=1))
        c = fb.makeFromArray()
        out.append((c, fb.getFields(c, x[:8, 0], x[:8, 1], x[:8, 2])))
    for k in out[0][0]:
        close(out[1][0][k], out[0][0][k], F64)
        close(out[1][1][k], out[0][1][k], F64)


def test_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    """Basis.factory, FieldBasis and VelocityBasis run on the card unless
    a device is named: with no card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tEXP.basis.Basis.factory(YAML_SPHERE),
                 lambda: tEXP.basis.FieldBasis("{parameters: {nmax: 2}}"),
                 lambda: tEXP.basis.VelocityBasis("{parameters: {nmax: 2}}")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
