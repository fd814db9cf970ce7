"""The port's file I/O (exp_tpu_torch/io/psp.py, io/coefs.py and the body
files of nbody/particles.py) against exp_tpu's: the flows of
tests/test_io.py, files byte-equal where both packages write the same
values, and each package opening the other's files."""

import struct

import h5py
import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

import exp_tpu.io.coefs as jc
import exp_tpu.io.psp as jp
import exp_tpu.nbody.particles as jpart
import exp_tpu_torch.io.coefs as tc
import exp_tpu_torch.io.psp as tp
import exp_tpu_torch.nbody.particles as tpart


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


def _dump(mod, n=100, ncomp=2, seed=0, time=1.25, octant=False):
    rng = np.random.default_rng(seed)
    d = mod.PSPDump(time=time)
    for c in range(ncomp):
        lo = 0.0 if octant else -1.0
        d.components.append(mod.PSPComponent(
            name=f"c{c}", info=f"name: c{c}\n",
            mass=rng.uniform(0.5, 1.0, n),
            x=rng.uniform(lo, 1.0, (n, 3)), v=rng.uniform(lo, 1.0, (n, 3)),
            pot=-rng.uniform(0, 1, n)))
    return d


def _same_dump(a, b):
    assert a.time == b.time and len(a.components) == len(b.components)
    for ca, cb in zip(a.components, b.components):
        assert ca.name == cb.name and ca.info == cb.info
        for k in ("mass", "x", "v", "pot", "indx", "iattr", "dattr"):
            va, vb = getattr(ca, k), getattr(cb, k)
            assert (va is None) == (vb is None), k
            if va is not None:
                np.testing.assert_array_equal(va, vb, err_msg=k)


@pytest.mark.parametrize("real4,indexing", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_psp_files_byte_equal_and_cross_read(tmp_path, real4, indexing):
    pj, pt = tmp_path / "OUT.j", tmp_path / "OUT.t"
    jp.write_psp(str(pj), _dump(jp), real4=real4, indexing=indexing)
    tp.write_psp(str(pt), _dump(tp), real4=real4, indexing=indexing)
    assert pj.read_bytes() == pt.read_bytes()
    _same_dump(tp.read_psp(str(pj)), jp.read_psp(str(pj)))
    back = tp.read_psp(str(pt))
    tol = 1e-6 if real4 else 1e-14      # tests/test_io.py:34
    np.testing.assert_allclose(back.components[0].x, _dump(tp).components[0].x,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("indexing,octant", [(False, False), (True, True)])
def test_psp_multidump_and_truncated_tail(tmp_path, indexing, octant):
    """Appended dumps (and an indexed one-octant series, whose layout the
    boundary bookkeeping must find) read the same in both packages, also
    from a file cut mid-dump (a live OUT file)."""
    p = tmp_path / "OUT.run"
    for k, t in enumerate([0.5, 1.0, 1.5]):
        tp.write_psp(str(p), _dump(tp, n=64, ncomp=1, seed=k, time=t,
                                   octant=octant), indexing=indexing,
                     append=k > 0)
    raw = p.read_bytes()
    for cut in (len(raw), len(raw) - 37, len(raw) - len(raw) // 3):
        q = tmp_path / f"OUT.cut{cut}"
        q.write_bytes(raw[:cut])
        dt, dj = tp.read_psp(str(q)), jp.read_psp(str(q))
        dt = dt if isinstance(dt, list) else [dt]
        dj = dj if isinstance(dj, list) else [dj]
        assert len(dt) == len(dj) >= 1
        for a, b in zip(dt, dj):
            _same_dump(a, b)
    assert [d.time for d in tp.read_psp(str(p))] == [0.5, 1.0, 1.5]


@pytest.mark.parametrize("indexing", [False, True])
def test_spl_files_byte_equal_and_cross_read(tmp_path, indexing):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    mj, mt = tmp_path / "j" / "SPL.r.00000", tmp_path / "t" / "SPL.r.00000"
    jp.write_spl(str(mj), _dump(jp), nparts=3, indexing=indexing)
    tp.write_spl(str(mt), _dump(tp), nparts=3, indexing=indexing)
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "t").iterdir())
    for nm in names:
        assert (tmp_path / "j" / nm).read_bytes() == \
            (tmp_path / "t" / nm).read_bytes()
    _same_dump(tp.read_psp_any(str(mj)), jp.read_psp_any(str(mt)))


def test_ascii_bodies_byte_equal_and_cross_read(tmp_path):
    rng = np.random.default_rng(3)
    x, v, m = rng.normal(size=(257, 3)), rng.normal(size=(257, 3)), \
        rng.uniform(0.1, 1.0, 257)
    jpart.write_ascii_bodies(tmp_path / "j.bods", (x, v, m))
    tpart.write_ascii_bodies(tmp_path / "t.bods", (x, v, m))
    assert (tmp_path / "j.bods").read_bytes() == \
        (tmp_path / "t.bods").read_bytes()
    ps = tpart.read_bodies(str(tmp_path / "j.bods"), dtype=torch.float64,
                           device="cpu")
    np.testing.assert_array_equal(ps.x.numpy(), x)      # %.16e is exact
    np.testing.assert_array_equal(ps.mass.numpy(), m)
    np.testing.assert_array_equal(ps.indx.numpy(), np.arange(1, 258))
    # a ParticleSystem writes its live rows only, as exp_tpu's writer
    ps.mass[5] = 0.0
    tpart.write_ascii_bodies(tmp_path / "live.bods", ps)
    xj, _, mj = jpart.read_ascii_arrays(str(tmp_path / "live.bods"))
    assert len(mj) == 256 and np.array_equal(xj, np.delete(x, 5, 0))


def test_ascii_attributes_and_scale_column(tmp_path):
    """Attribute columns are skipped by the body read; the dts scale comes
    from the named dattr column (tests/test_io.py:193's table shape)."""
    rng = np.random.default_rng(5)
    n = 500
    arr = rng.normal(0, 1, (n, 10))     # 7 body columns + 1 iattr + 2 dattr
    p = tmp_path / "t.bods"
    with open(p, "w") as f:
        f.write(f"{n} 1 2\n")
        np.savetxt(f, arr, fmt="%.10e")
    xt, vt, mt = tpart.read_ascii_arrays(str(p))
    xj, vj, mj = jpart.read_ascii_arrays(str(p))
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(tpart.read_ascii_dattr(str(p), 1),
                                  jpart.read_ascii_dattr(str(p), 1))
    ps = tpart.read_bodies(str(p), dtype=torch.float64, scale_dattr=1,
                           device="cpu")
    np.testing.assert_array_equal(ps.scale.numpy(),
                                  jpart.read_ascii_dattr(str(p), 1))
    with pytest.raises(ValueError):
        tpart.read_ascii_dattr(str(p), 2)
    with open(tmp_path / "short.bods", "w") as f:
        f.write(f"{n + 1} 1 2\n")
        np.savetxt(f, arr, fmt="%.10e")
    with pytest.raises(ValueError, match="expected"):
        tpart.read_ascii_arrays(str(tmp_path / "short.bods"))


def test_read_bodies_sniffs_psp_and_picks_the_component(tmp_path):
    p = tmp_path / "two.psp"
    jp.write_psp(str(p), _dump(jp), indexing=True)
    assert tpart.is_psp_file(str(p)) and jpart.is_psp_file(str(p))
    assert not tpart.is_psp_file(str(tmp_path / "missing"))
    ps = tpart.read_bodies(str(p), dtype=torch.float64, component="c1",
                           device="cpu")
    c1 = _dump(jp).components[1]
    np.testing.assert_array_equal(ps.x.numpy(), c1.x)
    np.testing.assert_array_equal(ps.indx.numpy(), np.arange(1, 101))
    with pytest.raises(ValueError, match="none named"):
        tpart.read_bodies(str(p), component="c9", device="cpu")


def _coef_files():
    rng = np.random.default_rng(2)
    sph = rng.normal(size=(2, 3, 3, 4))
    for l in range(3):                  # the packed layout holds m <= l
        sph[:, l, l + 1:] = 0.0
    cyl = rng.normal(size=(2, 4, 5))
    cube = rng.normal(size=(5, 3, 7)) + 1j * rng.normal(size=(5, 3, 7))
    slab = rng.normal(size=(5, 3, 4)) + 1j * rng.normal(size=(5, 3, 4))
    tbl = rng.normal(size=6) + 1j * rng.normal(size=6)
    fld = rng.normal(size=(4, 6, 3)) + 1j * rng.normal(size=(4, 6, 3))
    cfld = rng.normal(size=(2, 3, 3)) + 1j * rng.normal(size=(2, 3, 3))
    return {
        "sph": (lambda m, p: m.SphCoefsFile(p, "w", name="h", lmax=2, nmax=4,
                                            scale=0.5), sph),
        "cyl": (lambda m, p: m.CylCoefsFile(p, "w", name="d", mmax=3,
                                            nmax=5), cyl),
        "cube": (lambda m, p: m.CubeCoefsFile(p, "w", name="c", nmaxx=2,
                                              nmaxy=1, nmaxz=3), cube),
        "slab": (lambda m, p: m.SlabCoefsFile(p, "w", name="s", nmaxx=2,
                                              nmaxy=1, nmaxz=4), slab),
        "table": (lambda m, p: m.TableCoefsFile(p, "w", name="t", cols=6),
                  tbl),
        "sphfld": (lambda m, p: m.SphFldCoefsFile(
            p, "w", name="f", nfld=4, angmax=2, nmax=3,
            labels=("dens", "vr", "vt", "vp")), fld),
        "cylfld": (lambda m, p: m.CylFldCoefsFile(p, "w", name="g", nfld=2,
                                                  angmax=2, nmax=3), cfld),
    }


@pytest.mark.parametrize("kind", list(_coef_files()))
def test_coef_files_byte_equal_and_cross_read(tmp_path, kind):
    make, data = _coef_files()[kind]
    paths = {}
    for tag, mod in (("j", jc), ("t", tc)):
        paths[tag] = str(tmp_path / f"{kind}.{tag}.h5")
        f = make(mod, paths[tag])
        for k, t in enumerate((0.0, 0.5, 1.0)):
            f.append(t, data * (1 + k))
        f.close()
    assert open(paths["j"], "rb").read() == open(paths["t"], "rb").read()
    for opener, path in ((tc.open_coefs, paths["j"]),
                         (jc.open_coefs, paths["t"])):
        with opener(path) as f:
            times, coefs = f.read_all()
        np.testing.assert_array_equal(times, [0.0, 0.5, 1.0])
        want = np.asarray(data)
        if kind == "cyl":
            want = want.astype(np.float64)
        np.testing.assert_array_equal(coefs[2], 3 * want)
    with tc.open_coefs(paths["j"]) as f, jc.open_coefs(paths["t"]) as g:
        assert type(f).__name__ == type(g).__name__
        np.testing.assert_array_equal(f.times(), g.times())


def test_bytes_string_attrs(tmp_path):
    """Files whose string attributes are fixed-length ASCII (bytes in h5py:
    the reference's HighFive writer) open in the port (test_io.py:459)."""
    p = tmp_path / "ref_style.h5"
    with h5py.File(p, "w") as f:
        f.attrs["CoefficientOutputVersion"] = np.bytes_("1.0")
        f.attrs["geometry"] = np.bytes_("sphere")
        f.attrs["name"] = np.bytes_("dark halo")
        f.attrs["config"] = np.bytes_("")
        f.attrs["forceID"] = np.bytes_("sphereSL")
        f.attrs["lmax"] = np.int32(1)
        f.attrs["nmax"] = np.int32(2)
        f.attrs["scale"] = 1.0
        f.create_dataset("count", data=np.uint32(1))
        g = f.create_group("snapshots").create_group("00000000")
        g.attrs["Time"] = 0.0
        g.attrs["Center"] = np.zeros(3)
        g.create_dataset("coefficients", data=np.ones((3, 2), np.complex128))
    with tc.open_coefs(str(p)) as cf:
        assert cf.geometry == "sphere" and cf.lmax == 1
        _, c = cf.read_all()
    assert c.shape == (1, 2, 2, 2, 2)


def test_native_binary_coefs_read_the_same(tmp_path):
    """EXP native (pre-HDF5) outcoef records, new-style sphere (normed),
    legacy sphere (un-normed) and cylinder, read the same by both packages
    (the records of tests/test_io.py:372)."""
    rng = np.random.default_rng(0)
    lmax, nmax = 2, 4
    coef = rng.normal(size=(2, lmax + 1, lmax + 1, nmax))
    for l in range(lmax + 1):
        coef[:, l, l + 1:] = 0.0
    coef[1, :, 0] = 0.0
    mat = tc.pack_sph_matrix(coef)
    p = tmp_path / "sph.bin"
    with open(p, "wb") as f:
        for it, t in enumerate([0.0, 0.5]):
            hdr = (f"lmax: {lmax}\nnmax: {nmax}\ntime: {t}\n"
                   f"scale: 1.0\nnormed: true\nid: sphereSL\n").encode()
            f.write(struct.pack("<II", 0xc0a57a2, len(hdr)))
            f.write(hdr)
            for ir in range(nmax):
                L = 0
                for l in range(lmax + 1):
                    for mm in range(l + 1):
                        f.write(struct.pack("<d", (1 + it) * mat[L, ir].real))
                        if mm:
                            f.write(struct.pack("<d",
                                                (1 + it) * mat[L, ir].imag))
                        L += 1
    p2 = tmp_path / "sph_legacy.bin"
    fac = tc._sph_prefactors(lmax)
    with open(p2, "wb") as f:
        f.write(b"sphereSL".ljust(64, b"\0"))
        f.write(struct.pack("<ddii", 0.25, 1.0, nmax, lmax))
        for ir in range(nmax):
            L = 0
            for l in range(lmax + 1):
                for mm in range(l + 1):
                    f.write(struct.pack("<d", mat[L, ir].real / fac[l, mm]))
                    if mm:
                        f.write(struct.pack("<d", mat[L, ir].imag / fac[l, mm]))
                    L += 1
    mmax, cn = 3, 5
    cc = rng.normal(size=(2, mmax + 1, cn))
    cc[1, 0] = 0.0
    p3 = tmp_path / "cyl.bin"
    with open(p3, "wb") as f:
        hdr = f"time: 1.5\nnmax: {cn}\nmmax: {mmax}\n".encode()
        f.write(struct.pack("<II", 0xc0a57a3, len(hdr)))
        f.write(hdr)
        for mm in range(mmax + 1):
            f.write(cc[0, mm].astype("<f8").tobytes())
            if mm:
                f.write(cc[1, mm].astype("<f8").tobytes())
    for path, want in ((p, coef), (p2, coef), (p3, cc)):
        gt, tt, at, mt = tc.read_native_coefs(str(path))
        gj, tj, aj, mj = jc.read_native_coefs(str(path))
        assert gt == gj and mt == mj
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(at, aj)
        np.testing.assert_allclose(at[0], want, atol=1e-12)
