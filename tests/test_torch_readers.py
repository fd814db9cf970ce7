"""The port's snapshot readers (exp_tpu_torch/io/readers.py) against
exp_tpu's: the reader cases of tests/test_io.py (Gadget HDF5, Tipsy read
and write, Gadget native, the field-coefficient file) and createReader's
ascii, PSP and SPL dispatch.  A file written by one package is read by
the other; files written from the same arrays are byte-equal where the
format holds no time stamp (Tipsy, Gadget native), and equal after reading
where it does (HDF5).  The field-coefficient series of the two packages
agree to F32 (1e-8 of the largest density coefficient, times max|v| for a
velocity field: f32 particles through f32 tables, f64 sums in another
order; measured 7e-10)."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.io import readers as J
from exp_tpu_torch.io import readers as T


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


F32 = 1e-8


def _snapshot(M, time=0.75, pot=False):
    rng = np.random.default_rng(11)
    s = M.Snapshot(time)
    for name, n in (("Halo", 200), ("Disk", 100)):
        s.add(name, rng.normal(0, 1, (n, 3)), rng.normal(0, 1, (n, 3)),
              rng.uniform(0.1, 1.0, n),
              pot=rng.normal(size=n) if pot else None)
    return s


def _same(a, b):
    assert a.time == b.time
    assert a.GetTypes() == b.GetTypes()
    for name in a.GetTypes():
        for u, w in zip(a.GetParticles(name), b.GetParticles(name)):
            np.testing.assert_array_equal(u, w)


def test_gadget_hdf5_roundtrip(tmp_path):
    """Gadget HDF5 written by each package reads back the same in both."""
    for W, tag in ((T, "t"), (J, "j")):
        p = str(tmp_path / f"snap_{tag}.h5")
        W.write_gadget_hdf5(p, _snapshot(W, 0.5))
        back = T.read_gadget_hdf5(p)
        _same(back, J.read_gadget_hdf5(p))
        assert back.time == 0.5
        x, v, m = back.GetParticles()
        assert x.shape == (200, 3)
    _same(T.createReader("gadgethdf5", str(tmp_path / "snap_j.h5")),
          T.read_gadget_hdf5(str(tmp_path / "snap_t.h5")))


def test_tipsy_read(tmp_path):
    """A little-endian Tipsy file (tests/test_io.py's) reads the same."""
    hdr = np.zeros(1, np.dtype([("time", "<f8"), ("nbodies", "<i4"),
                                ("ndim", "<i4"), ("nsph", "<i4"),
                                ("ndark", "<i4"), ("nstar", "<i4"),
                                ("pad", "<i4")]))
    hdr["time"], hdr["nbodies"], hdr["ndim"], hdr["ndark"] = 0.75, 10, 3, 10
    dark = np.zeros(10, np.dtype([("mass", "<f4"), ("pos", "<f4", (3,)),
                                  ("vel", "<f4", (3,)), ("eps", "<f4"),
                                  ("phi", "<f4")]))
    dark["mass"] = 0.1
    dark["pos"] = np.arange(30).reshape(10, 3)
    p = tmp_path / "snap.tipsy"
    p.write_bytes(hdr.tobytes() + dark.tobytes())
    s = T.read_tipsy(str(p))
    _same(s, J.read_tipsy(str(p)))
    x, v, m = s.GetParticles("dark")
    np.testing.assert_allclose(m, 0.1, rtol=1e-6)
    assert x[3, 1] == 10.0


def test_tipsy_write_roundtrip(tmp_path):
    """write_tipsy from the same snapshot: the same bytes as exp_tpu's
    (XDR layout, 28-byte header), read back the same by both."""
    rng = np.random.default_rng(3)
    out = {}
    for M, tag in ((T, "t"), (J, "j")):
        rng = np.random.default_rng(3)
        s = M.Snapshot(1.25)
        s.add("gas", rng.normal(size=(7, 3)), rng.normal(size=(7, 3)),
              rng.uniform(0.1, 1, 7), pot=rng.normal(size=7))
        s.add("dark", rng.normal(size=(11, 3)), rng.normal(size=(11, 3)),
              rng.uniform(0.1, 1, 11), pot=rng.normal(size=11))
        s.add("star", rng.normal(size=(5, 3)), rng.normal(size=(5, 3)),
              rng.uniform(0.1, 1, 5))
        p = tmp_path / f"out_{tag}.tipsy"
        M.write_tipsy(str(p), s, eps=0.01)
        out[tag] = p
    raw = out["t"].read_bytes()
    assert raw == out["j"].read_bytes()
    assert len(raw) == 28 + 7 * 48 + 11 * 36 + 5 * 44
    _same(T.read_tipsy(str(out["t"])), J.read_tipsy(str(out["t"])))


def test_gadget_native_roundtrip(tmp_path):
    """Gadget-1 native binary from the same snapshot: the same bytes, read
    back the same by both, through createReader too."""
    pt, pj = tmp_path / "snap_t", tmp_path / "snap_j"
    T.write_gadget_native(str(pt), _snapshot(T))
    J.write_gadget_native(str(pj), _snapshot(J))
    assert pt.read_bytes() == pj.read_bytes()
    back = T.read_gadget_native(str(pt))
    _same(back, J.read_gadget_native(str(pt)))
    assert set(back.GetTypes()) == {"Halo", "Disk"}
    x0, v0, m0 = _snapshot(T).GetParticles("Disk")
    np.testing.assert_allclose(back.GetParticles("Disk")[0], x0, rtol=1e-6,
                               atol=1e-6)
    _same(T.createReader("gadgetnative", str(pt)), back)


def test_ascii_psp_spl_readers(tmp_path):
    """createReader's ascii, PSP and SPL dispatch read the same arrays as
    exp_tpu's from files the port wrote."""
    from exp_tpu_torch.io.psp import PSPComponent, PSPDump, write_psp
    from exp_tpu_torch.io.psp import write_spl
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    rng = np.random.default_rng(5)
    x, v, m = rng.normal(size=(64, 3)), rng.normal(size=(64, 3)), \
        rng.uniform(0.5, 1.0, 64)
    write_ascii_bodies(tmp_path / "b.bods", (x, v, m))
    s = T.createReader("ascii", str(tmp_path / "b.bods"), time=0.5)
    _same(s, J.createReader("ascii", str(tmp_path / "b.bods"), time=0.5))
    np.testing.assert_array_equal(s.GetParticles()[0], x)
    d = PSPDump(time=0.25, components=[PSPComponent(
        name="disk", info="name: disk\n", mass=m, x=x, v=v,
        pot=rng.normal(size=64))])
    write_psp(str(tmp_path / "OUT.r.00000"), d)
    s = T.createReader("psp", str(tmp_path / "OUT.r.00000"))
    _same(s, J.createReader("psp", str(tmp_path / "OUT.r.00000")))
    np.testing.assert_array_equal(s["disk"]["pot"], d.components[0].pot)
    master = str(tmp_path / "SPL.r.00000")
    write_spl(master, d, nparts=2)
    s = T.createReader("pspspl", master)
    _same(s, J.createReader("pspspl", master))
    _same(T.createReader("psp", master), s)
    with pytest.raises(ValueError, match="unknown reader"):
        T.createReader("nosuch", master)


def test_field_coefs_roundtrip(tmp_path):
    """FieldBasis on CBsphere (lmax 2, nmax 3) over 3 f32 snapshots: the
    port's series against exp_tpu's (F32), and each package's field
    coefficient file read back by the other to the bit."""
    from exp_tpu.analysis.field_basis import FieldBasis as JFB
    from exp_tpu.basis.analytic import make_analytic_force as jmake
    from exp_tpu_torch.analysis.field_basis import FieldBasis as TFB
    from exp_tpu_torch.basis.analytic import make_analytic_force

    rng = np.random.default_rng(1)
    snaps = []
    for _ in range(3):
        x = rng.normal(0, 0.3, (2000, 3)).astype(np.float32)
        v = rng.normal(0, 0.1, (2000, 3)).astype(np.float32)
        snaps.append((x, v, np.full(2000, 1 / 2000, np.float32)))
    ft = TFB(make_analytic_force("CBsphere", lmax=2, nmax=3, device="cpu"),
             "spherical")
    fj = JFB(jmake("CBsphere", lmax=2, nmax=3), "spherical")
    st, sj = ft.create_from_snapshots(snaps), fj.create_from_snapshots(snaps)
    assert list(st) == list(sj) == ["dens", "vr", "vt", "vp"]
    # a velocity field's weights m v change sign: its sums are held at the
    # scale of the sums of |m v|, max|c_dens| max|v|
    vmax = max(np.abs(v).max() for _, v, _ in snaps)
    for k in sj:
        scale = np.abs(sj["dens"]).max() * (1.0 if k == "dens" else vmax)
        err = np.abs(st[k] - sj[k]).max()
        print(f"{k}: max|d| {err:.3e} of scale {scale:.3e}")
        assert err <= F32 * scale, k
    for W, R, ser in ((ft, JFB, st), (fj, TFB, sj)):
        p = str(tmp_path / f"fld_{type(W).__module__}.h5")
        W.write_coefs(p, [0.0, 0.5, 1.0], ser, name="halo")
        times, back = R.read_coefs(p)
        assert np.allclose(times, [0.0, 0.5, 1.0])
        for k in ser:
            np.testing.assert_array_equal(back[k], ser[k].astype(
                back[k].dtype))
