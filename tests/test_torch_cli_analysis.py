"""The port's analysis, MSSA and basis tools (exp_tpu_torch/cli: haloprof,
diskprof (+--coef), sphprof, slabprof, viewcoefs, h5compare, h5power,
mssaprof, slcheck, orthochk, scalarprod, cylcache, eofinfo, makecoefs,
coefstoh5, crossval, kldiv, diskeof, diskfreqs, slshift, expmssa,
mssafilter, yamldiff and the umbrella) against exp_tpu's, on the flows of
tests/test_cli.py (:58, :71, :102, :121, :167, :222, :258, :287, :310,
:381, :395, :427, :636, :681, :733, :893), tests/test_kincoefs.py:376 and
tests/test_diskeof.py:70.  Each flow runs exp_tpu's tool and then the
port's with --cpu on the same argv, each in its own directory, and holds:
  * the return codes and the printed lines equal (paths aside); where a
    line prints a table build's roundoff (orthochk's max|B+I| ~ 1e-15 from
    ARPACK's eigenvectors), its numbers to HOST of max(1, |value|);
  * files of host NumPy on equal inputs (the profiles, the SL dump, the
    MSSA products, the EOF midplane dump) equal byte for byte;
  * HDF5 files equal dataset by dataset and attribute by attribute, to
    HOST (1e-12 of the largest value) where host NumPy wrote them and to
    F64 (1e-10) where an f64 basis projected them;
  * the f64 fields (sphprof, diskprof --coef) and diskeof's tables and
    grids (f64 sums over the cache's f32 tables) to F64;
  * F32SUM (1e-5 of the largest value) where exp_tpu's tool sums
    coefficients in float32 (the forces' default accum_dtype): diskfreqs'
    table and slshift's coefficients (measured 4.7e-8 and 4.0e-8);
  * SLSHIFT_PROFILE (1e-4 of the largest value): slshift's on-axis
    density from those f32 coefficients, whose differences the basis
    densities near the cusp multiply (measured 7.0e-6 to 2.6e-5: each
    package's SL tables carry ARPACK's roundoff, ~1e-15, of its own run).
The diskprof flow reads a disk body file written by exp_tpu's gendisk.
"""

import importlib
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
F32SUM = 1e-5
SLSHIFT_PROFILE = 1e-4

# the EOF cache of tests/test_cli.py:287 and :310
EOF_KW = dict(mmax=1, nmax=4, lmaxfid=8, nmaxfid=8, acyl=1.0, hcyl=0.1,
              rcylmin=1e-3, rcylmax=20.0, numx=64, numy=32, rnum=60,
              tnum=20)


def close(t, j, tol, scale=None):
    """max|t - j| <= tol * max|j| (or tol * scale)."""
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    s = np.abs(j).max() if scale is None else scale
    err = np.abs(t - j).max() if t.size else 0.0
    print(f"max|d| {err:.3e} of scale {s:.3e} (tolerance {tol:.1e})")
    assert err <= tol * s, f"max|d| {err:.3e} > {tol:.1e} x {s:.3e}"
    return err


def _both(tmp_path, tool, argv, capsys, monkeypatch, copies=(), tag=""):
    """exp_tpu's `tool`, then the port's with --cpu, each run from its own
    directory (where `copies` are copied first) on `argv`; returns
    [(directory, return code, stdout), ...], exp_tpu's first."""
    out = []
    for who, pkg, extra in (("j", "exp_tpu", []),
                            ("t", "exp_tpu_torch", ["--cpu"])):
        d = tmp_path / f"{who}{tag}"
        d.mkdir()
        for c in copies:
            shutil.copy(c, d)
        monkeypatch.chdir(d)
        capsys.readouterr()
        main = importlib.import_module(f"{pkg}.cli.{tool}").main
        rc = main(list(argv) + extra)
        text = capsys.readouterr().out.replace(str(d), "<dir>")
        out.append((d, rc or 0, text))
    monkeypatch.chdir(tmp_path)
    (_, rj, oj), (_, rt, ot) = out
    assert rt == rj, (rt, rj)
    return out


def _same_text(runs, tol=None):
    """The printed lines equal; with `tol`, each number within tol of
    max(1, |value|) and every other word equal."""
    a, b = runs[0][2], runs[1][2]
    if tol is None:
        assert b == a, (b, a)
        return
    import re

    num = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb), (b, a)
    for x, y in zip(la, lb):
        assert num.sub("#", x) == num.sub("#", y), (y, x)
        for u, v in zip(num.findall(x), num.findall(y)):
            assert abs(float(u) - float(v)) <= tol * max(1.0, abs(float(u))), \
                (y, x)


def _same_bytes(runs, *names):
    for f in names:
        a, b = ((r[0] / f).read_bytes() for r in runs)
        assert a == b, f


def _same_h5(runs, name, tol):
    """Two HDF5 files: the same groups, datasets and attributes; the data
    within `tol` of each dataset's largest value."""
    import h5py

    def walk(path):
        items = {}
        with h5py.File(path, "r") as f:
            def visit(k, obj):
                attrs = {a: np.asarray(v) for a, v in obj.attrs.items()}
                data = (np.asarray(obj[()]) if isinstance(obj, h5py.Dataset)
                        else None)
                items[k] = (attrs, data)
            visit("/", f)
            f.visititems(visit)
        return items

    a, b = (walk(r[0] / name) for r in runs)
    assert sorted(a) == sorted(b)
    for k in a:
        (aa, da), (ab, db) = a[k], b[k]
        assert sorted(aa) == sorted(ab), k
        for at in aa:
            if aa[at].dtype.kind in "fc":
                close(ab[at], aa[at], HOST, scale=max(
                    1.0, float(np.abs(aa[at]).max(initial=0.0))))
            else:
                assert np.array_equal(aa[at], ab[at]), (k, at)
        if da is not None:
            if da.dtype.kind in "fc" and da.size:
                close(db, da, tol, scale=max(np.abs(da).max(), 1e-300))
            else:
                assert np.array_equal(da, db), k


def _tables(runs, name, tol):
    a, b = (np.loadtxt(r[0] / name) for r in runs)
    close(b, a, tol)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The inputs the flows share: tests/test_cli.py's 2,000-particle
    Hernquist halo (seed 3) as bodies, exp_tpu's gendisk body file and the
    port's (dt.bods), an EOF cache, an 8,000-particle genslab sheet."""
    from exp_tpu.basis.empcyl import build_empcyl_tables
    from exp_tpu.basis.model import hernquist_model
    from exp_tpu.cli.gendisk import main as gendisk
    from exp_tpu.cli.genslab import main as genslab
    from exp_tpu.ic.eddington import sample_spherical_model
    from exp_tpu.nbody.particles import write_ascii_bodies

    d = tmp_path_factory.mktemp("cliwork")
    x, v, mass = sample_spherical_model(
        hernquist_model(rmin=1e-4, rmax=20.0), 2000, seed=3)
    write_ascii_bodies(d / "h.bods", (x, v, mass))
    gendisk(["-N", "3000", "-o", str(d / "d.bods"), "--acyl", "1.0",
             "--hcyl", "0.1", "--mass", "1.0"])
    from exp_tpu_torch.cli.gendisk import main as t_gendisk

    t_gendisk(["-N", "3000", "-o", str(d / "dt.bods"), "--acyl", "1.0",
               "--hcyl", "0.1", "--mass", "1.0", "--cpu"])
    genslab(["-N", "8000", "-o", str(d / "s.bods"), "--z0", "0.02",
             "-s", "4"])
    build_empcyl_tables(cachename=str(d / "eof.h5"), **EOF_KW)
    return d


# ---------------------------------------------------------------------------
# SL / basis tools
# ---------------------------------------------------------------------------

def test_orthochk_slcheck(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:58, and slcheck's table dump."""
    r = _both(tmp_path, "orthochk", ["-i", "hernquist", "--lmax", "1",
                                     "--nmax", "6", "--numr", "500"],
              capsys, monkeypatch)
    assert r[1][1] == 0 and "PASS" in r[1][2]
    _same_text(r, HOST)
    r = _both(tmp_path, "slcheck", ["-i", "plummer", "--lmax", "1", "--nmax",
                                    "4", "--numr", "400", "-o", "sl.txt"],
              capsys, monkeypatch, tag="s")
    assert "eigenvalues" in r[1][2]
    _same_text(r)
    _tables(r, "sl.txt", HOST)


@pytest.mark.parametrize("argv", [
    ["--geometry", "slab", "--nmax", "4", "--tol", "1e-2"],
    ["--geometry", "cube", "--tol", "1e-6"],
    ["--geometry", "flatdisk", "--nmax", "6", "-i", "kuzmin", "--tol",
     "5e-2"],
    ["--geometry", "sphere", "--lmax", "1", "--nmax", "6", "--numr", "500",
     "--tol", "1e-20"],
], ids=["slab", "cube", "flatdisk", "sphere-fail"])
def test_orthochk_geometries(tmp_path, capsys, monkeypatch, argv):
    """tests/test_cli.py:167 and :893 (the pyEXP branch and the flat
    disk); an unmet --tol exits 1 on both."""
    r = _both(tmp_path, "orthochk", argv, capsys, monkeypatch)
    _same_text(r, HOST)
    assert r[1][1] == (1 if argv[-1] == "1e-20" else 0)


def test_cylcache_and_eofinfo(tmp_path, work, capsys, monkeypatch):
    """cylcache builds an EOF cache on both (equal dataset by dataset);
    eofinfo prints it, dumps its midplane and compares it with itself and
    with tests/test_cli.py:222's cache of another acyl."""
    from exp_tpu.basis.empcyl import build_empcyl_tables

    other = str(tmp_path / "eof2.h5")
    build_empcyl_tables(mmax=1, nmax=4, lmaxfid=8, nmaxfid=6, acyl=0.01,
                        hcyl=0.002, numx=48, numy=24, rnum=50, tnum=16,
                        cachename=other)
    r = _both(tmp_path, "cylcache", [
        "-o", "c.h5", "--mmax", "1", "--nmax", "4", "--lmaxfid", "8",
        "--nmaxfid", "6", "--acyl", "0.012", "--hcyl", "0.002",
        "--ncylnx", "48", "--ncylny", "24"], capsys, monkeypatch)
    assert "wrote c.h5" in r[1][2]
    _same_h5(r, "c.h5", HOST)
    for tag, argv in (("d", ["c.h5", "--dump"]),
                      ("m", ["c.h5", "--dump", "--m", "1"]),
                      ("s", ["c.h5", "--compare", "c.h5"]),
                      ("c", ["c.h5", "--compare", other])):
        r2 = _both(tmp_path, "eofinfo", argv, capsys, monkeypatch,
                   copies=[r[0][0] / "c.h5"], tag=tag)
        _same_text(r2)
        if tag in "dm":
            _same_bytes(r2, "c.h5.midplane")
        elif tag == "s":
            assert "worst relative difference: 0.000e+00" in r2[1][2]
        else:
            worst = float(r2[1][2].strip().splitlines()[-1].split()[-1])
            assert worst > 0


def test_slshift(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:733."""
    r = _both(tmp_path, "slshift", [
        "-i", "hernquist", "--offset", "0.2", "--lmax", "6", "--nmax", "10",
        "--numr", "600", "--nquad-r", "200", "--nquad-t", "120", "-o", "sh"],
        capsys, monkeypatch)
    assert r[1][1] == 0 and "rel err" in r[1][2]
    assert [ln.split(";")[0] for ln in r[1][2].splitlines()] == \
        [ln.split(";")[0] for ln in r[0][2].splitlines()]
    _tables(r, "sh.coefs", F32SUM)
    a, b = (np.loadtxt(x[0] / "sh.profile") for x in r)
    close(b[:, 0], a[:, 0], 0.0)
    close(b[:, 2], a[:, 2], HOST)
    close(b[:, 1], a[:, 1], SLSHIFT_PROFILE)


# ---------------------------------------------------------------------------
# coefficient files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coef_files(tmp_path_factory):
    """tests/test_cli.py:71's 20-snapshot sphere file, a copy with the
    first snapshot scaled by 1.01, and :636's 48-snapshot signal + noise
    file, written by exp_tpu."""
    from exp_tpu.analysis.coefs import Coefs

    d = tmp_path_factory.mktemp("coefs")
    rng = np.random.default_rng(0)
    c = Coefs(geometry="sphere", name="t", meta={"lmax": 2, "nmax": 4})
    base = rng.normal(0, 1, (2, 3, 3, 4))
    for i in range(20):
        c.add(i * 0.1, base * (1 + 0.1 * np.sin(0.7 * i)))
    c.to_file(str(d / "a.h5"))
    c2 = c.deepcopy()
    t0 = list(c2._data)[0]
    c2._data[t0] = c2._data[t0] * 1.01
    c2.to_file(str(d / "b.h5"))

    rng = np.random.default_rng(5)
    c = Coefs(geometry="sphere", name="t", meta={"lmax": 1, "nmax": 3})
    base = rng.normal(0, 1, (2, 2, 2, 3))
    for l in range(2):
        base[:, l, l + 1:] = 0.0
    base[1, :, 0] = 0.0
    for i in range(48):
        sig = base * (1.0 + 0.5 * np.sin(2 * np.pi * i / 24.0))
        noise = 0.01 * rng.normal(0, 1, base.shape)
        for l in range(2):
            noise[:, l, l + 1:] = 0.0
        noise[1, :, 0] = 0.0
        c.add(i * 0.1, sig + noise)
    c.to_file(str(d / "c.h5"))
    return d


def test_coef_tools(tmp_path, coef_files, capsys, monkeypatch):
    """tests/test_cli.py:71 (viewcoefs, h5compare, mssaprof) and
    tests/test_kincoefs.py:506 (h5power)."""
    a, b = str(coef_files / "a.h5"), str(coef_files / "b.h5")
    r = _both(tmp_path, "viewcoefs", [a], capsys, monkeypatch, tag="v")
    assert "snaps=20" in r[1][2]
    _same_text(r)
    for tag, argv, rc in (("s", [a, a], 0), ("d", [a, b], 1),
                          ("l", [a, b, "--tol", "0.1"], 0)):
        r = _both(tmp_path, "h5compare", argv, capsys, monkeypatch, tag=tag)
        assert r[1][1] == rc
        _same_text(r)
    r = _both(tmp_path, "mssaprof", [a, "--window", "8", "--numpc", "4",
                                     "-o", "a.mssa"], capsys, monkeypatch,
              tag="m")
    assert "contributions" in r[1][2]
    _same_text(r)
    _same_bytes(r, "a.mssa")
    r = _both(tmp_path, "h5power", [a, "-o", "p.pow"], capsys, monkeypatch,
              tag="p")
    _same_text(r)
    _same_bytes(r, "p.pow")
    r = _both(tmp_path, "h5power", [a], capsys, monkeypatch, tag="o")
    _same_text(r)


def test_mssafilter(tmp_path, coef_files, capsys, monkeypatch):
    """tests/test_cli.py:636: the filtered and residual files, and the
    eigenvalue listing; a joint two-run analysis (exp_haloN)."""
    c = str(coef_files / "c.h5")
    r = _both(tmp_path, "mssafilter", ["-d", c, "-o", "nf", "-W", "12",
                                       "-e", "0.05"], capsys, monkeypatch)
    assert "keeping" in r[1][2]
    _same_text(r)
    _same_h5(r, "nf.recon", HOST)
    _same_h5(r, "nf.recon_diff", HOST)
    r = _both(tmp_path, "mssafilter", ["-d", c, "-E", "-W", "12"], capsys,
              monkeypatch, tag="e")
    assert len(r[1][2].strip().splitlines()) > 3
    _same_text(r)
    r = _both(tmp_path, "mssafilter", ["-d", c, "-d", c, "-o", "j", "-W",
                                       "12", "-z", "-t", "0.5"], capsys,
              monkeypatch, tag="j")
    _same_text(r)
    for f in ("j.0.recon", "j.1.recon", "j.0.recon_diff"):
        _same_h5(r, f, HOST)


def test_expmssa(tmp_path, coef_files, capsys, monkeypatch):
    """tests/test_cli.py:681: the text products and the grouped
    reconstructions, by a group file and by k-means."""
    c = str(coef_files / "c.h5")
    grp = tmp_path / "group.list"
    grp.write_text("0 1\n2 3\n")
    r = _both(tmp_path, "expmssa", ["-d", c, "-o", "em", "-W", "12", "-C",
                                    "-H", "-G", str(grp)], capsys,
              monkeypatch)
    assert r[1][1] == 0
    _same_text(r)
    _same_bytes(r, "em.data", "em.ev", "em.evec", "em.pc", "em.f_contrib",
                "em.wcorr")
    _same_h5(r, "em.g0.recon", HOST)
    _same_h5(r, "em.g1.recon", HOST)
    r = _both(tmp_path, "expmssa", ["-d", c, "-o", "km", "-W", "12",
                                    "--kmeans", "2"], capsys, monkeypatch,
              tag="k")
    _same_text(r)
    _same_h5(r, "km.g0.recon", HOST)
    r = _both(tmp_path, "expmssa", ["-d", c, "-W", "30"], capsys,
              monkeypatch, tag="s")
    assert r[1][1] == 1
    _same_text(r)


def test_makecoefs_and_coefstoh5(tmp_path, capsys, monkeypatch):
    """tests/test_kincoefs.py:376 (makecoefs on two PSP snapshots, with
    --center); coefstoh5 on tests/test_io.py:370's native sphere file.
    exp_tpu's coefstoh5 calls to_file on read_native_coefs' tuple and
    raises; the port's writes the container that exp_tpu's
    Coefs.from_file reads from the same native file."""
    import struct

    from exp_tpu.analysis.coefs import Coefs as JCoefs
    from exp_tpu.basis.model import hernquist_model
    from exp_tpu.ic.eddington import sample_spherical_model
    from exp_tpu.io.coefs import pack_sph_matrix
    from exp_tpu.io.psp import PSPComponent, PSPDump, write_psp

    stanza = {"id": "sphereSL",
              "parameters": {"modelname": "hernquist", "Lmax": 2,
                             "nmax": 4, "numr": 400, "rmin": 1e-3,
                             "rmax": 20.0, "rmapping": 1.0}}
    cfg = tmp_path / "b.yml"
    cfg.write_text(yaml.safe_dump(stanza))
    m = hernquist_model(rmin=1e-3, rmax=20.0)
    files = []
    for k in range(2):
        x, v, mass = sample_spherical_model(m, 4000, seed=k)
        f = str(tmp_path / f"OUT.mk.{k:05d}")
        write_psp(f, PSPDump(time=0.1 * k, components=[PSPComponent(
            name="halo", info="name: halo\n", mass=mass, x=x, v=v,
            pot=np.zeros(len(mass)))]))
        files.append(f)
    for tag, extra in (("", []), ("c", ["--center", "--name", "h"])):
        r = _both(tmp_path, "makecoefs", files + [
            "--config", str(cfg), "--type", "psp", "-o", "mk.h5"] + extra,
            capsys, monkeypatch, tag=tag)
        assert r[1][1] == 0 and "2 snapshot(s)" in r[1][2]
        _same_text(r)
        _same_h5(r, "mk.h5", F64)

    rng = np.random.default_rng(0)
    lmax, nmax = 2, 4
    coef = rng.normal(size=(2, lmax + 1, lmax + 1, nmax))
    for l in range(lmax + 1):
        coef[:, l, l + 1:] = 0.0
    coef[1, :, 0] = 0.0
    mat = pack_sph_matrix(coef)
    native = tmp_path / "outcoef.sph.bin"
    with open(native, "wb") as f:
        for it, t in enumerate([0.0, 0.5]):
            hdr = (f"lmax: {lmax}\nnmax: {nmax}\ntime: {t}\n"
                   f"scale: 1.0\nnormed: true\nid: sphereSL\n").encode()
            f.write(struct.pack("<II", 0xc0a57a2, len(hdr)))
            f.write(hdr)
            mm = mat * (1 + it)
            for ir in range(nmax):
                L = 0
                for l in range(lmax + 1):
                    for m_ in range(l + 1):
                        f.write(struct.pack("<d", mm[L, ir].real))
                        if m_:
                            f.write(struct.pack("<d", mm[L, ir].imag))
                        L += 1
    from exp_tpu.cli.coefstoh5 import main as j_coefstoh5
    from exp_tpu_torch.cli.coefstoh5 import main as t_coefstoh5

    with pytest.raises(AttributeError):
        j_coefstoh5([str(native), "-o", str(tmp_path / "j.h5")])
    assert t_coefstoh5([str(native), "-o", str(tmp_path / "t.h5"),
                        "--cpu"]) == 0
    assert "wrote 2 time(s) (sphere)" in capsys.readouterr().out
    ref = JCoefs.from_file(str(native))
    back = JCoefs.from_file(str(tmp_path / "t.h5"))
    assert back.geometry == ref.geometry == "sphere"
    assert back.times() == ref.times()
    for t in ref.times():
        close(back(t), ref(t), HOST)


# ---------------------------------------------------------------------------
# profiles and fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool,body,argv", [
    ("haloprof", "h.bods", ["--type", "ascii", "--nbins", "20"]),
    ("diskprof", "d.bods", ["--type", "ascii", "--nbins", "15"]),
    ("diskprof", "dt.bods", ["--type", "ascii", "--nbins", "15"]),
    ("slabprof", "s.bods", ["--nbins", "20"]),
], ids=["haloprof", "diskprof", "diskprof-port-gendisk", "slabprof"])
def test_profiles(tmp_path, work, capsys, monkeypatch, tool, body, argv):
    """tests/test_cli.py:102 and :427: the same table byte for byte (the
    disk is exp_tpu's gendisk body file, d.bods, or the port's, dt.bods,
    from the same flags)."""
    r = _both(tmp_path, tool, [body] + argv, capsys, monkeypatch,
              copies=[work / body])
    _same_text(r)
    _same_bytes(r, f"{body}.{tool}")
    tab = np.loadtxt(r[1][0] / f"{body}.{tool}")
    assert tab.shape[0] > 5 and np.isfinite(tab).all()


def test_sphprof(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:121: profiles of a coefficient file written by
    exp_tpu's Basis (20,000 particles), averaged over 12 directions, whole
    and cut to the monopole; and without --config (the file's lmax/nmax
    over the builtin model), every time."""
    from exp_tpu.analysis.basis import Basis
    from exp_tpu.basis.model import hernquist_model
    from exp_tpu.ic.eddington import sample_spherical_model

    stanza = {"id": "sphereSL",
              "parameters": {"modelname": "hernquist", "Lmax": 2,
                             "nmax": 6, "numr": 800, "rmin": 1e-3,
                             "rmax": 20.0, "rmapping": 1.0}}
    cfg = tmp_path / "basis.yml"
    cfg.write_text(yaml.safe_dump(stanza))
    x, v, mass = sample_spherical_model(
        hernquist_model(rmin=1e-3, rmax=20.0), 20000, seed=7)
    c = Basis.factory(stanza).create_from_snapshots(
        [(x, mass), (x * 1.01, mass)], times=[0.0, 1.0])
    f = str(tmp_path / "sph.h5")
    c.to_file(f)
    for tag, argv in (
            ("a", ["--config", str(cfg), "--avg", "12"]),
            ("l", ["--config", str(cfg), "--avg", "12", "--lcut", "0"]),
            ("m", ["--all-times", "--m0", "--basis-rmin", "1e-3"])):
        r = _both(tmp_path, "sphprof", [f, "--rmin", "0.05", "--rmax",
                                        "2.0", "--nbins", "16", "-o", "prof"]
                  + argv, capsys, monkeypatch, tag=tag)
        _same_text(r)
        a, b = (np.loadtxt(x[0] / "prof") for x in r)
        close(b, a, F64)
        assert np.all(b[:, 3] < 0)


def test_diskprof_coef(tmp_path, work, capsys, monkeypatch):
    """diskprof --coef: midplane profiles of a cylinder coefficient file
    (exp_tpu's f64 cylinder on the shared cache) through the stanza."""
    from exp_tpu.analysis.basis import Basis
    from exp_tpu.nbody.particles import read_ascii_arrays

    stanza = {"id": "cylinder", "parameters": dict(
        mmax=1, nmax=4, lmaxfid=8, nmaxfid=8, acyl=1.0, hcyl=0.1,
        rcylmin=1e-3, rcylmax=20.0, ncylnx=64, ncylny=32, rnum=60, tnum=20,
        cachename="eof.h5")}
    cfg = tmp_path / "disk.yml"
    cfg.write_text(yaml.safe_dump(stanza))
    x, v, m = read_ascii_arrays(str(work / "d.bods"))
    shutil.copy(work / "eof.h5", tmp_path)
    monkeypatch.chdir(tmp_path)
    c = Basis.factory(stanza).create_from_snapshots([(x, m)], times=[0.0])
    c.to_file(str(tmp_path / "cyl.h5"))
    r = _both(tmp_path, "diskprof", ["--coef", str(tmp_path / "cyl.h5"),
                                     "--config", str(cfg), "--rmin", "0.1",
                                     "--rmax", "5", "--nbins", "12",
                                     "--mcut", "0", "-o", "dp"],
              capsys, monkeypatch, copies=[work / "eof.h5"])
    _same_text(r)
    a, b = (np.loadtxt(x[0] / "dp") for x in r)
    close(b, a, F64)
    assert np.all(b[:, 3] > 0)


def test_scalarprod(tmp_path, work, capsys, monkeypatch):
    """tests/test_cli.py:167's scalarprod: the printed amplitudes."""
    stanza = {"id": "sphereSL",
              "parameters": {"modelname": "hernquist", "Lmax": 1,
                             "nmax": 4, "numr": 400, "rmin": 1e-3,
                             "rmax": 20.0, "rmapping": 1.0}}
    cfg = tmp_path / "b.yml"
    cfg.write_text(yaml.safe_dump(stanza))
    r = _both(tmp_path, "scalarprod", ["h.bods", "--type", "ascii",
                                       "--config", str(cfg), "--center"],
              capsys, monkeypatch, copies=[work / "h.bods"])
    assert r[1][1] == 0 and "geometry=sphere" in r[1][2]
    _same_text(r)


@pytest.mark.parametrize("which", ["cylinder", "sphere"])
def test_crossval(tmp_path, work, capsys, monkeypatch, which):
    """tests/test_cli.py:287 (--eof) and the sphere default: the printed
    table (the f64 bases and the host direct sum)."""
    from exp_tpu.ic.disk import sample_exponential_disk
    from exp_tpu.nbody.particles import write_ascii_bodies

    if which == "cylinder":
        x, m = sample_exponential_disk(1500, acyl=1.0, hcyl=0.1, mass=1.0,
                                       seed=4)
        write_ascii_bodies(tmp_path / "c.bods", (x, np.zeros_like(x), m))
        argv = ["c.bods", "--eof", "eof.h5", "--ntest", "128"]
        copies = [tmp_path / "c.bods", work / "eof.h5"]
    else:
        argv = ["h.bods", "--lmax", "2", "--nmax", "6", "--ntest", "128"]
        copies = [work / "h.bods"]
    r = _both(tmp_path, "crossval", argv, capsys, monkeypatch, copies=copies)
    assert "overall median force error" in r[1][2]
    _same_text(r)


def test_diskfreqs(tmp_path, work, capsys, monkeypatch):
    """tests/test_cli.py:310."""
    from exp_tpu.ic.disk import sample_exponential_disk
    from exp_tpu.nbody.particles import write_ascii_bodies

    x, m = sample_exponential_disk(4000, acyl=1.0, hcyl=0.1, mass=1.0,
                                   seed=3)
    write_ascii_bodies(tmp_path / "f.bods", (x, np.zeros_like(x), m))
    r = _both(tmp_path, "diskfreqs", ["f.bods", "--eof", "eof.h5", "--nout",
                                      "16"], capsys, monkeypatch,
              copies=[tmp_path / "f.bods", work / "eof.h5"])
    _same_text(r)
    _tables(r, "f.bods.diskfreqs", F32SUM)


def test_kldiv(tmp_path, work, capsys, monkeypatch):
    """tests/test_cli.py:381."""
    r = _both(tmp_path, "kldiv", ["h.bods", "h.bods"], capsys, monkeypatch,
              copies=[work / "h.bods"])
    assert "KL(p1 || p2) = 0 " in r[1][2]
    _same_text(r)
    r = _both(tmp_path, "kldiv", ["h.bods", "d.bods", "--cyl"], capsys,
              monkeypatch, copies=[work / "h.bods", work / "d.bods"],
              tag="c")
    _same_text(r)


def test_yamldiff(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:395: exit 0 / 1 and the printed differences."""
    (tmp_path / "a.yml").write_text("Global: {dtime: 0.01, nsteps: 5}\n")
    (tmp_path / "b.yml").write_text(
        "Global: {dtime: 0.02, nsteps: 5, fpe: true}\n")
    a, b = str(tmp_path / "a.yml"), str(tmp_path / "b.yml")
    r = _both(tmp_path, "yamldiff", [a, a], capsys, monkeypatch)
    assert r[1][1] == 0
    _same_text(r)
    r = _both(tmp_path, "yamldiff", [a, b], capsys, monkeypatch, tag="d")
    assert r[1][1] == 1 and "~ Global.dtime: 0.01 -> 0.02" in r[1][2]
    _same_text(r)


def test_diskeof(tmp_path, work, capsys, monkeypatch):
    """tests/test_diskeof.py:70's flow on the shared cache: two PSP
    snapshots of an exponential disk with an m = 1 overdensity."""
    from exp_tpu.ic.disk import sample_exponential_disk
    from exp_tpu.io.psp import PSPComponent, PSPDump, write_psp

    copies = [work / "eof.h5"]
    for t in range(2):
        x, mass = sample_exponential_disk(6000, acyl=1.0, hcyl=0.1,
                                          mass=1.0, seed=t)
        x[:, 0] *= 1.0 + 0.2 * t
        f = tmp_path / f"OUT.de.{t:05d}"
        write_psp(str(f), PSPDump(time=0.05 * t, components=[PSPComponent(
            name="disk", info="name: disk\n", mass=mass, x=x, v=0 * x,
            pot=np.zeros(len(mass)))]))
        copies.append(f)
    r = _both(tmp_path, "diskeof", ["-T", "de", "-c", "disk", "--cachefile",
                                    "eof.h5", "--grid", "16", "--rmax", "4",
                                    "--mbeg", "1", "--mend", "1"],
              capsys, monkeypatch, copies=copies)
    assert r[1][1] == 0 and "Singular values for m=0" in r[1][2]
    assert [ln.split(":")[0] for ln in r[1][2].splitlines()] == \
        [ln.split(":")[0] for ln in r[0][2].splitlines()]
    for f in ("de_diskeof.coefs", "de_diskeof.coefs_orig"):
        _tables(r, f, F64)
    a, b = (np.load(x[0] / "de_diskeof_rotated.00001.npz") for x in r)
    assert sorted(a.files) == sorted(b.files)
    for k in ("dens", "pot", "svals", "times"):
        close(b[k], a[k], F64)


# ---------------------------------------------------------------------------
# the umbrella and the card
# ---------------------------------------------------------------------------

PORTED_TOOLS = ["diskprof", "haloprof", "sphprof", "slabprof", "mssaprof",
               "viewcoefs", "h5compare", "h5power", "slcheck", "orthochk",
               "cylcache", "eofinfo", "crossval", "diskfreqs", "kldiv",
               "yamldiff", "mssafilter", "slshift", "scalarprod", "diskeof",
               "makecoefs", "coefstoh5", "expmssa"]


def test_umbrella_lists_and_dispatches(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:258: the umbrella lists the 58 tools, every one's
    --help exits 0 with exp_tpu's flags, and `python -m exp_tpu_torch.cli
    <tool>` runs a tool in a process of its own."""
    import argparse

    from exp_tpu.cli import TOOLS as J_TOOLS
    from exp_tpu_torch.cli import TOOLS
    from exp_tpu_torch.cli import __main__ as umbrella

    assert len(TOOLS) == 58 and len(set(TOOLS)) == 58
    assert set(PORTED_TOOLS) <= set(TOOLS) <= set(J_TOOLS)
    monkeypatch.setattr(sys, "argv", ["exp_tpu_torch.cli"])
    assert umbrella.main() == 0
    out = capsys.readouterr().out
    assert all(t in out for t in TOOLS)

    def flags(pkg, tool):
        seen = []
        real = argparse.ArgumentParser.add_argument

        def spy(self, *a, **k):
            seen.append(a)
            return real(self, *a, **k)

        monkeypatch.setattr(argparse.ArgumentParser, "add_argument", spy)
        with pytest.raises(SystemExit) as e:
            importlib.import_module(f"{pkg}.cli.{tool}").main(["--help"])
        monkeypatch.setattr(argparse.ArgumentParser, "add_argument", real)
        capsys.readouterr()
        assert e.value.code in (0, None), tool
        return seen

    for t in PORTED_TOOLS:
        assert flags("exp_tpu_torch", t) == flags("exp_tpu", t), t
    (tmp_path / "a.yml").write_text("a: 1\n")
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-m", "exp_tpu_torch.cli",
                        "yamldiff", "a.yml", "a.yml", "--cpu"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0 and "configs identical" in p.stdout, p.stderr


@pytest.mark.parametrize("tool,argv", [
    ("orthochk", ["--geometry", "cube"]),
    ("sphprof", ["missing.h5"]),
    ("yamldiff", ["a.yml", "b.yml"]),
], ids=["orthochk", "sphprof", "yamldiff"])
def test_refuses_without_a_card(tmp_path, capsys, monkeypatch, tool, argv):
    """Without a card and without --cpu a tool refuses with a usage error
    (exit code 2) before it reads or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    main = importlib.import_module(f"exp_tpu_torch.cli.{tool}").main
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--cpu" in err, err
    assert os.listdir(tmp_path) == []
