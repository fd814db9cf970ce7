"""The port's PhaseSpace tools (exp_tpu_torch/cli: psptools' pspinfo,
pspstat, psp2ascii, ascii2psp, snap2ascii, diffpsp, pspinterp, psp2hdf5,
shrinkics, psphisto, pspbox, snapconvert, snap2vtk, and the one-file tools
psporbv, pspmono, psp2bess, psp2lagu, psp2rings, psp2range, pspreal,
spl2psp, tipstd2psp, psp2vtu) against exp_tpu's, on the flows of
tests/test_cli.py (:15, :49, :196, :268, :334, :441, :477, :567, :827) and
tests/test_kincoefs.py (:178, :222, :248, :296, :355, :429).  Each flow
runs exp_tpu's tools, then the port's with --cpu on the same argv, each
side in its own directory on copies of the same inputs, and holds:
  * the return codes and the printed lines equal;
  * every file either side wrote equal byte for byte (the tools are host
    NumPy on equal inputs), except HDF5 files, whose datasets and
    attributes are held equal value for value (the container's bytes are
    the library's);
  * the checks of exp_tpu's own flow, on the port's files.
No tolerance is needed: every output equals exp_tpu's exactly."""

import importlib
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits


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


def _flow(tmp_path, capsys, monkeypatch, steps, copies=()):
    """Run `steps` [(tool, argv), ...] with exp_tpu's tools, then with the
    port's (--cpu), each side from its own directory holding copies of
    `copies`.  Asserts equal return codes and printed lines, and every
    file of either directory equal (HDF5 files value for value).  Returns
    the two directories, exp_tpu's first."""
    dirs, texts = [], []
    for who, pkg, extra in (("j", "exp_tpu", []),
                            ("t", "exp_tpu_torch", ["--cpu"])):
        d = tmp_path / who
        d.mkdir()
        for c in copies:
            shutil.copy(c, d)
        monkeypatch.chdir(d)
        capsys.readouterr()
        rcs = []
        for tool, argv in steps:
            main = importlib.import_module(f"{pkg}.cli.{tool}").main
            rcs.append(main(list(argv) + extra) or 0)
        texts.append((rcs, capsys.readouterr().out))
        dirs.append(d)
    monkeypatch.chdir(tmp_path)
    assert texts[1] == texts[0]
    names = [sorted(os.listdir(d)) for d in dirs]
    assert names[1] == names[0]
    for f in names[0]:
        if f.endswith((".h5", ".hdf5")):
            _same_h5(*(d / f for d in dirs))
        else:
            assert (dirs[1] / f).read_bytes() == (dirs[0] / f).read_bytes(), f
    return dirs


def _same_h5(pa, pb):
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

    a, b = walk(pa), walk(pb)
    assert sorted(a) == sorted(b)
    for k in a:
        (aa, da), (ab, db) = a[k], b[k]
        assert sorted(aa) == sorted(ab), k
        for at in aa:
            assert np.array_equal(aa[at], ab[at]), (k, at)
        if da is not None:
            assert da.dtype == db.dtype and np.array_equal(da, db), k


def _dump(n=100, seed=0, with_attrs=False):
    """tests/test_kincoefs.py:144's dump."""
    from exp_tpu_torch.io.psp import PSPComponent, PSPDump

    rng = np.random.default_rng(seed)
    c = PSPComponent(
        name="disk", info="name: disk\n",
        mass=rng.uniform(0.5, 1.0, n), x=rng.normal(size=(n, 3)),
        v=rng.normal(size=(n, 3)), pot=rng.normal(size=n),
        iattr=rng.integers(0, 9, (n, 2)).astype(np.int32)
        if with_attrs else None,
        dattr=rng.normal(size=(n, 1)) if with_attrs else None)
    return PSPDump(time=0.75, components=[c])


@pytest.fixture(scope="module")
def halo(tmp_path_factory):
    """tests/test_cli.py's 2,000-body Hernquist halo (seed 3) as an ascii
    body file, and as a PSP file with its potential."""
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.ic.eddington import sample_spherical_model
    from exp_tpu_torch.io.psp import PSPComponent, PSPDump, write_psp
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    d = tmp_path_factory.mktemp("psphalo")
    m = hernquist_model(rmin=1e-4, rmax=20.0)
    x, v, mass = sample_spherical_model(m, 2000, seed=3)
    write_ascii_bodies(d / "h.bods", (x, v, mass))
    r = np.linalg.norm(x, axis=1)
    write_psp(str(d / "hp.psp"), PSPDump(time=0.25, components=[
        PSPComponent(name="halo", info="name: halo\n", mass=mass, x=x, v=v,
                     pot=np.asarray(m.get_pot(r)))]))
    return d


def test_gensph_and_stats_flow(tmp_path, capsys, monkeypatch, halo):
    """tests/test_cli.py:15 (ascii2psp, pspinfo, pspstat, pspstat --all
    on a two-dump OUT file, psp2ascii) and :49 (diffpsp)."""
    from exp_tpu_torch.io.psp import read_psp, write_psp

    src = halo / "h.bods"
    d = read_psp(str(halo / "hp.psp"))
    multi = tmp_path / "h.out"
    write_psp(str(multi), d)
    d.time = 0.5
    write_psp(str(multi), d, append=True)
    dirs = _flow(tmp_path, capsys, monkeypatch, [
        ("ascii2psp", ["h.bods", "-o", "h.psp", "--name", "halo"]),
        ("pspinfo", ["h.psp"]),
        ("pspstat", ["h.psp"]),
        ("pspstat", ["h.out", "--all"]),
        ("psp2ascii", ["h.psp", "-o", "back"]),
        ("diffpsp", ["h.psp", "h.psp"]),
        ("diffpsp", ["h.psp", "hp.psp"]),
        ("snap2ascii", ["hp.psp", "--comp", "halo"]),
        ("ascii2psp", ["h.bods", "-o", "h4.psp", "--real4", "--time",
                       "1.5"]),
    ], copies=[src, multi, halo / "hp.psp"])
    t = dirs[1]
    assert (t / "back.halo.ascii").exists() and (t / "hp.psp.ascii").exists()
    from exp_tpu_torch.nbody.particles import read_ascii_arrays

    xb, _, mb = read_ascii_arrays(str(t / "back.halo.ascii"))
    x0, _, m0 = read_ascii_arrays(str(src))
    np.testing.assert_array_equal(xb, x0)
    np.testing.assert_array_equal(mb, m0)


def test_pspinterp_flow(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:196: the midpoint of two dumps."""
    from exp_tpu_torch.io.psp import PSPComponent, PSPDump, read_psp, \
        write_psp

    rng = np.random.default_rng(8)
    x = rng.normal(size=(100, 3))
    v = rng.normal(size=(100, 3))
    m = np.full(100, 0.01)
    for name, t, shift in (("a.psp", 0.0, 0.0), ("b.psp", 1.0, 1.0)):
        write_psp(str(tmp_path / name), PSPDump(time=t, components=[
            PSPComponent(name="c", info="name: c\n", mass=m, x=x + shift,
                         v=v, pot=np.zeros(100))]))
    dirs = _flow(tmp_path, capsys, monkeypatch, [
        ("pspinterp", ["a.psp", "b.psp", "-t", "0.5", "-o", "mid.psp"]),
        ("pspinterp", ["a.psp", "b.psp", "-t", "1.5"]),
    ], copies=[tmp_path / "a.psp", tmp_path / "b.psp"])
    d = read_psp(str(dirs[1] / "mid.psp"))
    d = d[-1] if isinstance(d, list) else d
    assert abs(d.time - 0.5) < 1e-12
    np.testing.assert_allclose(d.components[0].x, x + 0.5, atol=1e-6)


def test_psp2hdf5_shrinkics_flow(tmp_path, capsys, monkeypatch, halo):
    """tests/test_cli.py:268: psp2hdf5 (f64 and --real4) and shrinkics."""
    import h5py

    dirs = _flow(tmp_path, capsys, monkeypatch, [
        ("psp2hdf5", ["hp.psp"]),
        ("psp2hdf5", ["hp.psp", "-o", "r4.h5", "--real4"]),
        ("shrinkics", ["h.bods", "-f", "5", "--seed", "1"]),
    ], copies=[halo / "hp.psp", halo / "h.bods"])
    t = dirs[1]
    with h5py.File(t / "hp.psp.h5") as f:
        assert f.attrs["count"] == 1
        assert f["snapshots/00000000/halo/pos"].shape == (2000, 3)
    a = np.loadtxt(t / "h.bods", skiprows=1)
    b = np.loadtxt(t / "h.bods.shrink", skiprows=1)
    assert len(b) == 400
    np.testing.assert_allclose(a[:, 0].sum(), b[:, 0].sum(), rtol=1e-12)


@pytest.mark.parametrize("argv", [
    ["--field", "r", "--log", "--nbins", "12"],
    ["--field", "E", "--nbins", "16"],
    ["--field", "vt", "--nbins", "10", "--comp", "halo"],
    ["--field", "R", "--field2", "z", "--nbins", "10", "--nbins2", "6",
     "-o", "rz.histo"],
    ["--field", "pot", "--field2", "vr", "--nbins", "8"],
], ids=["r-log", "E", "vt", "R-z", "pot-vr"])
def test_psphisto_flow(tmp_path, capsys, monkeypatch, halo, argv):
    """tests/test_cli.py:334 and tests/test_kincoefs.py:296 (--field2)."""
    dirs = _flow(tmp_path, capsys, monkeypatch,
                 [("psphisto", ["hp.psp"] + argv)], copies=[halo / "hp.psp"])
    out = [f for f in os.listdir(dirs[1]) if "histo" in f]
    assert len(out) == 1
    tab = np.loadtxt(dirs[1] / out[0])
    mtot = np.loadtxt(halo / "h.bods", skiprows=1)[:, 0].sum()
    np.testing.assert_allclose(tab[:, 1:].sum(), mtot, rtol=1e-6)


def test_pspbox_flow(tmp_path, capsys, monkeypatch, halo):
    """tests/test_cli.py:334: a sphere and a cube cut out of the dump."""
    dirs = _flow(tmp_path, capsys, monkeypatch, [
        ("pspbox", ["hp.psp", "--radius", "1.0"]),
        ("pspinfo", ["hp.psp.box"]),
        ("pspbox", ["hp.psp", "--halfside", "0.5", "--center", "0.1,0,0",
                    "-o", "cube.psp"]),
    ], copies=[halo / "hp.psp"])
    from exp_tpu_torch.io.psp import read_psp

    n = len(read_psp(str(dirs[1] / "hp.psp.box")).components[0].mass)
    assert 0 < n < 2000


def test_snapconvert_and_vtk_flow(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:441 (ascii -> psp -> gadgethdf5 -> ascii, the
    point cloud) and tests/test_kincoefs.py:355 (snap2vtk --grid)."""
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    rng = np.random.default_rng(0)
    n = 200
    x = rng.normal(size=(n, 3))
    v = rng.normal(size=(n, 3))
    m = rng.uniform(0.5, 1.5, n)
    src = tmp_path / "b.ascii"
    write_ascii_bodies(src, (x, v, m))
    dirs = _flow(tmp_path, capsys, monkeypatch, [
        ("snapconvert", ["b.ascii", "--from", "ascii", "--to", "psp",
                         "-o", "b.psp"]),
        ("snapconvert", ["b.psp", "--from", "psp", "--to", "gadgethdf5",
                         "-o", "b.hdf5"]),
        ("snapconvert", ["b.hdf5", "--from", "gadgethdf5", "--to", "ascii",
                         "-o", "back.ascii"]),
        ("snapconvert", ["b.psp", "--to", "tipsy", "-o", "b.tipsy"]),
        ("snapconvert", ["b.psp", "--to", "gadget", "-o", "b.gadget"]),
        ("snap2vtk", ["b.psp", "--type", "psp", "-o", "b.vtk"]),
        ("snap2vtk", ["b.ascii", "--type", "ascii", "--stride", "3"]),
        ("snap2vtk", ["b.psp", "--grid", "8", "--rmax", "3.0", "-o",
                      "g.vtk"]),
    ], copies=[src])
    t = dirs[1]
    txt = (t / "b.vtk").read_text()
    assert txt.startswith("# vtk DataFile") and f"POINTS {n} float" in txt
    assert "STRUCTURED_POINTS" in (t / "g.vtk").read_text()
    vals = np.loadtxt(t / "g.vtk", skiprows=10)
    inside = (np.abs(x) < 3.0).all(axis=1)
    np.testing.assert_allclose(vals.sum() * 0.75 ** 3, m[inside].sum(),
                               rtol=1e-5)
    from exp_tpu_torch.nbody.particles import read_ascii_arrays

    _, _, mb = read_ascii_arrays(str(t / "back.ascii"))
    np.testing.assert_allclose(np.sort(mb), np.sort(m), rtol=1e-5)


def test_tipstd2psp_and_psp2vtu_flow(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:477: tipsy -> PSP and the XML point files."""
    import re

    from exp_tpu_torch.io.psp import read_psp
    from exp_tpu_torch.io.readers import Snapshot, write_tipsy

    rng = np.random.default_rng(7)
    n = 60
    s = Snapshot(0.5)
    s.add("dark", rng.normal(size=(n, 3)), rng.normal(size=(n, 3)),
          rng.uniform(0.5, 1.5, n), pot=rng.normal(size=n))
    write_tipsy(str(tmp_path / "in.tipsy"), s)
    dirs = _flow(tmp_path, capsys, monkeypatch, [
        ("tipstd2psp", ["in.tipsy", "in.psp"]),
        ("psp2vtu", ["-c", "dark", "-T", "t0", "--dens", "8", "in.psp"]),
    ], copies=[tmp_path / "in.tipsy"])
    t = dirs[1]
    dump = read_psp(str(t / "in.psp"))
    assert dump.time == 0.5 and dump.components[0].name == "dark"
    vtu = (t / "t0_00000.vtu").read_text()
    assert f'NumberOfPoints="{n}"' in vtu
    dens = re.search(r'Name="density"[^>]*>([^<]*)<', vtu).group(1)
    vals = np.array(dens.split(), float)
    assert len(vals) == n and (vals > 0).all()


def test_psporbv_flow(tmp_path, capsys, monkeypatch, halo):
    """tests/test_cli.py:567: the orbit table and its histogram."""
    dirs = _flow(tmp_path, capsys, monkeypatch, [
        ("psporbv", ["-f", "h.bods", "--type", "ascii", "-m", "hernquist",
                     "-R", "2.0", "-k", "0.9", "-s", "t", "--nE", "24",
                     "--nK", "12", "-N", "8"]),
    ], copies=[halo / "h.bods"])
    tab = np.loadtxt(dirs[1] / "orbv.t")
    assert tab.shape[1] == 19 and (tab[:, 1] < 0).all()
    assert (dirs[1] / "orbv.t.histo").exists()


def test_pspmono_flow(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:827: a model table from a 60,000-body sample."""
    from exp_tpu_torch.basis.model import SphericalModelTable, hernquist_model
    from exp_tpu_torch.ic.eddington import sample_spherical_model
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    m0 = hernquist_model(rmin=1e-3, rmax=20.0)
    x, v, mass = sample_spherical_model(m0, 60000, seed=4)
    write_ascii_bodies(str(tmp_path / "halo.bods"), (x, v, mass))
    dirs = _flow(tmp_path, capsys, monkeypatch, [
        ("pspmono", ["halo.bods", "--type", "ascii", "--rnum", "400", "-o",
                     "mono.model"]),
    ], copies=[tmp_path / "halo.bods"])
    m1 = SphericalModelTable.from_file(str(dirs[1] / "mono.model"))
    assert np.isclose(m1.total_mass, mass.sum(), rtol=0.02)
    for rq in (0.3, 1.0, 5.0):
        assert np.isclose(float(m1.get_mass(rq)), float(m0.get_mass(rq)),
                          rtol=0.1), rq


def test_kincoef_tools_flow(tmp_path, capsys, monkeypatch):
    """tests/test_kincoefs.py:222: psp2bess, psp2lagu, psp2rings on a
    two-snapshot sequence with an m=2 tangential pattern."""
    from exp_tpu_torch.analysis import kincoefs as K
    from exp_tpu_torch.io.psp import PSPComponent, PSPDump, write_psp

    rmax = 0.04
    seq = []
    for k in range(2):
        rng = np.random.default_rng(k)
        n = 20000
        R = rng.uniform(0.2 * rmax, 0.9 * rmax, n)
        phi = rng.uniform(-np.pi, np.pi, n)
        x = np.stack([R * np.cos(phi), R * np.sin(phi), np.zeros(n)], 1)
        vt = 1.0 + 0.5 * np.cos(2 * phi) + 0.25 * np.sin(2 * phi)
        v = np.stack([-vt * np.sin(phi), vt * np.cos(phi), np.zeros(n)], 1)
        f = tmp_path / f"OUT.runK.{k:05d}"
        write_psp(str(f), PSPDump(time=0.1 * k, components=[PSPComponent(
            name="comp", info="name: comp\n", mass=np.full(n, 1.0 / n),
            x=x, v=v, pot=np.zeros(n))]))
        seq.append(f)
    dirs = _flow(tmp_path, capsys, monkeypatch, [
        ("psp2bess", ["-T", "runK", "-R", str(rmax), "-n", "6", "-s",
                      "bess_coefs"]),
        ("psp2lagu", ["-T", "runK", "-a", "0.02", "-n", "5", "-M", "3"]),
        ("psp2rings", ["-T", "runK", "-R", str(rmax), "-b", "8"]),
    ], copies=seq)
    t = dirs[1]
    blocks = K.read_bess_coefs(t / "runK.bess_coefs")
    assert len(blocks) == 2 and blocks[0]["cos"].shape == (5, 4, 6)
    assert K.read_lagu_coefs(t / "runK.lagu_coefs")[0]["cos"].shape == \
        (4, 4, 5)
    rb = K.read_ring_coefs(t / "runK.ring_coefs")
    assert np.allclose(rb["blocks"][0]["cos"][1, 1, 3:6], 0.25, atol=0.05)


def test_spl2psp_psp2range_pspreal_flow(tmp_path, capsys, monkeypatch):
    """tests/test_kincoefs.py:178 (spl2psp on two SPL sets) and :248
    (psp2range, pspreal, its --real8)."""
    from exp_tpu_torch.io.psp import read_psp, write_psp, write_spl

    files = []
    for seq in (0, 1):
        f = tmp_path / f"SPL.runA.{seq:05d}"
        write_spl(str(f), _dump(seed=seq), nparts=2)
        files += sorted(tmp_path.glob(f"SPL.runA.{seq:05d}*"))
    write_psp(str(tmp_path / "OUT.t.00000"), _dump(with_attrs=True))
    files.append(tmp_path / "OUT.t.00000")
    dirs = _flow(tmp_path, capsys, monkeypatch, [
        ("spl2psp", ["-d", ".", "-r", "runA", "-1", "0", "-2", "1"]),
        ("psp2range", ["OUT.t.00000"]),
        ("pspreal", ["OUT.t.00000", "-o", "f4.psp"]),
        ("pspreal", ["f4.psp", "--real8", "-o", "f8.psp"]),
    ], copies=files)
    t = dirs[1]
    for seq in (0, 1):
        back = read_psp(str(t / f"OUT.runA.{seq:05d}"))
        np.testing.assert_allclose(back.components[0].mass,
                                   _dump(seed=seq).components[0].mass)
    back = read_psp(str(t / "f4.psp"))
    assert back.components[0].mass.dtype == np.float64


def test_spl2psp_on_outspl_files(tmp_path, capsys, monkeypatch):
    """tests/test_kincoefs.py:429: the port's driver writes OutSPL sets
    (nparts 3) and both packages' spl2psp assemble them alike."""
    import yaml

    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.config import RunConfig
    from exp_tpu_torch.ic.eddington import sample_spherical_model
    from exp_tpu_torch.io.psp import read_psp, read_spl
    from exp_tpu_torch.nbody.particles import write_ascii_bodies
    from exp_tpu_torch.nbody.simulation import Simulation

    run = tmp_path / "run"
    run.mkdir()
    x, v, mass = sample_spherical_model(
        hernquist_model(rmin=1e-3, rmax=20.0), 1500, seed=2)
    write_ascii_bodies(str(run / "h.bods"), (x, v, mass))
    conf = {
        "Global": {"dtime": 0.02, "nsteps": 4, "runtag": "spltest",
                   "outdir": str(run)},
        "Components": [{"name": "halo", "bodyfile": "h.bods",
                        "force": {"id": "sphereSL",
                                  "parameters": {"lmax": 1, "nmax": 4,
                                                 "modelname":
                                                 "hernquist"}}}],
        "Output": [{"id": "outspl",
                    "parameters": {"nint": 2, "nparts": 3}}],
    }
    (run / "run.yml").write_text(yaml.safe_dump(conf))
    sim = Simulation(RunConfig.from_file(str(run / "run.yml")),
                     workdir=str(run), device="cpu")
    sim.run()
    master = run / "SPL.spltest.00004"
    d = read_spl(str(master))
    assert len(d.components[0].mass) == 1500
    dirs = _flow(tmp_path, capsys, monkeypatch, [
        ("spl2psp", ["-d", ".", "-r", "spltest", "-s", "4"]),
        ("spl2psp", ["-d", ".", "-r", "spltest", "-s", "2", "-p", "SNAP"]),
    ], copies=sorted(run.glob("SPL.spltest.*")))
    back = read_psp(str(dirs[1] / "OUT.spltest.00004"))
    np.testing.assert_allclose(back.components[0].x.sum(),
                               d.components[0].x.sum(), rtol=1e-6)
