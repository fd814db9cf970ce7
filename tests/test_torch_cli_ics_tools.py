"""The port's IC tools (exp_tpu_torch/cli: ics_tools' modelfit, addring,
addsphmod, forcetest, hdf52accel, and cubeics, genslab, gendisk,
bonnerebert) against exp_tpu's, on the flows of tests/test_cli.py (:102,
:359, :517, :612), tests/test_kincoefs.py:267 and tests/test_slab.py:120.
Each flow runs exp_tpu's tool, then the port's with --cpu on the same
argv, each side in its own directory on copies of the same inputs, and
holds:
  * the return codes and the printed lines equal, and every file either
    side wrote equal byte for byte, where the tool is host NumPy (modelfit,
    addring, addsphmod, hdf52accel, cubeics, genslab, bonnerebert,
    gendisk's light path);
  * forcetest (an f64 'gather' SphereSL on both sides, then the same NumPy
    direct sum): its printed percentiles to F64 (1e-10) of max(1, |value|);
  * gendisk --nhalo (the DiskHalo path through f32 'matmul' / 'xla'
    expansions, as exp_tpu's defaults): the halo file, the disk's positions
    and masses equal, the disk velocities within FIELD_TOL (1e-5) of their
    largest value (tests/test_torch_diskhalo.py's bound for Jeans tables of
    f32 fields summed in another order), the printed -2T/VC within 0.08
    of 1 on both sides;
  * genslab's sheet near equilibrium under each package's driver (slabSL,
    40 steps): the RMS thickness within 40% of its start on both sides,
    and the two within SLAB_RMS (1e-4) of each other (f32 steps of the
    same file).
Then exp_tpu's own checks of each flow on the port's files."""

import importlib
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

F64 = 1e-10
FIELD_TOL = 1e-5
SLAB_RMS = 1e-4


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


def _run(tmp_path, capsys, monkeypatch, steps, copies=()):
    """Run `steps` [(tool, argv), ...] with exp_tpu's tools, then with the
    port's (--cpu), each side from its own directory holding copies of
    `copies`.  Asserts equal return codes and the same file names.
    Returns [(directory, printed text), ...], exp_tpu's first."""
    runs = []
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
        runs.append((d, rcs, capsys.readouterr().out))
    monkeypatch.chdir(tmp_path)
    assert runs[1][1] == runs[0][1]
    assert sorted(os.listdir(runs[1][0])) == sorted(os.listdir(runs[0][0]))
    return [(d, out) for d, _, out in runs]


def _same(runs):
    """The printed lines equal and every file equal byte for byte."""
    (dj, oj), (dt, ot) = runs
    assert ot == oj
    for f in os.listdir(dj):
        assert (dt / f).read_bytes() == (dj / f).read_bytes(), f


def _numbers_close(a, b, tol):
    """The same words, each number within tol of max(1, |value|)."""
    num = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")
    assert num.sub("#", a) == num.sub("#", b), (a, b)
    for x, y in zip(num.findall(a), num.findall(b)):
        x, y = float(x), float(y)
        assert abs(x - y) <= tol * max(1.0, abs(y)), (x, y)


def _arrays(path):
    from exp_tpu_torch.nbody.particles import read_ascii_arrays

    return read_ascii_arrays(str(path))


@pytest.fixture(scope="module")
def halo8k(tmp_path_factory):
    """tests/test_cli.py:517's 8,000-body Hernquist realization (gensph
    -s 7)."""
    from exp_tpu_torch.cli.gensph import main as gensph

    d = tmp_path_factory.mktemp("halo8k")
    gensph(["-N", "8000", "-i", "hernquist", "-o", str(d / "h.bods"), "-s",
            "7", "--cpu"])
    return d / "h.bods"


def test_addsphmod_equal(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:359: a composite of a table and a builtin."""
    from exp_tpu_torch.basis.model import SphericalModelTable, hernquist_model

    m1 = hernquist_model(rmin=1e-3, rmax=20.0)
    m1.to_file(str(tmp_path / "one.model"))
    runs = _run(tmp_path, capsys, monkeypatch, [
        ("addsphmod", ["one.model", "plummer", "--bmass", "0.5", "-o",
                       "combo.model"]),
        ("addsphmod", ["hernquist", "plummer:a=0.2,M=0.3"]),
    ], copies=[tmp_path / "one.model"])
    _same(runs)
    combo = SphericalModelTable.from_file(str(runs[1][0] / "combo.model"))
    assert combo.mass[-1] > m1.mass[-1] + 0.3
    assert np.all(combo.pot <= m1.pot + 1e-12)
    assert combo.rho[0] > m1.rho[0]


@pytest.mark.parametrize("family", ["hernquist", "plummer", "nfw"])
def test_modelfit_equal(tmp_path, capsys, monkeypatch, halo8k, family):
    """tests/test_cli.py:517's modelfit, each family's table."""
    runs = _run(tmp_path, capsys, monkeypatch, [
        ("modelfit", ["h.bods", "--family", family, "-o", "fit.model"]),
    ], copies=[halo8k])
    _same(runs)
    if family == "hernquist":
        a_fit = float(runs[1][1].split("a=")[1].split()[0])
        assert 0.7 < a_fit < 1.3


def test_addring_equal(tmp_path, capsys, monkeypatch, halo8k):
    """tests/test_cli.py:517's addring: the ringed file byte for byte
    (exp_tpu reads the body file as float32 rows and writes them back)."""
    runs = _run(tmp_path, capsys, monkeypatch, [
        ("addring", ["h.bods", "-o", "ring.bods", "--nring", "500",
                     "--radius", "1.0", "--mring", "0.01"]),
    ], copies=[halo8k])
    _same(runs)
    assert "500 ring particles" in runs[1][1]
    x, v, m = _arrays(runs[1][0] / "ring.bods")
    assert len(m) == 8500
    R = np.hypot(x[-500:, 0], x[-500:, 1])
    assert abs(np.median(R) - 1.0) < 0.1
    r_old = np.linalg.norm(x[:8000], axis=1)
    vc = np.sqrt(m[:8000][r_old < 1.0].sum() + 0.005)
    assert abs(np.median(np.linalg.norm(v[-500:], axis=1)) - vc) / vc < 0.1


@pytest.mark.parametrize("argv", [
    ["--nsample", "200", "--lmax", "2", "--nmax", "8", "--numr", "500"],
    ["--nsample", "300", "--lmax", "4", "--nmax", "6", "--numr", "400",
     "--model", "plummer", "--rmap", "0.5", "--eps", "0.01"],
], ids=["test_cli", "plummer"])
def test_forcetest_matches_exp_tpu(tmp_path, capsys, monkeypatch, halo8k,
                                   argv):
    """tests/test_cli.py:517's forcetest: the printed percentiles and mean
    to F64, from an f64 expansion on each side and the same direct sum."""
    runs = _run(tmp_path, capsys, monkeypatch,
                [("forcetest", ["h.bods"] + argv)], copies=[halo8k])
    _numbers_close(runs[1][1], runs[0][1], F64)
    p50 = float(runs[1][1].split("p50 relative force error: ")[1].split()[0])
    assert p50 < 0.1, runs[1][1]


def test_hdf52accel_equal(tmp_path, capsys, monkeypatch):
    """tests/test_kincoefs.py:267: force.data from a Gadget HDF5 file (a
    mass table, then per-particle masses)."""
    import h5py

    n = 50
    rng = np.random.default_rng(3)
    for name, masses in (("snap.hdf5", False), ("snapm.hdf5", True)):
        with h5py.File(tmp_path / name, "w") as f:
            h = f.create_group("Header")
            h.attrs["MassTable"] = np.array([0, 0, 0.25, 0, 0, 0.0])
            g = f.create_group("PartType2")
            g.create_dataset("Coordinates", data=rng.normal(size=(n, 3)))
            g.create_dataset("Acceleration", data=rng.normal(size=(n, 3)))
            if masses:
                g.create_dataset("Masses", data=rng.uniform(size=n))
    runs = _run(tmp_path, capsys, monkeypatch, [
        ("hdf52accel", ["--hdf5", "snap.hdf5", "--output", "force.data"]),
        ("hdf52accel", ["--hdf5", "snapm.hdf5", "--output", "m.data"]),
    ], copies=[tmp_path / "snap.hdf5", tmp_path / "snapm.hdf5"])
    _same(runs)
    buf = (runs[1][0] / "force.data").read_bytes()
    assert int(np.frombuffer(buf, np.int32, 1, 0)[0]) == n
    rec = np.frombuffer(buf, dtype=[("mass", "f4"), ("pos", "f4", (3,)),
                                    ("acc", "f4", (3,))], count=n, offset=4)
    assert np.allclose(rec["mass"], 0.25)


@pytest.mark.parametrize("tool,argv", [
    ("cubeics", ["-N", "3000", "-s", "2"]),
    ("cubeics", ["-N", "2000", "--pert-amp", "0.3", "--pert-k", "1", "0",
                 "2", "--sigma", "0.5", "-o", "p.bods"]),
    ("genslab", ["-N", "4000", "-o", "s.bods", "--z0", "0.02", "-s", "2"]),
    ("gendisk", ["-N", "3000", "-o", "d.bods", "--acyl", "1.0", "--hcyl",
                 "0.1", "--mass", "1.0"]),
    ("gendisk", ["-N", "2000", "-o", "dh.bods", "--halo", "hernquist",
                 "-Q", "1.5", "-s", "3"]),
    ("bonnerebert", ["-N", "0", "--xmax", "40", "-o", "be.prof"]),
    ("bonnerebert", ["-N", "500", "--xmax", "40", "-o", "be.bods"]),
], ids=["cubeics", "cubeics-pert", "genslab", "gendisk", "gendisk-halo",
        "bonnerebert-prof", "bonnerebert-bods"])
def test_ic_tools_equal(tmp_path, capsys, monkeypatch, tool, argv):
    """tests/test_cli.py:102 (gendisk's light path in the profiles flow),
    :612 (bonnerebert), tests/test_slab.py:120 (genslab) and cubeics: the
    same files byte for byte."""
    runs = _run(tmp_path, capsys, monkeypatch, [(tool, argv)])
    _same(runs)
    d = runs[1][0]
    if tool == "bonnerebert" and argv[1] == "0":
        tab = np.loadtxt(d / "be.prof")
        assert (np.diff(tab[:, 1]) <= 1e-12).all()
        assert abs(tab[0, 1] / tab[-1, 1] - 14.0) < 0.5
    elif tool == "bonnerebert":
        assert np.loadtxt(d / "be.bods", skiprows=1).shape == (500, 11)


def test_genslab_equilibrium_on_both_drivers(tmp_path):
    """tests/test_slab.py:120: genslab's Spitzer sheet stays near
    equilibrium under slabSL, on each package's driver."""
    from exp_tpu.cli.genslab import main as j_genslab
    from exp_tpu.nbody.simulation import Simulation as JSimulation
    from exp_tpu_torch.cli.genslab import main as t_genslab
    from exp_tpu_torch.nbody.simulation import Simulation

    cfg = """\
Global:
  dtime: 0.005
  nsteps: 40
  runtag: slab0
Components:
  - name: slab
    bodyfile: s.bods
    force:
      id: slabSL
      parameters: {nmaxx: 2, nmaxy: 2, nmaxz: 6, zmax: 0.12, hslab: 0.02}
Output:
  - id: outlog
    parameters: {nint: 20}
External:
  - id: periodicBC
    parameters: {L: 1.0, btype: ppv}
"""
    rms = []
    for who, gen, sim_cls, kw in (("j", j_genslab, JSimulation, {}),
                                  ("t", t_genslab, Simulation,
                                   {"device": "cpu"})):
        d = tmp_path / who
        d.mkdir()
        gen(["-N", "4000", "-o", str(d / "s.bods"), "--z0", "0.02", "-s",
             "2"] + (["--cpu"] if who == "t" else []))
        (d / "c.yml").write_text(cfg)
        sim = sim_cls.from_file(str(d / "c.yml"), **kw)
        sim.prime()
        # a copy: the port's steps update the state in place
        z0 = np.array(sim._state["slab"].x)[:, 2]
        sim.run()
        z1 = np.asarray(sim._state["slab"].x)[:, 2]
        rms0, rms1 = (float(np.sqrt((z ** 2).mean())) for z in (z0, z1))
        assert 0.6 * rms0 < rms1 < 1.6 * rms0, who
        assert np.isfinite(np.asarray(sim._state["slab"].v)).all()
        rms.append((rms0, rms1))
    assert (tmp_path / "t" / "s.bods").read_bytes() == \
        (tmp_path / "j" / "s.bods").read_bytes()
    print(f"rms thickness: exp_tpu {rms[0]}, port {rms[1]}")
    assert rms[1][0] == rms[0][0]
    assert abs(rms[1][1] - rms[0][1]) <= SLAB_RMS * rms[0][0]


def test_gendisk_nhalo_matches_exp_tpu(tmp_path, capsys):
    """gendisk --nhalo (the DiskHalo path) at a small size, as
    tests/test_torch_cli_ics.py does for gendisk2d."""
    from exp_tpu.cli.gendisk import main as j_gendisk
    from exp_tpu_torch.cli.gendisk import main as t_gendisk

    lines = []
    for who, main, extra in (("j", j_gendisk, []),
                             ("t", t_gendisk, ["--cpu"])):
        d = tmp_path / who
        d.mkdir()
        main(["-N", "2000", "--acyl", "0.01", "--hcyl", "0.002", "--mass",
              "0.05", "--halo", "hernquist", "--nhalo", "4000", "-o",
              str(d / "d.bods"), "--ohalo", str(d / "h.bods"),
              "--eof-cache", str(d / "eof.h5"), "--mmax", "2", "--nmaxd",
              "6", "--lmax", "2", "--nmaxh", "6", "-s", "3"] + extra)
        lines.append(capsys.readouterr().out)
    dj, dt = tmp_path / "j", tmp_path / "t"
    assert (dt / "h.bods").read_bytes() == (dj / "h.bods").read_bytes()
    (xj, vj, mj), (xt, vt, mt) = (_arrays(d / "d.bods") for d in (dj, dt))
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(mt, mj)
    err = np.abs(vt - vj).max() / np.abs(vj).max()
    print(f"disk velocities: max|d| / max|v| = {err:.3e}")
    assert err <= FIELD_TOL
    for out in lines:
        assert "2000 disk bodies" in out and "-2T/VC=" in out
        vr = float(out.split("-2T/VC=")[1].split(",")[0])
        assert abs(vr - 1.0) < 0.08, out
