"""The port stands alone: importing exp_tpu_torch loads neither jax nor
exp_tpu, no module of it imports them, and an entry point called without
a device raises when no CUDA device is present (never a silent CPU run)."""

import ast
import os
import pathlib
import subprocess
import sys

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


ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "exp_tpu_torch"


def test_import_loads_no_jax_or_exp_tpu():
    code = (
        "import sys, exp_tpu_torch, exp_tpu_torch.forces.spherical, "
        "exp_tpu_torch.nbody.step, exp_tpu_torch.convert, "
        "exp_tpu_torch.bench_sphere, exp_tpu_torch.ic.eddington, "
        "exp_tpu_torch.forces.cylinder, exp_tpu_torch.ops.cyl_kernels, "
        "exp_tpu_torch.basis.empcyl, exp_tpu_torch.basis.flatdisk, "
        "exp_tpu_torch.ic.disk, exp_tpu_torch.bench_disk, "
        "exp_tpu_torch.forces.cube, exp_tpu_torch.ops.cube_kernels, "
        "exp_tpu_torch.ic.cubeics, exp_tpu_torch.bench_cube, "
        "exp_tpu_torch.basis.slab, exp_tpu_torch.forces.slab, "
        "exp_tpu_torch.ops.slab_kernels, exp_tpu_torch.ic.slab, "
        "exp_tpu_torch.bench_slab, exp_tpu_torch.nbody.multistep, "
        "exp_tpu_torch.ic.diskhalo, exp_tpu_torch.bench_composite, "
        "exp_tpu_torch.probe_slab_phasestream, exp_tpu_torch.config, "
        "exp_tpu_torch.run, exp_tpu_torch.nbody.simulation, "
        "exp_tpu_torch.nbody.output, exp_tpu_torch.io.psp, "
        "exp_tpu_torch.io.coefs, exp_tpu_torch.forces.noforce, "
        "exp_tpu_torch.cli._common, exp_tpu_torch.nbody.centering, "
        "exp_tpu_torch.nbody.pca, exp_tpu_torch.nbody.noise, "
        "exp_tpu_torch.forces.external, exp_tpu_torch.ic.ellipsoid, "
        "exp_tpu_torch.analysis.coefs, exp_tpu_torch.bench_extras, "
        "exp_tpu_torch.parallel, exp_tpu_torch.parallel.distributed, "
        "exp_tpu_torch.bench_energy, exp_tpu_torch.bench_multirank, "
        "exp_tpu_torch.analysis, exp_tpu_torch.analysis.basis, "
        "exp_tpu_torch.analysis.field, exp_tpu_torch.analysis.field_basis, "
        "exp_tpu_torch.analysis.crossval, exp_tpu_torch.analysis.wake, "
        "exp_tpu_torch.analysis.diskeof, exp_tpu_torch.analysis.kincoefs, "
        "exp_tpu_torch.analysis.mssa, exp_tpu_torch.analysis.edmd, "
        "exp_tpu_torch.analysis.orbit, exp_tpu_torch.analysis.units, "
        "exp_tpu_torch.analysis.util, exp_tpu_torch.io.readers, "
        "exp_tpu_torch.probe_analysis, exp_tpu_torch.ic, "
        "exp_tpu_torch.ic.qpdistf, exp_tpu_torch.ic.zang, "
        "exp_tpu_torch.ic.ellip, exp_tpu_torch.ic.diskhalo2d, "
        "exp_tpu_torch.cli, exp_tpu_torch.cli.__main__, "
        "exp_tpu_torch.cli.gensph, exp_tpu_torch.cli.zangics, "
        "exp_tpu_torch.cli.gendisk2d, exp_tpu_torch.pyexp, "
        "exp_tpu_torch.pyexp.read, exp_tpu_torch.pyexp.util, "
        "exp_tpu_torch.pyexp.coefs, exp_tpu_torch.pyexp.basis, "
        "exp_tpu_torch.pyexp.field, exp_tpu_torch.pyexp.mssa, "
        "exp_tpu_torch.pyexp.edmd, exp_tpu_torch.cli.analysis_tools, "
        "exp_tpu_torch.cli.haloprof, exp_tpu_torch.cli.diskprof, "
        "exp_tpu_torch.cli.sphprof, exp_tpu_torch.cli.slabprof, "
        "exp_tpu_torch.cli.viewcoefs, exp_tpu_torch.cli.h5compare, "
        "exp_tpu_torch.cli.h5power, exp_tpu_torch.cli.mssaprof, "
        "exp_tpu_torch.cli.slcheck, exp_tpu_torch.cli.orthochk, "
        "exp_tpu_torch.cli.scalarprod, exp_tpu_torch.cli.cylcache, "
        "exp_tpu_torch.cli.eofinfo, exp_tpu_torch.cli.makecoefs, "
        "exp_tpu_torch.cli.coefstoh5, exp_tpu_torch.cli.crossval, "
        "exp_tpu_torch.cli.kldiv, exp_tpu_torch.cli.diskeof, "
        "exp_tpu_torch.cli.diskfreqs, exp_tpu_torch.cli.slshift, "
        "exp_tpu_torch.cli.expmssa, exp_tpu_torch.cli.mssafilter, "
        "exp_tpu_torch.cli.yamldiff, exp_tpu_torch.native, "
        "exp_tpu_torch.validate, exp_tpu_torch.ops.transforms, "
        "exp_tpu_torch.bench_validate, exp_tpu_torch.cli.psptools, "
        "exp_tpu_torch.cli.ics_tools, exp_tpu_torch.cli.pspinfo, "
        "exp_tpu_torch.cli.pspstat, exp_tpu_torch.cli.psp2ascii, "
        "exp_tpu_torch.cli.ascii2psp, exp_tpu_torch.cli.snap2ascii, "
        "exp_tpu_torch.cli.diffpsp, exp_tpu_torch.cli.pspinterp, "
        "exp_tpu_torch.cli.psp2hdf5, exp_tpu_torch.cli.shrinkics, "
        "exp_tpu_torch.cli.psphisto, exp_tpu_torch.cli.pspbox, "
        "exp_tpu_torch.cli.snapconvert, exp_tpu_torch.cli.snap2vtk, "
        "exp_tpu_torch.cli.addring, exp_tpu_torch.cli.addsphmod, "
        "exp_tpu_torch.cli.modelfit, exp_tpu_torch.cli.forcetest, "
        "exp_tpu_torch.cli.hdf52accel, exp_tpu_torch.cli.psporbv, "
        "exp_tpu_torch.cli.pspmono, exp_tpu_torch.cli.psp2bess, "
        "exp_tpu_torch.cli.psp2lagu, exp_tpu_torch.cli.psp2rings, "
        "exp_tpu_torch.cli.psp2range, exp_tpu_torch.cli.pspreal, "
        "exp_tpu_torch.cli.spl2psp, exp_tpu_torch.cli.tipstd2psp, "
        "exp_tpu_torch.cli.psp2vtu, exp_tpu_torch.cli.cubeics, "
        "exp_tpu_torch.cli.genslab, exp_tpu_torch.cli.gendisk, "
        "exp_tpu_torch.cli.bonnerebert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'exp_tpu' or m.startswith('exp_tpu.')]\n"
        "print(','.join(bad))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_exp_tpu(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "exp_tpu", "bench_suite"), (
            f"{path.name} imports {mod}")


# exp_tpu modules with no counterpart: ops/padding.py has no caller, and
# the Pallas kernels are the port's csrc/*.cu behind ops/*_kernels.py
NO_COUNTERPART = ("ops/padding.py", "ops/pallas_*.py")


def test_every_exp_tpu_module_has_a_counterpart():
    """Listing the files (importing none): every .py under exp_tpu/ has a
    file at the same path under exp_tpu_torch/, but NO_COUNTERPART; and
    the native reader's source is carried with its loader."""
    jax_pkg = ROOT / "exp_tpu"
    missing = [str(p.relative_to(jax_pkg))
               for p in sorted(jax_pkg.rglob("*.py"))
               if not any(p.relative_to(jax_pkg).match(g)
                          for g in NO_COUNTERPART)
               and not (PORT / p.relative_to(jax_pkg)).exists()]
    assert missing == []
    assert (PORT / "native" / "fastio.cpp").exists()
    skipped = [p for g in NO_COUNTERPART for p in jax_pkg.glob(g)]
    assert len(skipped) == 5, skipped


def _exp_tpu_tools():
    """exp_tpu's TOOLS, read from its file (no import of exp_tpu)."""
    tree = ast.parse((ROOT / "exp_tpu" / "cli" / "__init__.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and n.targets[0].id == "TOOLS")
    return ast.literal_eval(node.value)


def test_tools_equal_exp_tpus():
    from exp_tpu_torch.cli import TOOLS

    assert TOOLS == _exp_tpu_tools() and len(TOOLS) == 58


@pytest.mark.parametrize("tool", _exp_tpu_tools())
def test_every_tool_help(tool, monkeypatch, capsys):
    """tests/test_kincoefs.py:411's flow on the port's umbrella: `python -m
    exp_tpu_torch.cli <tool> --help` exits 0, with the flags of exp_tpu's
    tool (the same add_argument calls, in order)."""
    import argparse
    import importlib

    from exp_tpu_torch.cli import __main__ as umbrella

    def flags(run):
        seen = []
        real = argparse.ArgumentParser.add_argument

        def spy(self, *a, **k):
            seen.append((a, tuple(k.get("choices") or ())))
            return real(self, *a, **k)

        monkeypatch.setattr(argparse.ArgumentParser, "add_argument", spy)
        with pytest.raises(SystemExit) as e:
            run()
        monkeypatch.setattr(argparse.ArgumentParser, "add_argument", real)
        assert e.value.code in (0, None), tool
        return seen

    monkeypatch.setattr(sys, "argv", ["exp_tpu_torch.cli", tool, "--help"])
    ours = flags(umbrella.main)
    assert f"exp_tpu_torch {tool}" in capsys.readouterr().out
    theirs = flags(lambda: importlib.import_module(
        f"exp_tpu.cli.{tool}").main(["--help"]))
    assert ours == theirs


def test_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    from exp_tpu_torch import resolve_device
    from exp_tpu_torch.nbody.particles import ParticleSystem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParticleSystem.from_arrays([[1.0, 0, 0]], [[0, 0, 0]], [1.0])
    assert resolve_device("cpu") == torch.device("cpu")


def test_ic_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    """The QP DF (its evaluations run on the device), sample_qp_model and
    EllipsoidForce's tables refuse with no device named and no card."""
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.ic.ellipsoid import EllipsoidForce
    from exp_tpu_torch.ic.qpdistf import QPDistF, sample_qp_model

    m = hernquist_model(rmin=1e-3, rmax=20.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(egrid=4, kgrid=2, mgrid=8, nint=4)
    for call in (lambda: QPDistF(m, **kw),
                 lambda: sample_qp_model(m, 10, **kw),
                 lambda: EllipsoidForce(num=4).mass_inertia(),
                 lambda: EllipsoidForce(num=4).monopole_quadrupole(numr=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_sphere_entry_point_without_device_raises_when_no_cuda(monkeypatch):
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
    from exp_tpu_torch.forces.spherical import SphereSL

    t = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=0,
                            nmax=2, numr=100, cmap=1, rmap=1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SphereSL.from_tables(t, backend="pallas")


def test_cylinder_entry_point_without_device_raises_when_no_cuda(
        monkeypatch):
    from exp_tpu_torch.basis.flatdisk import build_flatdisk_tables
    from exp_tpu_torch.forces.cylinder import CylinderForce

    t = build_flatdisk_tables(mmax=1, nmax=2, model="kuzmin", numx=16,
                              numy=8, knots=40, numk=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CylinderForce.from_tables(t, backend="pallas")


def test_cube_entry_point_without_device_raises_when_no_cuda(monkeypatch):
    from exp_tpu_torch.convert import complex_from_numpy, cube_from_numpy
    from exp_tpu_torch.forces.cube import Cube

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Cube.create(2, 2, 2, backend="pallas")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cube_from_numpy(np.zeros((5, 5, 5)), np.zeros((5, 5, 5)), 2, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        complex_from_numpy(np.zeros(3, np.complex64))


def test_slab_entry_point_without_device_raises_when_no_cuda(monkeypatch):
    from exp_tpu_torch.basis.slab import build_slab_tables
    from exp_tpu_torch.bench_slab import bench_slab, slab_force
    from exp_tpu_torch.forces.slab import SlabForce

    t = build_slab_tables(nmaxx=1, nmaxy=1, nmax=2, numz=51)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlabForce.from_tables(t, backend="pallas")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slab_force(t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_slab(n=10, tables=t)
    with pytest.raises(RuntimeError, match="times the card"):
        bench_slab(n=10, tables=t, device="cpu")


def test_sphere_settings_entry_points_without_device_raise_when_no_cuda(
        monkeypatch):
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
    from exp_tpu_torch.bench_sphere import bench_sphere, sphere_force

    t = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=0,
                            nmax=2, numr=100, cmap=1, rmap=1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sphere_force(t, None, harmonics="recurrence", interp="hat")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_sphere(n=10, tables=t, harmonics="poly")
    with pytest.raises(RuntimeError, match="times the card"):
        bench_sphere(n=10, tables=t, device="cpu", interp="hat")


def test_composite_and_probe_entry_points_without_device_raise_when_no_cuda(
        monkeypatch):
    from exp_tpu_torch import probe_slab_phasestream as probe
    from exp_tpu_torch.bench_composite import (bench_composite,
                                               composite_forces, prepare)
    from exp_tpu_torch.convert import buckets_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: composite_forces(), lambda: prepare(8, 8),
                 lambda: bench_composite(8, 8), lambda: probe.check(n=8),
                 lambda: probe.bench(n=8), lambda: buckets_from_numpy([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="times the card"):
        bench_composite(8, 8, device="cpu")


def test_analysis_probe_refuses_without_cuda(monkeypatch, capsys):
    """The analysis probe exits 1 with no CUDA device and prints no result."""
    from exp_tpu_torch import probe_analysis

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_analysis.main() == 1
    assert capsys.readouterr().out == ""


def test_driver_entry_points_without_device_raise_when_no_cuda(
        monkeypatch, tmp_path):
    from exp_tpu_torch.config import ForceConfig, RunConfig
    from exp_tpu_torch.nbody.particles import read_bodies, write_ascii_bodies
    from exp_tpu_torch.nbody.simulation import Simulation, build_force
    from exp_tpu_torch.run import main

    write_ascii_bodies(tmp_path / "b.bods", (np.ones((4, 3)),
                                             np.zeros((4, 3)), np.ones(4)))
    raw = {"Global": {"nsteps": 1},
           "Components": [{"name": "h", "bodyfile": "b.bods",
                           "force": {"id": "noforce"}}]}
    (tmp_path / "c.yml").write_text(
        "Global: {nsteps: 1}\nComponents:\n  - {name: h, bodyfile: b.bods,"
        " force: {id: noforce}}\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: Simulation(RunConfig.from_dict(raw), str(tmp_path)),
                 lambda: build_force(ForceConfig("noforce"), torch.float32),
                 lambda: read_bodies(str(tmp_path / "b.bods")),
                 lambda: main([str(tmp_path / "c.yml")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    sim = main([str(tmp_path / "c.yml"), "--device", "cpu"])
    assert sim.device == torch.device("cpu") and sim.istep == 1


def test_multi_rank_entry_points_without_device_raise_when_no_cuda(
        monkeypatch, tmp_path):
    """run.py --ndev and --distributed, init_distributed, bench_energy and
    bench_multirank run on cards unless the CPU is named: with no card
    they refuse."""
    from exp_tpu_torch.bench_energy import run_direct
    from exp_tpu_torch.bench_multirank import world_devices
    from exp_tpu_torch.parallel.distributed import init_distributed
    from exp_tpu_torch.run import main

    cfg = tmp_path / "c.yml"
    cfg.write_text("Global:\n  nsteps: 1\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for argv in ([str(cfg), "--ndev", "2"], [str(cfg), "--distributed"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed(num_processes=1, process_id=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_direct(None, None, {"mh": [], "md": []}, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        world_devices(2)
    assert world_devices(2, "cpu") == (["cpu", "cpu"], "gloo")


def test_pyexp_and_tools_without_device_refuse_when_no_cuda(
        monkeypatch, capsys, tmp_path):
    """pyEXP's Basis.factory, FieldBasis and VelocityBasis raise with no
    device named and no card; a ported tool without --cpu refuses with a
    usage error (exit 2) before it writes."""
    import exp_tpu_torch.pyexp as pyEXP
    from exp_tpu_torch.cli.slshift import main as slshift

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = "{id: sphereSL, parameters: {modelname: hernquist, Lmax: 0, " \
        "nmax: 2, numr: 100}}"
    for call in (lambda: pyEXP.basis.Basis.factory(conf),
                 lambda: pyEXP.basis.FieldBasis("{parameters: {nmax: 2}}"),
                 lambda: pyEXP.basis.VelocityBasis("{parameters: {nmax: 2}}")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        slshift(["-o", "sh"])
    assert e.value.code == 2 and "no CUDA device" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []
