"""The port stands alone: importing exp_tpu_torch loads neither jax nor
exp_tpu, no module of it imports them, and an entry point called without
a device raises when no CUDA device is present (never a silent CPU run)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "exp_tpu_torch"


def test_import_loads_no_jax_or_exp_tpu():
    code = (
        "import sys, exp_tpu_torch, exp_tpu_torch.forces.spherical, "
        "exp_tpu_torch.nbody.step, exp_tpu_torch.convert, "
        "exp_tpu_torch.bench_sphere, exp_tpu_torch.ic.eddington\n"
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


def test_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    from exp_tpu_torch import resolve_device
    from exp_tpu_torch.nbody.particles import ParticleSystem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParticleSystem.from_arrays([[1.0, 0, 0]], [[0, 0, 0]], [1.0])
    assert resolve_device("cpu") == torch.device("cpu")


def test_sphere_entry_point_without_device_raises_when_no_cuda(monkeypatch):
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
    from exp_tpu_torch.forces.spherical import SphereSL

    t = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=0,
                            nmax=2, numr=100, cmap=1, rmap=1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SphereSL.from_tables(t, backend="pallas")
