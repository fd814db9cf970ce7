"""The port's IC tools (exp_tpu_torch/cli: gensph, zangics, gendisk2d and the
umbrella `python -m exp_tpu_torch.cli`) against exp_tpu's, with exp_tpu's
flags and `--cpu`, on the flows of exp_tpu's own tests
(tests/test_qpdistf.py:85, tests/test_cli.py:409, :795, :813, :832, :849,
tests/test_diskhalo2d.py:91).  Each flow runs both tools into their own
body files and compares them:
  * host NumPy draws (gensph's Eddington paths, --addsphere, --ebar;
    zangics; gendisk2d's light path): the files equal byte for byte;
  * gensph --qp (its DF evaluated as tensors on the device): positions
    and masses equal, velocities within 1e-12 (tests/test_torch_ics.py);
  * gendisk2d --nhalo: the halo file and the disk's positions and masses
    equal, the disk velocities within 1e-5 of their largest value (drawn
    from Jeans tables of f32 fields summed in another order,
    tests/test_torch_diskhalo.py's FIELD_TOL), the printed -2T/VC within
    0.08 of 1 (tests/test_diskhalo2d.py:106)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
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


def _tools(name):
    import importlib

    return (importlib.import_module(f"exp_tpu.cli.{name}").main,
            importlib.import_module(f"exp_tpu_torch.cli.{name}").main)


def _both(tmp_path, name, argv, out_flag):
    """Run exp_tpu's tool and the port's (with --cpu) on `argv`, each
    writing out.bods (named after `out_flag`) into its own directory;
    returns the two directories."""
    j, t = _tools(name)
    dirs = []
    for who, main, extra in (("j", j, []), ("t", t, ["--cpu"])):
        d = tmp_path / who
        d.mkdir()
        main(argv + [out_flag, str(d / "out.bods")] + extra)
        dirs.append(d)
    return dirs


def _same_bytes(dirs, f="out.bods"):
    a, b = ((d / f).read_bytes() for d in dirs)
    assert a == b, f


def _arrays(path):
    from exp_tpu_torch.nbody.particles import read_ascii_arrays

    return read_ascii_arrays(str(path))


@pytest.mark.parametrize("argv", [
    ["-N", "4000", "-i", "hernquist", "-s", "7"],
    ["-N", "4000", "-i", "hernquist", "-s", "7", "--addsphere",
     "plummer:a=0.1,M=0.5"],
    ["-N", "3000", "-i", "hernquist", "-s", "5", "--ebar",
     "0.5,0.5,0.25,0.3"],
    ["-N", "500", "-i", "hernquist", "-s", "5", "--ebar",
     "0.5,0.5,0.25,0.3", "--ebar-smooth", "0.02"],
    ["-N", "500", "-i", "hernquist", "-s", "2", "--adddisk", "0.05,0.01"],
    ["-N", "500", "-i", "hernquist", "-s", "4", "--ra", "1.5"],
], ids=["plain", "addsphere", "ebar", "ebar-smooth", "adddisk", "ra"])
def test_gensph_host_flows_equal(tmp_path, argv):
    """tests/test_cli.py:795 (--addsphere) and :849 (--ebar): the same
    body file byte for byte."""
    _same_bytes(_both(tmp_path, "gensph", argv, "-o"))


@pytest.mark.parametrize("lam", ["0.0", "1e4"])
def test_gensph_qp_matches_exp_tpu(tmp_path, lam):
    """tests/test_qpdistf.py:85: gensph --qp (and its --qp-lambda)."""
    from exp_tpu.basis.model import hernquist_model

    dirs = _both(tmp_path, "gensph", [
        "-N", "2000", "-i", "hernquist", "--rmin", "1e-3", "--rmax", "20.0",
        "--qp", "--qp-lambda", lam, "-s", "2"], "-o")
    (xj, vj, mj), (xt, vt, mt) = (_arrays(d / "out.bods") for d in dirs)
    assert len(xt) == 2000 and np.isfinite(vt).all()
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(mt, mj)
    assert np.abs(vt - vj).max() <= 1e-12
    assert np.isclose(mt.sum(),
                      hernquist_model(rmin=1e-3, rmax=20.0).total_mass,
                      rtol=1e-6)


@pytest.mark.parametrize("argv", [
    ["-N", "12000", "-S", "0.4", "-s", "3"],
    ["-N", "1000", "-q", "4", "-s", "5", "-P", "-V"],
], ids=["sigma", "nrepl-quiet"])
def test_zangics_equal(tmp_path, argv):
    """tests/test_cli.py:813 and :832: the same body file byte for byte."""
    dirs = _both(tmp_path, "zangics", argv, "-f")
    _same_bytes(dirs)
    x, v, m = _arrays(dirs[1] / "out.bods")
    assert np.abs(x[:, 2]).max() == 0.0


@pytest.mark.parametrize("argv", [
    ["-N", "3000", "-i", "zang", "-s", "2"],
    ["-N", "2000", "-i", "kuzmin", "-s", "2"],
], ids=["zang", "kuzmin"])
def test_gendisk2d_light_equal(tmp_path, argv):
    """tests/test_cli.py:409: the same body file byte for byte."""
    _same_bytes(_both(tmp_path, "gendisk2d", argv, "-o"))


def test_gendisk2d_nhalo_matches_exp_tpu(tmp_path, capsys):
    """tests/test_diskhalo2d.py:91's flow (the Disk2dHalo path)."""
    j, t = _tools("gendisk2d")
    lines = []
    for who, main, extra in (("j", j, []), ("t", t, ["--cpu"])):
        d = tmp_path / who
        d.mkdir()
        main(["-N", "2000", "--model", "expon", "--acyl", "0.01",
              "--mass", "0.05", "--halo", "hernquist", "--nhalo", "4000",
              "-o", str(d / "d2.bods"), "--ohalo", str(d / "h2.bods"),
              "--disk-cache", str(d / "fd.h5"), "--mmax", "2", "--nmaxd",
              "6", "--lmax", "2", "--nmaxh", "6", "-s", "3"] + extra)
        lines.append(capsys.readouterr().out)
    dj, dt = tmp_path / "j", tmp_path / "t"
    assert (dt / "h2.bods").read_bytes() == (dj / "h2.bods").read_bytes()
    (xj, vj, mj), (xt, vt, mt) = (_arrays(d / "d2.bods") for d in (dj, dt))
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(mt, mj)
    assert np.abs(vt - vj).max() <= 1e-5 * np.abs(vj).max()
    assert np.all(xt[:, 2] == 0.0) and np.all(vt[:, 2] == 0.0)
    out = lines[1]
    assert "2000 disk bodies" in out and "-2T/VC=" in out
    vr = float(out.split("-2T/VC=")[1].split(",")[0])
    assert abs(vr - 1.0) < 0.08


def _umbrella(args, cwd):
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "exp_tpu_torch.cli"] + args,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_umbrella_runs_tools_and_refuses_without_a_card(tmp_path, capsys,
                                                       monkeypatch):
    """`python -m exp_tpu_torch.cli <tool>` dispatches to the tool (a
    process of its own); the tools list; an unknown tool is refused; and
    without a card and without --cpu each tool refuses before it writes
    (a usage error, exit code 2)."""
    from exp_tpu_torch.cli import __main__ as umbrella

    p = _umbrella(["zangics", "-N", "500", "-s", "3", "-f", "z.bods",
                   "--cpu"], tmp_path)
    assert p.returncode == 0, p.stderr
    j, _ = _tools("zangics")
    j(["-N", "500", "-s", "3", "-f", str(tmp_path / "zj.bods")])
    assert (tmp_path / "z.bods").read_bytes() == \
        (tmp_path / "zj.bods").read_bytes()
    for argv, rc in ((["--help"], 0), (["nosuchtool"], 2)):
        monkeypatch.setattr(sys, "argv", ["exp_tpu_torch.cli"] + argv)
        assert umbrella.main() == rc
    out = capsys.readouterr().out
    assert all(t in out for t in ("gensph", "zangics", "gendisk2d"))
    if torch.cuda.is_available():
        return
    monkeypatch.chdir(tmp_path)
    for tool in ("gensph", "zangics", "gendisk2d"):
        _, main = _tools(tool)
        with pytest.raises(SystemExit) as e:
            main(["-N", "100", "-s", "1"])
        assert e.value.code == 2, tool
        err = capsys.readouterr().err
        assert "no CUDA device" in err and "--cpu" in err, err
    assert sorted(os.listdir(tmp_path)) == ["z.bods", "zj.bods"]
