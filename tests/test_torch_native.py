"""The port's native ascii reader (exp_tpu_torch/native: fastio.cpp built
by g++ and loaded through ctypes) against exp_tpu's (exp_tpu/native), on
tests/test_io.py:193's flow.  Body reads are held bit for bit (no
tolerance): the port's `read_ascii_arrays` and its world's row-block read
(`read_bodies_distributed`) against exp_tpu's `read_ascii_arrays`, with
the library and without it (EXP_TPU_NO_NATIVE: NumPy's loadtxt), on a
clean table and on one whose rows carry ragged trailing attribute columns
(which exp_tpu reads only through its library).  Two processes that build
into one fresh build directory at once both load the library."""

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


@pytest.fixture(scope="module")
def libs():
    """Both packages' libraries, built here (g++ is this machine's)."""
    from exp_tpu import native as jn
    from exp_tpu_torch import native as tn

    assert tn.get_lib() is not None, "g++ could not build fastio.cpp"
    assert jn.get_lib() is not None
    return jn, tn


def _table(path, n, extra, ragged=False, seed=5):
    """An ascii body file: `n` rows of 7 body columns and `extra`
    attribute columns (with `ragged`, each row 0..extra of them), values
    of mixed magnitude in %.10e and %.17g."""
    rng = np.random.default_rng(seed)
    arr = rng.normal(0, 1, (n, 7 + extra)) * 10.0 ** rng.integers(
        -8, 8, (n, 7 + extra))
    with open(path, "w") as f:
        f.write(f"{n} 0 {extra}\n")
        for i, row in enumerate(arr):
            k = 7 + (rng.integers(0, extra + 1) if ragged else extra)
            fmt = "%.10e" if i % 2 else "%.17g"
            f.write(" ".join(fmt % x for x in row[:k]) + "\n")
    return arr


def _no_lib(monkeypatch, jn):
    """Both packages without their library: the port through
    EXP_TPU_NO_NATIVE, exp_tpu's cached probe set to 'tried, none'."""
    monkeypatch.setenv("EXP_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(jn, "_LIB", None)
    monkeypatch.setattr(jn, "_TRIED", True)


def test_native_fastio_flow(tmp_path, libs):
    """tests/test_io.py:193: the parser against NumPy on a table with two
    attribute columns, and the port's parse equal to exp_tpu's bit for
    bit."""
    jn, tn = libs
    p = tmp_path / "t.bods"
    arr = _table(p, 500, 2)
    fast = tn.read_ascii_table(str(p), max_rows=500, ncols=7, skip_lines=1)
    np.testing.assert_allclose(fast, arr[:, :7], rtol=1e-9)
    ref = jn.read_ascii_table(str(p), max_rows=500, ncols=7, skip_lines=1)
    assert fast.tobytes() == ref.tobytes()
    auto = tn.read_ascii_table(str(p), skip_lines=1)
    assert auto.shape == (500, 9)
    assert auto.tobytes() == jn.read_ascii_table(str(p),
                                                 skip_lines=1).tobytes()


@pytest.mark.parametrize("with_lib", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("extra,ragged", [(0, False), (2, False),
                                          (3, True)],
                         ids=["clean", "attrs", "ragged"])
def test_body_reads_equal_exp_tpu(tmp_path, monkeypatch, libs, with_lib,
                                  extra, ragged):
    """read_ascii_arrays and read_ascii_bodies of the port equal exp_tpu's
    read_ascii_arrays bit for bit.  exp_tpu's reference read is its
    library's (without it NumPy refuses ragged rows); the port reads the
    ragged file with either."""
    from exp_tpu.nbody.particles import read_ascii_arrays as j_read
    from exp_tpu_torch.nbody.particles import (read_ascii_arrays,
                                               read_ascii_bodies)

    jn, tn = libs
    p = tmp_path / "b.bods"
    _table(p, 777, extra, ragged=ragged)
    ref = j_read(str(p))
    if not with_lib:
        _no_lib(monkeypatch, jn)
        assert tn.get_lib() is None
        if not ragged:
            ref_np = j_read(str(p))
            for a, b in zip(ref_np, ref):
                assert a.tobytes() == b.tobytes()
        else:
            with pytest.raises(ValueError):
                j_read(str(p))
    got = read_ascii_arrays(str(p))
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    ps = read_ascii_bodies(str(p), dtype=torch.float64, device="cpu")
    assert ps.x.numpy().tobytes() == np.ascontiguousarray(ref[0]).tobytes()


@pytest.mark.parametrize("with_lib", [True, False], ids=["native", "numpy"])
def test_world_block_reads_equal_exp_tpu(tmp_path, monkeypatch, libs,
                                         with_lib):
    """The world's row-block read (parallel/distributed.py) on 3 ranks,
    its scale column too: the blocks concatenate to exp_tpu's whole read
    bit for bit."""
    from exp_tpu.nbody.particles import read_ascii_arrays as j_read
    from exp_tpu.nbody.particles import read_ascii_dattr as j_dattr
    from exp_tpu_torch.parallel.distributed import (World,
                                                    read_bodies_distributed)

    jn, _ = libs
    p = tmp_path / "b.bods"
    _table(p, 301, 2, seed=7)
    x, v, m = j_read(str(p))
    sc = j_dattr(str(p), 1)
    if not with_lib:
        _no_lib(monkeypatch, jn)
    parts = [read_bodies_distributed(str(p), World(rank=r, size=3),
                                     dtype=torch.float64, scale_dattr=1)
             for r in range(3)]
    for f, ref in (("x", x), ("v", v), ("mass", m), ("scale", sc)):
        got = np.concatenate([getattr(q, f).numpy() for q in parts])
        assert got[:301].tobytes() == np.ascontiguousarray(ref).tobytes(), f
        assert (got[301:] == (-1.0 if f == "scale" else 0.0)).all()


def test_short_row_and_comment_lines(tmp_path, libs):
    """Comment lines are skipped; a short row stops the parse, and the
    body read then refuses (never rows shifted across lines)."""
    from exp_tpu_torch.nbody.particles import read_ascii_arrays

    _, tn = libs
    p = tmp_path / "c.txt"
    p.write_text("# head\n1 2 3\n# mid\n4 5 6\n7 8\n9 10 11\n")
    t = tn.read_ascii_table(str(p), ncols=3)
    np.testing.assert_array_equal(t, [[1, 2, 3], [4, 5, 6]])
    b = tmp_path / "s.bods"
    b.write_text("3 0 0\n" + "1 2 3 4 5 6 7\n" * 2 + "1 2 3\n")
    with pytest.raises(ValueError, match="expected 3 rows"):
        read_ascii_arrays(str(b))


def test_library_off_and_no_compiler(tmp_path, monkeypatch):
    """EXP_TPU_NO_NATIVE turns the library off (parse_table raises, the
    callers read with NumPy); with no compiler the build fails and
    get_lib() is None, leaving no file behind."""
    from exp_tpu_torch import native as tn

    monkeypatch.setenv("EXP_TPU_NO_NATIVE", "1")
    assert tn.get_lib() is None
    with pytest.raises(RuntimeError, match="unavailable"):
        tn.parse_table(b"1 2\n\x00", 0, 1, 2)
    monkeypatch.delenv("EXP_TPU_NO_NATIVE")

    def no_gxx(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(tn.subprocess, "run", no_gxx)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(tn, "_LIB", None)
    monkeypatch.setattr(tn, "_TRIED", False)
    assert tn.get_lib() is None
    assert os.listdir(tmp_path / "b") == []


def test_concurrent_builds_into_one_directory(tmp_path):
    """Two processes build fastio.cpp into one fresh build directory at
    once: each compiles to a file of its own and renames it into place,
    and both load the library and parse with it."""
    build = tmp_path / "build"
    code = ("import sys; from exp_tpu_torch import native as n; "
            "n.BUILD_DIR = sys.argv[1]; lib = n.get_lib(); "
            "print(n.parse_table(b'1 2 3\\n\\x00', 0, 1, 3).tolist(), "
            "lib.count_columns(b'1 2 3\\n\\x00', 0))")
    env = dict(os.environ)
    env.pop("EXP_TPU_NO_NATIVE", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["[[1.0,", "2.0,", "3.0]]", "3"]
    files = os.listdir(build)
    assert len(files) == 1 and files[0].startswith("libfastio-") \
        and files[0].endswith(".so"), files
