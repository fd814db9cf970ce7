"""The port's model builders (exp_tpu_torch/basis/model.py, cli/_common.py
load_model) against exp_tpu's: the same tables to 1e-12 relative in f64,
and the SL and EOF caches each package writes read by the other."""


import jax
import numpy as np
import pytest
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

import exp_tpu.basis.model as jm
import exp_tpu_torch.basis.model as tm
import torch


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


RTOL = 1e-12        # f64 NumPy/SciPy on both sides: the same arithmetic


def _same(a, b):
    for k in ("r", "rho", "mass", "pot"):
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=RTOL,
                                   atol=0.0, err_msg=k)
    assert a.comment == b.comment


@pytest.mark.parametrize("name,kw", [
    ("plummer_model", {"a": 0.7, "M": 1.3, "numr": 500}),
    ("king_model", {"W0": 6.0, "M": 1.0, "rt": 2.0, "numr": 400}),
    ("truncated_powerlaw_model", {"numr": 400}),
    ("hernquist_model", {"a": 0.5, "numr": 300}),
])
def test_analytic_models_match(name, kw):
    _same(getattr(tm, name)(**kw), getattr(jm, name)(**kw))


def test_model_from_particles_matches():
    rng = np.random.default_rng(4)
    u = rng.uniform(0.01, 0.99, 4000)
    r = u / (1 - u)
    d = rng.normal(size=(4000, 3))
    x = r[:, None] * d / np.linalg.norm(d, axis=1)[:, None]
    m = np.full(4000, 1.0 / 4000)
    m[:10] = 0.0                                  # padding rows ignored
    _same(tm.model_from_particles(x, m, numr=200),
          jm.model_from_particles(x, m, numr=200))


@pytest.mark.parametrize("include_density", [False, True])
def test_add_sphere_to_model_matches(include_density):
    h = dict(rmin=1e-3, rmax=30.0, numr=400)
    bulge = dict(a=0.2, M=0.3, rmin=1e-3, rmax=10.0, numr=300)
    _same(tm.add_sphere_to_model(tm.hernquist_model(**h),
                                 tm.plummer_model(**bulge), 0.5,
                                 include_density),
          jm.add_sphere_to_model(jm.hernquist_model(**h),
                                 jm.plummer_model(**bulge), 0.5,
                                 include_density))


@pytest.mark.parametrize("name", ["hernquist", "hernquist:a=0.5,M=2",
                                  "plummer:a=0.3", "king:W0=4",
                                  "nfwtrunc:rcore=0.02", "file"])
def test_load_model_matches(tmp_path, name):
    from exp_tpu.cli._common import load_model as jload
    from exp_tpu_torch.cli._common import load_model as tload

    if name == "file":
        jm.hernquist_model(numr=200).to_file(tmp_path / "h.model")
        name = str(tmp_path / "h.model")
    _same(tload(name, numr=300), jload(name, numr=300))


def test_sl_cache_interop(tmp_path):
    """Each package reads the other's spherical SL cache (same key, same
    arrays) instead of rebuilding."""
    from exp_tpu.basis.slgrid import build_sph_sl_tables as jbuild
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables as tbuild

    kw = dict(lmax=2, nmax=4, numr=200, cmap=1, rmap=1.0)
    jp, tp = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    tj = jbuild(jm.hernquist_model(rmin=1e-3, rmax=20.0), cachename=jp, **kw)
    tt = tbuild(tm.hernquist_model(rmin=1e-3, rmax=20.0), cachename=tp, **kw)
    assert tt.model_key == tj.model_key
    # a cache whose key matches is returned as read: ef equals the writer's
    t_from_j = tbuild(tm.hernquist_model(rmin=1e-3, rmax=20.0), cachename=jp,
                      **kw)
    j_from_t = jbuild(jm.hernquist_model(rmin=1e-3, rmax=20.0), cachename=tp,
                      **kw)
    np.testing.assert_array_equal(t_from_j.ef, tj.ef)
    np.testing.assert_array_equal(j_from_t.ef, tt.ef)


def test_eof_cache_interop(tmp_path):
    """Each package reads the other's EOF cylinder cache."""
    from exp_tpu.basis.empcyl import build_empcyl_tables as jbuild
    from exp_tpu_torch.basis.empcyl import build_empcyl_tables as tbuild

    kw = dict(mmax=1, nmax=3, lmaxfid=4, nmaxfid=4, numx=16, numy=8,
              rnum=24, tnum=12)
    jp, tp = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    tj = jbuild(cachename=jp, **kw)
    tt = tbuild(cachename=tp, **kw)
    t_from_j = tbuild(cachename=jp, **kw)
    j_from_t = jbuild(cachename=tp, **kw)
    np.testing.assert_array_equal(t_from_j.pot, tj.pot)
    np.testing.assert_array_equal(j_from_t.pot, tt.pot)
    np.testing.assert_allclose(tt.pot, tj.pot, rtol=1e-9,
                               atol=1e-12 * np.abs(tj.pot).max())


def test_table_builds_repeat_bit_for_bit():
    """The SL and EOF builds give the same bits twice in one process (a
    fixed eigsh start vector; ARPACK's own random start moved them by
    ~1e-13), so two runs of one config agree bit for bit."""
    from exp_tpu_torch.basis.empcyl import build_empcyl_tables
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables

    m = tm.hernquist_model(rmin=1e-3, rmax=20.0, numr=400)
    a, b = (build_sph_sl_tables(m, lmax=2, nmax=6, numr=400, cmap=1,
                                rmap=1.0) for _ in range(2))
    np.testing.assert_array_equal(a.ef, b.ef)
    np.testing.assert_array_equal(a.ev, b.ev)
    kw = dict(mmax=1, nmax=3, lmaxfid=4, nmaxfid=4, numx=16, numy=8,
              rnum=24, tnum=12)
    np.testing.assert_array_equal(build_empcyl_tables(**kw).pot,
                                  build_empcyl_tables(**kw).pot)
