"""The port's host builders against exp_tpu's: SL tables, the spline
prefilter and radial tables, the real-Ylm normalization, the solid-harmonic
matrices, the special functions and the Eddington sample, on the same
inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.model import hernquist_model as j_hernquist
from exp_tpu.basis.slgrid import build_sph_sl_tables as j_build
from exp_tpu.ic.eddington import sample_spherical_model as j_sample
from exp_tpu.ops import solidharm as j_sh
from exp_tpu.ops.pallas_cylinder import prefilter_x as j_prefilter
from exp_tpu.ops.pallas_sphere import packed_rows as j_packed_rows
from exp_tpu.ops.special import dlegendre_lm as j_dlegendre
from exp_tpu.ops.special import real_ylm_norm as j_norm
from exp_tpu.ops.special import sincos_m as j_sincos
from exp_tpu.forces.spherical import spline_radial_tables as j_spline_tabs

from exp_tpu_torch.basis.model import hernquist_model
from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
from exp_tpu_torch.convert import sph_tables_from_numpy
from exp_tpu_torch.forces.spherical import spline_radial_tables
from exp_tpu_torch.ic.eddington import sample_spherical_model
from exp_tpu_torch.ops import solidharm
from exp_tpu_torch.ops.special import dlegendre_lm, real_ylm_norm, sincos_m
from exp_tpu_torch.ops.sphere_kernels import packed_rows
from exp_tpu_torch.ops.spline import prefilter_x


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
def tables():
    kw = dict(lmax=3, nmax=6, numr=400, cmap=1, rmap=1.0)
    jt = j_build(j_hernquist(rmin=1e-3, rmax=20.0), **kw)
    pt = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), **kw)
    return jt, pt


def test_sl_tables_equal_to_roundoff(tables):
    """The same SciPy solve on the same grid: measured max relative
    difference 0 (bit-identical) on this machine; gated at 1e-12."""
    jt, pt = tables
    assert pt.model_key == jt.model_key
    for k in ("xi", "r", "p0", "d0", "ev", "ef"):
        a, b = getattr(jt, k), getattr(pt, k)
        scale = max(np.abs(a).max(), 1e-300)
        assert np.abs(a - b).max() / scale <= 1e-12, k
    for k in ("xmin", "xmax", "dxi", "rmin", "rmax"):
        assert getattr(pt, k) == pytest.approx(getattr(jt, k), rel=1e-15)


def test_tables_carried_across(tables):
    jt, _ = tables
    ct = sph_tables_from_numpy(dataclasses.asdict(jt))
    np.testing.assert_array_equal(ct.pot_table, jt.pot_table)
    np.testing.assert_array_equal(ct.dens_table, jt.dens_table)
    assert (ct.lmax, ct.nmax, ct.numr, ct.cmap) == (jt.lmax, jt.nmax,
                                                    jt.numr, jt.cmap)
    with pytest.raises(ValueError, match="unknown"):
        sph_tables_from_numpy({**dataclasses.asdict(jt), "bogus": 1})


def test_prefilter_and_spline_tables(tables):
    jt, _ = tables
    pt = jt.pot_table.reshape(jt.numr, -1)
    np.testing.assert_array_equal(prefilter_x(pt[:50]), j_prefilter(pt[:50]))
    a_s, a_d = spline_radial_tables(pt, np.asarray(jt.xi), 64)
    b_s, b_d = j_spline_tabs(pt, np.asarray(jt.xi), 64)
    np.testing.assert_array_equal(a_s, np.asarray(b_s))
    np.testing.assert_array_equal(a_d, np.asarray(b_d))


@pytest.mark.parametrize("lmax", [0, 4, 6])
def test_real_ylm_norm_and_packed_rows(lmax):
    np.testing.assert_array_equal(
        real_ylm_norm(lmax, torch.float64).numpy(), np.asarray(j_norm(lmax)))
    assert packed_rows(lmax) == j_packed_rows(lmax)


@pytest.mark.parametrize("lmax", [0, 2, 4])
def test_solidharm_matrices(lmax):
    rows = tuple(packed_rows(lmax))
    assert solidharm.monomial_exponents(lmax) == j_sh.monomial_exponents(lmax)
    for a, b in zip(solidharm.harmonic_and_gradient_matrices(lmax, rows),
                    j_sh.harmonic_and_gradient_matrices(lmax, rows)):
        np.testing.assert_array_equal(a, b)
    for (d1, m1, u1), (d2, m2, u2) in zip(solidharm.monomial_build_plan(lmax),
                                          j_sh.monomial_build_plan(lmax)):
        for p, q in ((d1, d2), (m1, m2), (u1, u2)):
            np.testing.assert_array_equal(p, q)


def test_special_functions():
    """f64 Legendre/dP/trig rows: measured max |diff| ~1e-16 (ulp-level
    libm differences in cos/sin); gated at 1e-13."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-1, 1, 200), [-1.0, 1.0, 0.0]])
    phi = rng.uniform(-np.pi, np.pi, 203)
    P, dP = dlegendre_lm(5, torch.tensor(x))
    jP, jdP = j_dlegendre(5, jnp.asarray(x))
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), rtol=1e-13,
                               atol=1e-13)
    np.testing.assert_allclose(dP.numpy(), np.asarray(jdP), rtol=1e-13,
                               atol=1e-13)
    c, s = sincos_m(5, torch.tensor(phi))
    jc, js = j_sincos(5, jnp.asarray(phi))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-13)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-13)


def test_eddington_sample_same_seed():
    """Host NumPy on both sides from one seed: identical samples."""
    mj = j_hernquist(rmin=1e-3, rmax=20.0)
    mp = hernquist_model(rmin=1e-3, rmax=20.0)
    a = sample_spherical_model(mp, 3000, seed=11)
    b = j_sample(mj, 3000, seed=11)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)
