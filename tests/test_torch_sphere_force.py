"""The port's 'gather' and 'matmul' SphereSL backends against exp_tpu's, on
the same tables (carried across with sph_tables_from_numpy) and the same
particles, in f64 and f32; plus the BFE density."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.model import hernquist_model
from exp_tpu.basis.slgrid import build_sph_sl_tables
from exp_tpu.forces.spherical import SphereSL as JSphereSL
from exp_tpu.ic.eddington import sample_spherical_model

from exp_tpu_torch.convert import sph_tables_from_numpy
from exp_tpu_torch.forces.spherical import SphereSL


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


DT = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
# (coef max|d|/max|c|, acc rtol, acc atol, pot rtol, pot atol)
TOL = {"f64": (1e-12, 1e-10, 1e-13, 1e-11, 1e-14),
       "f32": (5e-6, 2e-4, 2e-6, 2e-5, 1e-7)}


@pytest.fixture(scope="module")
def setup():
    m = hernquist_model(rmin=1e-4, rmax=20.0)
    t = build_sph_sl_tables(m, lmax=4, nmax=10, numr=2000, cmap=1, rmap=1.0)
    x, _, mass = sample_spherical_model(m, 4000, seed=42)
    x = np.concatenate([x, [[0.0, 0.0, 0.0], [0.0, 0.0, 0.5],
                            [30.0, 0.0, 0.0], [0.0, 3e-5, 0.0]]])
    mass = np.concatenate([mass, [1e-4, 1e-4, 1e-4, 1e-4]])
    return t, sph_tables_from_numpy(dataclasses.asdict(t)), x, mass


def _pair(setup, prec, **kw):
    t, tp, x, mass = setup
    jd, td = DT[prec]
    fj = JSphereSL.from_tables(t, dtype=jd, **kw)
    fp = SphereSL.from_tables(tp, dtype=td, device="cpu", **kw)
    return fj, fp, (jnp.asarray(x, jd), jnp.asarray(mass, jd)), (
        torch.tensor(x, dtype=td), torch.tensor(mass, dtype=td))


def _compare(fj, fp, xj, xp, prec, accum):
    """f64 measured at roundoff (coef ~1e-15 relative, acc ~1e-14);
    f32 coef 2e-7, acc max|d| 1e-6, pot 1e-7 relative."""
    ctol, art, aat, prt, pat = TOL[prec]
    cj = np.asarray(fj.coefficients(*xj, accum_dtype=accum[0]))
    cp = fp.coefficients(*xp, accum_dtype=accum[1]).numpy()
    assert np.abs(cp - cj).max() / np.abs(cj).max() < ctol
    aj, pj = fj.acceleration(jnp.asarray(cj), xj[0])
    ap, pp = fp.acceleration(torch.tensor(cj), xp[0])
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=art, atol=aat)
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), rtol=prt, atol=pat)
    return cj


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_gather_backend(setup, prec):
    fj, fp, xj, xp = _pair(setup, prec, backend="gather")
    _compare(fj, fp, xj, xp, prec, DT[prec])


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("chunk", [65536, 1001])
def test_matmul_backend(setup, prec, chunk):
    """chunk=1001 divides N = 4004, so both packages take their chunked
    paths."""
    fj, fp, xj, xp = _pair(setup, prec, backend="matmul", numr_c=512,
                           chunk=chunk)
    _compare(fj, fp, xj, xp, prec, DT[prec])


@pytest.mark.parametrize("deriv", ["stencil3", "lerp"])
def test_gather_deriv_modes(setup, deriv):
    fj, fp, xj, xp = _pair(setup, "f64", backend="gather")
    cj = fj.coefficients(*xj, accum_dtype=jnp.float64)
    aj, _ = fj.acceleration(cj, xj[0], deriv=deriv)
    ap, _ = fp.acceleration(torch.tensor(np.asarray(cj)), xp[0], deriv=deriv)
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=1e-10,
                               atol=1e-13)


def test_density(setup):
    fj, fp, xj, xp = _pair(setup, "f64", backend="gather")
    cj = fj.coefficients(*xj, accum_dtype=jnp.float64)
    pts = xj[0][:300]
    dj = np.asarray(fj.density(cj, pts))
    dp = fp.density(torch.tensor(np.asarray(cj)), xp[0][:300]).numpy()
    np.testing.assert_allclose(dp, dj, rtol=1e-10, atol=1e-14)


def test_scaled_force(setup):
    """scale != 1 (the continuation derivative wrt the scaled radius)."""
    fj, fp, xj, xp = _pair(setup, "f64", backend="gather", scale=2.0)
    _compare(fj, fp, (xj[0] * 2.0, xj[1]), (xp[0] * 2.0, xp[1]), "f64",
             DT["f64"])
