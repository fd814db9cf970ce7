"""The port's TwoCenterForce against exp_tpu's, and tests/test_twocenter.py's
lopsided-system bar on the port: the mixture, both coefficient sets and
the summed field in f64 to 1e-12 of the largest value (EXACT: the sums run
in another order), on the same SL tables and particles."""

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
from exp_tpu.forces.twocenter import TwoCenterForce as JTwoCenter
from exp_tpu.ic.eddington import sample_spherical_model

from exp_tpu_torch.convert import sph_tables_from_numpy
from exp_tpu_torch.forces.direct import DirectForce
from exp_tpu_torch.forces.spherical import SphereSL
from exp_tpu_torch.forces.twocenter import TwoCenterForce


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


EXACT = 1e-12
F64 = torch.float64


def close(t, j, tol=EXACT):
    """max|t - j| <= tol max|j|."""
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= tol * np.abs(j).max()


@pytest.fixture(scope="module")
def lopsided():
    """tests/test_twocenter.py:39's system: a compact Hernquist cusp
    (a 0.2, M 0.5; 4,000 bodies) offset by 1.5 inside an envelope (a 2.0,
    M 1.0; 6,000 bodies), and lmax 4, nmax 10 tables of a Hernquist
    model on 1,000 nodes, carried to the port."""
    mc = hernquist_model(a=0.2, M=0.5, rmin=1e-4, rmax=4.0, numr=600)
    xc, _, mass_c = sample_spherical_model(mc, 4000, seed=7)
    me = hernquist_model(a=2.0, M=1.0, rmin=1e-3, rmax=40.0, numr=800)
    xe, _, mass_e = sample_spherical_model(me, 6000, seed=8)
    off = np.array([1.5, 0.0, 0.0])
    x = np.concatenate([xc + off, xe])
    mass = np.concatenate([mass_c, mass_e])
    com = (mass[:, None] * x).sum(0) / mass.sum()
    m = hernquist_model(rmin=1e-4, rmax=50.0, numr=1000)
    t = build_sph_sl_tables(m, lmax=4, nmax=10, numr=1000, cmap=1, rmap=1.0)
    return x, mass, off, com, t, sph_tables_from_numpy(dataclasses.asdict(t))


def _pair(t, tp, c1, c2, **kw):
    fj = JTwoCenter(inner=JSphereSL.from_tables(t, dtype=jnp.float64),
                    outer=JSphereSL.from_tables(t, dtype=jnp.float64),
                    c1=jnp.asarray(c1), c2=jnp.asarray(c2), **kw)
    fp = TwoCenterForce(
        inner=SphereSL.from_tables(tp, dtype=F64, device="cpu"),
        outer=SphereSL.from_tables(tp, dtype=F64, device="cpu"),
        c1=torch.tensor(c1), c2=torch.tensor(c2), **kw)
    return fj, fp


@pytest.mark.parametrize("cfac,alpha", [(1.0, 2.0), (0.5, 1.0)])
def test_twocenter_matches_exp_tpu(lopsided, cfac, alpha):
    """mixture, the (inner, outer) coefficient pair, the summed
    acceleration and potential, and the density, in f64."""
    x, mass, off, com, t, tp = lopsided
    fj, fp = _pair(t, tp, off, com, cfac=cfac, alpha=alpha)
    close(fp.mixture(torch.tensor(x)), fj.mixture(jnp.asarray(x)))
    cj = fj.coefficients(jnp.asarray(x), jnp.asarray(mass),
                         accum_dtype=jnp.float64)
    cp = fp.coefficients(torch.tensor(x), torch.tensor(mass),
                         accum_dtype=F64)
    assert isinstance(cp, tuple) and len(cp) == 2
    assert fp.coef_shape == tuple(c.shape for c in cp)
    for a, b in zip(cp, cj):
        close(a, b)
    pts = x[::13]
    aj, pj = fj.acceleration(cj, jnp.asarray(pts))
    ap, pp = fp.acceleration(cp, torch.tensor(pts))
    close(ap, aj)
    close(pp, pj)
    close(fp.density(cp, torch.tensor(pts)), fj.density(cj, jnp.asarray(pts)))
    moved = fp.with_centers(torch.tensor(com), torch.tensor(off))
    assert moved.inner is fp.inner and torch.equal(moved.c1,
                                                   torch.tensor(com))


def test_lopsided_system_force_accuracy(lopsided):
    """tests/test_twocenter.py:39 on the port: TwoCenter (inner = the
    cusp's center, outer = the COM) beats one COM-centered expansion
    against the direct sum (the port's DirectForce, plummer eps 1e-3,
    f64): < 0.3 x single in the cusp and < 0.1, < 1.2 x single in the
    envelope (median relative force errors on 150 + 150 points)."""
    x, mass, off, com, _, tp = lopsided
    xt, mt = torch.tensor(x), torch.tensor(mass)
    single = SphereSL.from_tables(tp, dtype=F64, device="cpu")
    cs = single.coefficients(xt - torch.tensor(com), mt, accum_dtype=F64)
    tc = TwoCenterForce(
        inner=SphereSL.from_tables(tp, dtype=F64, device="cpu"),
        outer=SphereSL.from_tables(tp, dtype=F64, device="cpu"),
        c1=torch.tensor(off), c2=torch.tensor(com), cfac=1.0, alpha=2.0)
    ct = tc.coefficients(xt, mt, accum_dtype=F64)
    direct = DirectForce(eps=1e-3, kernel="plummer")
    rng = np.random.default_rng(2)
    regions = {"cusp": off + rng.normal(0, 0.3, (150, 3)),
               "env": rng.normal(0, 2.0, (150, 3))}
    errs = {}
    for name, pts in regions.items():
        p = torch.tensor(pts)
        a_ref, _ = direct.acceleration((xt, mt), p)
        scale = torch.linalg.norm(a_ref, dim=1)
        a1, _ = single.acceleration(cs, p - torch.tensor(com))
        a2, _ = tc.acceleration(ct, p)
        errs[name] = [float(np.median((torch.linalg.norm(a - a_ref, dim=1)
                                       / scale).numpy())) for a in (a1, a2)]
    e1c, e2c = errs["cusp"]
    assert e2c < 0.3 * e1c, f"cusp: twocenter {e2c:.4f} vs single {e1c:.4f}"
    assert e2c < 0.1, f"cusp twocenter error too large: {e2c:.4f}"
    e1e, e2e = errs["env"]
    assert e2e < 1.2 * e1e, f"env: twocenter {e2e:.4f} vs single {e1e:.4f}"
