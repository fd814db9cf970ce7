"""K1 and K2 of the port against exp_tpu's Pallas kernels.

The port's plain versions (the code the kernel wrappers take for CPU
tensors) against the JAX SphereSL(backend='pallas') coefficient and force
passes, run in interpret mode on the CPU, on tables carried across with
sph_tables_from_numpy.  Inputs are an equilibrium sample plus edge rows:
the origin, both poles, r > rmax, r < rmin and a zero-mass row; N is not a
multiple of the TPU's 4096-particle block.  The CUDA kernels against
these plain versions on the card: tests/test_torch_gpu.py.
"""

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
from exp_tpu_torch.ops import sphere_kernels as sk


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


N_SAMPLE = 5000


def _edge_rows(rmin, rmax):
    x = np.array([[0.0, 0.0, 0.0],             # origin
                  [0.0, 0.0, 0.7],             # +z pole
                  [0.0, 0.0, -1.3],            # -z pole
                  [30.0, 0.0, 0.0],            # beyond rmax
                  [0.0, -25.0, 10.0],          # beyond rmax, off axis
                  [0.3 * rmin, 0.0, 0.1 * rmin],   # inside rmin
                  [0.3, 0.2, 0.1]])            # zero mass below
    m = np.array([1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 0.0])
    return x, m


@pytest.fixture(scope="module")
def setup():
    m = hernquist_model(rmin=1e-4, rmax=20.0)
    t = build_sph_sl_tables(m, lmax=4, nmax=10, numr=2000, cmap=1, rmap=1.0)
    x, _, mass = sample_spherical_model(m, N_SAMPLE, seed=42)
    ex, em = _edge_rows(t.rmin, t.rmax)
    x = np.concatenate([x, ex]).astype(np.float32)
    mass = np.concatenate([mass, em]).astype(np.float32)
    assert x.shape[0] % 4096 != 0
    tp = sph_tables_from_numpy(dataclasses.asdict(t))
    fj = JSphereSL.from_tables(t, dtype=jnp.float32, backend="pallas")
    fp = SphereSL.from_tables(tp, dtype=torch.float32, backend="pallas",
                              device="cpu")
    cj = np.asarray(fj.coefficients(jnp.asarray(x), jnp.asarray(mass)))
    return m, t, tp, fj, fp, x, mass, cj


def test_k1_plain_matches_jax_pallas(setup):
    """Coefficients: max|d|/max|c| measured 3.0e-8 (f32 sum order);
    gated at 5e-7, 100x tighter than the JAX tests' 5e-5."""
    _, _, _, _, fp, x, mass, cj = setup
    cp = fp.coefficients(torch.from_numpy(x), torch.from_numpy(mass))
    assert cp.dtype == torch.float32 and cp.shape == cj.shape
    rel = np.abs(cp.numpy() - cj).max() / np.abs(cj).max()
    assert rel < 5e-7, rel


def test_k1_zero_mass_and_masked_rows_add_nothing(setup):
    """Rows of zero mass, beyond rmax or inside rmin give exactly zero
    coefficients."""
    _, _, _, _, fp, x, mass, _ = setup
    keep = N_SAMPLE + np.array([3, 4, 5, 6])
    c = fp.coefficients(torch.from_numpy(x[keep]),
                        torch.from_numpy(mass[keep]))
    assert c.abs().max().item() == 0.0


def test_k2_plain_matches_jax_pallas(setup):
    """Force from the same coefficients: acc max|d| measured 1.5e-6
    against |acc| <= 1.4 (rtol 2e-4 / atol 2e-6 hold, 10x tighter than the
    JAX tests' 2e-3 / 2e-5); pot rtol 2e-5 / atol 1e-7 (10x tighter than
    2e-4 / 1e-6)."""
    _, _, _, fj, fp, x, _, cj = setup
    aj, pj = fj.acceleration(jnp.asarray(cj), jnp.asarray(x))
    ap, pp = fp.acceleration(torch.tensor(cj), torch.from_numpy(x))
    assert np.isfinite(ap.numpy()).all() and np.isfinite(pp.numpy()).all()
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), rtol=2e-5,
                               atol=1e-7)


def test_lmax0_custom_fac(setup):
    """Monopole-only tables with a doubled normalization: both passes
    match the JAX kernels, and the coefficients double."""
    m, _, _, _, _, x, mass, _ = setup
    t0 = build_sph_sl_tables(m, lmax=0, nmax=6, numr=400, cmap=1, rmap=1.0)
    fj = JSphereSL.from_tables(t0, dtype=jnp.float32, backend="pallas")
    fp = SphereSL.from_tables(sph_tables_from_numpy(dataclasses.asdict(t0)),
                              backend="pallas", device="cpu")
    fj2 = dataclasses.replace(fj, fac=2.0 * fj.fac)
    fp2 = fp.replace(fac=2.0 * fp.fac)
    xs, ms = x[:1024], mass[:1024]
    c1 = fp.coefficients(torch.from_numpy(xs), torch.from_numpy(ms)).numpy()
    c2 = fp2.coefficients(torch.from_numpy(xs), torch.from_numpy(ms)).numpy()
    cj2 = np.asarray(fj2.coefficients(jnp.asarray(xs), jnp.asarray(ms)))
    np.testing.assert_allclose(c2, 2.0 * c1, rtol=1e-6)
    assert np.abs(c2 - cj2).max() / np.abs(cj2).max() < 5e-7
    aj, pj = fj2.acceleration(jnp.asarray(cj2), jnp.asarray(xs))
    ap, pp = fp2.acceleration(torch.tensor(cj2), torch.from_numpy(xs))
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), rtol=2e-5,
                               atol=1e-7)


@pytest.fixture(scope="module")
def tables_7_11():
    """Port tables at lmax 7 (the first degree where 'auto' takes the
    recurrence kernels) and lmax 11 (the first no kernel is built for)."""
    from exp_tpu_torch.basis.model import hernquist_model as hm
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables as build

    return {L: build(hm(rmin=1e-3, rmax=20.0), lmax=L, nmax=2, numr=200,
                     cmap=1, rmap=1.0) for L in (7, 11)}


@pytest.mark.parametrize("kw,match", [
    (dict(pallas_harmonics="poly", lmax=11), "K6"),
    (dict(pallas_harmonics="recurrence", lmax=11), "K3"),
    (dict(pallas_interp="hat", lmax=11), "hat"),
    (dict(pallas_precision="default"), "default"),
    (dict(pallas_precision="mixed3"), "mixed3"),
])
def test_unported_settings_raise(setup, tables_7_11, kw, match):
    """The pallas backend refuses what no Hopper kernel is built for: any
    lmax above 10, under 'poly' (K1, K6) and 'recurrence' (K3, K2).  The
    same harmonics and interp run at lmax 7, inside those ranges, and
    every setting runs on the XLA-style backends.  The precision knobs 'default'
    and 'mixed3' run on the FP32 kernels (their plain versions here): the
    same values as 'mixed' bit for bit, and exp_tpu's pallas path with the
    same knob (interpret mode) within tests/test_spherical_force.py:297's
    bars, a row's max|da| / |a| < 2e-4 and pot rtol 2e-4 / atol 1e-6."""
    kw = dict(kw)
    lmax = kw.pop("lmax", None)
    tp = setup[2] if lmax is None else tables_7_11[lmax]
    if "pallas_precision" in kw:
        _, t, _, _, fp, x, mass, cj = setup
        f = SphereSL.from_tables(tp, backend="pallas", device="cpu", **kw)
        xt, mt = torch.from_numpy(x), torch.from_numpy(mass)
        assert torch.equal(f.coefficients(xt, mt), fp.coefficients(xt, mt))
        a, p = f.acceleration(torch.tensor(cj), xt[:4096])
        a1, p1 = fp.acceleration(torch.tensor(cj), xt[:4096])
        assert torch.equal(a, a1) and torch.equal(p, p1)
        fj = JSphereSL.from_tables(t, dtype=jnp.float32, backend="pallas",
                                   **kw)
        aj, pj = fj.acceleration(jnp.asarray(cj), jnp.asarray(x[:4096]))
        aj = np.asarray(aj)
        err = (np.abs(a.numpy() - aj).max(1)
               / np.maximum(np.linalg.norm(aj, axis=1), 1e-8))
        assert err.max() < 2e-4, err.max()
        np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=2e-4,
                                   atol=1e-6)
        return
    with pytest.raises(NotImplementedError, match=match):
        SphereSL.from_tables(tp, backend="pallas", device="cpu", **kw)
    # the same settings on the XLA-style backends are not kernel choices
    SphereSL.from_tables(tp, backend="matmul", device="cpu", **kw)
    if lmax is not None:
        inside = setup[2] if lmax == 7 else tables_7_11[7]
        f = SphereSL.from_tables(inside, backend="pallas", device="cpu", **kw)
        x, mass = setup[5][:200], setup[6][:200]
        c = f.coefficients(torch.from_numpy(x), torch.from_numpy(mass))
        a, p = f.acceleration(c, torch.from_numpy(x))
        assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())


def test_lmax_above_6_raises_on_pallas(tables_7_11):
    """At lmax 7 'auto' runs the recurrence kernels K3 and K2, as exp_tpu's
    'auto' does, and an explicit 'poly' runs K1 and K6 (exp_tpu honours it
    at any lmax); above lmax 10 'poly' is refused, naming the kernels'
    range."""
    t = tables_7_11[7]
    f = SphereSL.from_tables(t, backend="pallas", device="cpu")
    assert (f._harmonics_eff("coef"), f._harmonics_eff("accel")) == (
        "recurrence", "recurrence")
    fp = SphereSL.from_tables(t, backend="pallas", device="cpu",
                              pallas_harmonics="poly")
    assert (fp._harmonics_eff("coef"), fp._harmonics_eff("accel")) == (
        "poly", "poly")
    with pytest.raises(NotImplementedError,
                       match=r"lmax=11 .*K1 and K6 are built for lmax 0\.\.10"):
        SphereSL.from_tables(tables_7_11[11], backend="pallas", device="cpu",
                             pallas_harmonics="poly")


def test_precision_argument_checks(setup):
    tp = setup[2]
    with pytest.raises(ValueError, match="pallas_precision"):
        SphereSL.from_tables(tp, backend="pallas", device="cpu",
                             pallas_precision="mixed-3")
    with pytest.raises(ValueError, match="recurrence"):
        SphereSL.from_tables(tp, backend="pallas", device="cpu",
                             pallas_precision="mixed3",
                             pallas_harmonics="poly")
    SphereSL.from_tables(tp, backend="pallas", device="cpu",
                         pallas_precision="highest")


def test_wrappers_take_plain_version_only_on_cpu(setup):
    """On a CPU tensor each wrapper returns its plain version's result and
    counts no kernel launch."""
    _, _, _, _, fp, x, mass, cj = setup
    prm = fp._kernel_params()
    xs, ms = torch.from_numpy(x[:500]), torch.from_numpy(mass[:500])
    sk.reset_launch_counts()
    c = sk.sphere_coef(xs, ms, fp.tabc_s, fp.Mp, prm)
    torch.testing.assert_close(
        c, sk.sphere_coef_plain(xs, ms, fp.tabc_s, fp.Mp, prm), rtol=0, atol=0)
    twT = sk.contract_coef_table2(torch.tensor(cj), fp.tabc_s, fp.tabd_s,
                                  fp.prows)
    a, p = sk.sphere_accel(xs, twT, fp.fac32, prm)
    a0, p0 = sk.sphere_accel_plain(xs, twT, fp.fac32, prm)
    torch.testing.assert_close(a, a0, rtol=0, atol=0)
    torch.testing.assert_close(p, p0, rtol=0, atol=0)
    assert sk.launch_counts == {"sphere_coef": 0, "sphere_accel": 0,
                                "sphere_coef_rec": 0, "sphere_accel_poly": 0}


def test_cmap2_refused_on_pallas():
    """exp_tpu's sphere kernels map xi = r/scale for any cmap other than 1
    (pallas_sphere.py:129-132), so with log-mapped (cmap=2) tables its
    pallas backend is wrong: coefficients 53% off the gather backend
    (max|d|/max|c|, lmax=2, nmax=6, 2000 particles; measured here).  The
    port's kernels take cmap 0 and 1 only, and its pallas backend refuses
    cmap=2 rather than copy the fault."""
    m = hernquist_model(rmin=1e-3, rmax=20.0)
    t = build_sph_sl_tables(m, lmax=2, nmax=6, numr=1000, cmap=2, rmap=1.0)
    x, _, ms = sample_spherical_model(m, 2000, seed=1)
    fg = JSphereSL.from_tables(t, dtype=jnp.float64, backend="gather")
    fj = JSphereSL.from_tables(t, dtype=jnp.float32, backend="pallas")
    cg = np.asarray(fg.coefficients(jnp.asarray(x), jnp.asarray(ms),
                                    accum_dtype=jnp.float64))
    cj = np.asarray(fj.coefficients(jnp.asarray(x, jnp.float32),
                                    jnp.asarray(ms, jnp.float32)))
    assert np.abs(cj - cg).max() / np.abs(cg).max() > 0.1
    tp = sph_tables_from_numpy(dataclasses.asdict(t))
    with pytest.raises(NotImplementedError, match="cmap=2"):
        SphereSL.from_tables(tp, backend="pallas", device="cpu")
    fp = SphereSL.from_tables(tp, dtype=torch.float64, backend="gather",
                              device="cpu")
    cp = fp.coefficients(torch.tensor(x), torch.tensor(ms),
                         accum_dtype=torch.float64).numpy()
    assert np.abs(cp - cg).max() / np.abs(cg).max() < 1e-12
