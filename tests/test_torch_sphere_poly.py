"""K1 and K6 above lmax 6 (the 'poly' harmonics at lmax 7 and 8), against
exp_tpu; lmax 10 is in tests/test_torch_sphere_poly10.py, which imports
this module's test, so that two test workers share them.

exp_tpu honours an explicit pallas_harmonics='poly' at any lmax
(exp_tpu/forces/spherical.py _harmonics_eff); the port's K1 and K6 are
built for lmax 0..10.  The port's plain versions (what the wrappers take
for CPU tensors) run against the JAX force's Pallas kernels
(make_coef_kernel_poly, make_accel_kernel_poly) in interpret mode, on the
same f32 tables carried across with sph_tables_from_numpy and a seeded
2,048-row numpy sample, under 'spline' and 'hat':

* against exp_tpu's poly kernels at the port's own K1 / K6 gates at lmax
  4-6 (tests/test_torch_sphere_variants.py): coefficients max|d|/max|c| <
  5e-7, acc at ACC_TOL, pot rtol 2e-5 / atol 1e-7;
* against exp_tpu's 'recurrence' at tests/test_spherical_force.py:228-235's
  gates: coefficients 5e-5 of max|c|, acc rtol 2e-3 / atol 2e-5, pot rtol
  1e-4 / atol 1e-6.

`-rP` prints each measured difference.  The CUDA kernels against these
plain versions on the card: chip_smoke.py's V2 (poly10, hat+poly10,
hat6-2000).  exp_tpu's fit of the harmonic matrix leaves f64 noise outside
the rows' parity pattern at lmax 10 (under 3e-14 of a row's largest); the
port's poly_matrix sets it to 0 (ops/sphere_kernels._harmonic_rows).
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


N = 2048
#: acc (rtol, atol) against exp_tpu's poly kernels: the port's K6 gates at
#: lmax 4-6 (tests/test_torch_sphere_variants.py ACC_TOL)
ACC_TOL = {"spline": (2e-4, 2e-6), "hat": (2e-3, 2e-5)}
CASES = [(L, interp) for L in (7, 8) for interp in ("spline", "hat")]


@pytest.fixture(scope="module")
def sample():
    """2,048 rows of a Hernquist-like halo (r = u / (1 - u), isotropic)
    from numpy's seeded generator, f32."""
    rng = np.random.default_rng(2207)
    u = rng.uniform(0.02, 0.98, N)
    r = u / (1 - u)
    ct = rng.uniform(-1, 1, N)
    st = np.sqrt(1 - ct * ct)
    ph = rng.uniform(0, 2 * np.pi, N)
    x = np.stack([r * st * np.cos(ph), r * st * np.sin(ph), r * ct], -1)
    return x.astype(np.float32), np.full(N, 1.0 / N, np.float32)


_TABLES = {}


def _tables(L):
    """exp_tpu's tables at lmax L and the port's copy of them."""
    if L not in _TABLES:
        t = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=L,
                                nmax=6, numr=400, cmap=1, rmap=1.0)
        _TABLES[L] = (t, sph_tables_from_numpy(dataclasses.asdict(t)))
    return _TABLES[L]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("L,interp", CASES)
def test_poly_plain_matches_jax_pallas_above_lmax6(sample, L, interp):
    """The port's plain K1 and K6 against exp_tpu's poly kernels (interpret
    mode) at the port's lmax 4-6 gates, and against exp_tpu's recurrence
    kernels at tests/test_spherical_force.py:228-235's; the force on the
    exp_tpu poly coefficients in both packages.  Measured (this sample,
    lmax 7 / 8 / 10): coefficients 1.9e-7 ('spline') and 2.7e-7 ('hat') of
    max|c| against either kernel; acc max|d| against poly 4.8e-6 / 3.8e-6
    / 6.7e-6 ('spline') and 3.0e-5 / 1.5e-4 / 3.2e-5 ('hat', its cell
    difference), |a| up to 12.5; pot max|d| under 1.7e-6 against poly and
    2.2e-6 against recurrence."""
    x, m = sample
    t, tp = _tables(L)
    kw = {"pallas_interp": interp, "numr_c": 256} if interp == "hat" else {}
    fj = JSphereSL.from_tables(t, dtype=jnp.float32, backend="pallas",
                               pallas_harmonics="poly", **kw)
    fr = JSphereSL.from_tables(t, dtype=jnp.float32, backend="pallas",
                               pallas_harmonics="recurrence", **kw)
    fp = SphereSL.from_tables(tp, backend="pallas", device="cpu",
                              pallas_harmonics="poly", **kw)
    assert (fp._harmonics_eff("coef"), fp._harmonics_eff("accel"),
            fp._interp_eff) == ("poly", "poly", interp)

    cj = np.asarray(fj.coefficients(jnp.asarray(x), jnp.asarray(m)))
    cr = np.asarray(fr.coefficients(jnp.asarray(x), jnp.asarray(m)))
    cp = fp.coefficients(torch.from_numpy(x), torch.from_numpy(m)).numpy()
    aj, pj = (np.asarray(v) for v in fj.acceleration(jnp.asarray(cj),
                                                      jnp.asarray(x)))
    ar, pr_ = (np.asarray(v) for v in fr.acceleration(jnp.asarray(cj),
                                                       jnp.asarray(x)))
    ap, pp = (v.numpy() for v in fp.acceleration(torch.tensor(cj),
                                                  torch.from_numpy(x)))
    print(f"lmax {L} {interp}: coefficients vs poly {_rel(cp, cj):.2e}, vs "
          f"recurrence {_rel(cp, cr):.2e} (exp_tpu's poly {_rel(cj, cr):.2e});"
          f" acc max|d| vs poly {np.abs(ap - aj).max():.2e}, vs recurrence "
          f"{np.abs(ap - ar).max():.2e} (|a| up to {np.abs(aj).max():.2e}); "
          f"pot max|d| vs poly {np.abs(pp - pj).max():.2e}, vs recurrence "
          f"{np.abs(pp - pr_).max():.2e}")
    assert np.isfinite(cp).all() and np.isfinite(ap).all()
    assert _rel(cp, cj) < 5e-7
    rtol, atol = ACC_TOL[interp]
    np.testing.assert_allclose(ap, aj, rtol=rtol, atol=atol)
    np.testing.assert_allclose(pp, pj, rtol=2e-5, atol=1e-7)
    assert _rel(cp, cr) < 5e-5
    np.testing.assert_allclose(ap, ar, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(pp, pr_, rtol=1e-4, atol=1e-6)


DRIVER = """\
Global:
  dtime: 0.005
  nsteps: 3
  runtag: prun
  outdir: {out}
Components:
  - name: halo
    bodyfile: halo.bods
    force:
      id: sphereSL
      parameters: {{numr: 400, Lmax: 8, nmax: 6, rmapping: 1.0,
                   modelname: halo.model, backend: pallas,
                   pallas_harmonics: poly}}
Output:
  - id: outlog
    parameters: {{nint: 1}}
"""


def test_yaml_driver_poly_lmax8_matches_exp_tpu(tmp_path):
    """The YAML driver, single-rate, 3 KDK steps of 2,000 f32 bodies under
    a sphereSL with `backend: pallas, pallas_harmonics: poly` at Lmax 8:
    the port's (K1 and K6's plain versions) against exp_tpu's (its poly
    kernels in interpret mode) on the same files: OUTLOG to rtol 1e-5 /
    atol 1e-6 and the coefficients to 1e-5 of their largest, the port's
    f32 driver gates (tests/test_torch_simulation.py F32_LOG, F32_COEF)."""
    from exp_tpu.ic.eddington import sample_spherical_model
    from exp_tpu.nbody.particles import write_ascii_bodies
    from exp_tpu.nbody.simulation import Simulation as JSim

    from exp_tpu_torch.bench_extras import outlog_rows
    from exp_tpu_torch.nbody.simulation import Simulation

    m = hernquist_model(rmin=1e-4, rmax=20.0, numr=800)
    m.to_file(tmp_path / "halo.model")
    write_ascii_bodies(tmp_path / "halo.bods",
                       sample_spherical_model(m, 2000, seed=5))
    sims = {}
    for who, cls in (("j", JSim), ("t", Simulation)):
        cfg = tmp_path / f"{who}.yml"
        cfg.write_text(DRIVER.format(out=f"{who}_out"))
        kw = {} if who == "j" else {"device": "cpu"}
        sims[who] = cls.from_file(str(cfg), **kw)
        sims[who].run()
    assert sims["t"].components["halo"].force._harmonics_eff("accel") == "poly"
    lj, lt = (outlog_rows(str(tmp_path / f"{w}_out" / "OUTLOG.prun"))
              for w in ("j", "t"))
    assert lt.shape == lj.shape and lt.shape[0] == 4
    assert np.isfinite(lt).all()
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-6)
    cj, ct = (np.asarray(sims[w]._coefs["halo"]) for w in ("j", "t"))
    assert _rel(ct, cj) < 1e-5
