"""The port's KDK step of the periodic cube against exp_tpu's:
init_force_state + 5 steps on the initial conditions of
tests/test_cube_force.py::test_cube_nbody_run (sample_cube(2000, sigma=1.2,
seed=4), nmax 4), with the einsum backend in f64 and the pallas backend in
f32 (the JAX kernels in interpret mode, the port's plain versions).  The
coefficients are complex; the step's diagnostics read only real tensors."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.forces.cube import Cube as JCube
from exp_tpu.ic.cubeics import sample_cube as j_sample_cube
from exp_tpu.nbody.particles import ParticleSystem as JParticleSystem
from exp_tpu.nbody.step import energies as j_energies
from exp_tpu.nbody.step import init_force_state as j_init
from exp_tpu.nbody.step import make_kdk_step as j_make_step

from exp_tpu_torch.bench_cube import DT, N, NMAX, PERTURBED, cube_sample
from exp_tpu_torch.bench_sphere import kdk_run
from exp_tpu_torch.forces.cube import Cube
from exp_tpu_torch.ic.cubeics import sample_cube
from exp_tpu_torch.nbody.particles import ParticleSystem
from exp_tpu_torch.nbody.step import energies, init_force_state, make_kdk_step


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


STEPS = 5
STEP_DT = 0.005          # test_cube_nbody_run's dtime


@pytest.fixture(scope="module")
def ics():
    return sample_cube(2000, sigma=1.2, seed=4)


def _run_both(x, v, mass, jdtype, tdtype, **kw):
    fj = JCube.create(4, 4, 4, dtype=jdtype, **kw)
    fp = Cube.create(4, 4, 4, dtype=tdtype, device="cpu", **kw)
    pj = JParticleSystem.from_arrays(x, v, mass, dtype=jdtype)
    pj, _, dj = j_init(fj, pj, accum_dtype=jdtype)
    pp = ParticleSystem.from_arrays(x, v, mass, dtype=tdtype, device="cpu")
    pp, _, dp = init_force_state(fp, pp, accum_dtype=tdtype)
    step_j = j_make_step(fj, STEP_DT, accum_dtype=jdtype)
    step_p = make_kdk_step(fp, STEP_DT, accum_dtype=tdtype)
    for _ in range(STEPS):
        pj, cj, dj = step_j(pj)
        pp, cp, dp = step_p(pp)
    return pj, cj, dj, pp, cp, dp


def test_cube_kdk_einsum_f64_matches_jax(ics):
    """5 steps in f64 on the einsum backend: the same arithmetic, measured
    max relative differences 1.1e-15; gated at 1e-11.  The coefficients are
    complex128 and every diagnostic matches."""
    pj, cj, dj, pp, cp, dp = _run_both(*ics, jnp.float64, torch.float64)
    assert cp.dtype == torch.complex128
    for a, b in ((pp.x, pj.x), (pp.v, pj.v), (pp.acc, pj.acc),
                 (pp.pot, pj.pot), (cp, cj)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-11 * np.abs(b).max()
    ej, ep = j_energies(dj), energies(dp)
    for k in ("KE", "PE", "VC", "Etot"):
        assert ep[k] == pytest.approx(ej[k], rel=1e-11), k
    np.testing.assert_allclose(dp["mom"].numpy(), np.asarray(dj["mom"]),
                               atol=1e-14)


@pytest.mark.parametrize("version", [2, 1])
def test_cube_kdk_pallas_matches_jax(ics, version):
    """5 steps in f32 on the pallas backend (v2 and v1): measured max|dx|
    1.2e-7 (|x| up to 1.15), max|dv| 4.8e-7 (|v| up to 4.6), the
    acceleration 1.6e-6 and the potential 6.7e-7 of their scales, the
    coefficients 5.8e-7 of max|c|, the energies 3.3e-7 relative; gated at
    rtol 2e-5 / atol 2e-6 (the sphere and disk step tests' bar), 2e-5 of
    the acceleration and coefficient scales and 1e-5 relative on the
    energies."""
    pj, cj, dj, pp, cp, dp = _run_both(*ics, jnp.float32, torch.float32,
                                       backend="pallas",
                                       pallas_version=version)
    assert cp.dtype == torch.complex64
    for a, b in ((pp.x, pj.x), (pp.v, pj.v), (pp.pot, pj.pot)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-6)
    ascale = float(jnp.abs(pj.acc).max())
    assert float(np.abs(pp.acc.numpy() - np.asarray(pj.acc)).max()) \
        < 2e-5 * ascale
    c = np.asarray(cj)
    assert np.abs(cp.numpy() - c).max() < 2e-5 * np.abs(c).max()
    ej, ep = j_energies(dj), energies(dp)
    for k in ("KE", "PE", "VC", "Etot"):
        assert ep[k] == pytest.approx(ej[k], rel=1e-5), k


def test_bench_cube_samples_are_the_bench_suites():
    """cube_sample draws bench_suite.bench_cube's population
    (sample_cube(n, seed=5)) and the perturbed one of the KDK run, bit for
    bit; the bench's configuration is N = 4,194,304, nmax 6, dt 1e-3."""
    for pert in (False, True):
        kw = PERTURBED if pert else {}
        for a, b in zip(cube_sample(3000, perturbed=pert),
                        j_sample_cube(3000, seed=5, **kw)):
            np.testing.assert_array_equal(a, b)
    assert (N, NMAX, DT) == (4_194_304, 6, 1e-3)


def test_kdk_run_reports_energy_and_momentum():
    """bench_cube's KDK run (the perturbed sample) on the CPU at 3000
    particles, pallas backend, 10 steps: finite, |dE/E| measured 1.5e-6
    and the momentum change 6.7e-10 (the initial sum m v is 0 in f64,
    4e-10 in f32); gated at 1e-5 and 1e-7."""
    x, v, m = cube_sample(3000, perturbed=True)
    f = Cube.create(NMAX, NMAX, NMAX, backend="pallas", device="cpu")
    out = kdk_run(f, x, v, m, steps=10, dt=DT, device="cpu")
    assert out["finite"] and out["n"] == 3000
    assert out["PE0"] < 0 < out["KE0"]
    assert out["dE_rel"] < 1e-5
    assert out["dP"] < 1e-7 and out["P1"] < 1e-7
