"""The port's KDK step of the disk against exp_tpu's: init_force_state + a
few steps on the same initial conditions (the disk bench's sample and
velocities at a small N), with the pallas backend in f32 (the JAX kernels in
interpret mode, the port's plain versions) and the xla backend in f64, and
the disk bench's host pieces against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.empcyl import build_empcyl_tables
from exp_tpu.forces.cylinder import CylinderForce as JCylinderForce
from exp_tpu.ic.disk import disk_velocities as j_vel
from exp_tpu.ic.disk import sample_exponential_disk as j_disk
from exp_tpu.nbody.particles import ParticleSystem as JParticleSystem
from exp_tpu.nbody.step import energies as j_energies
from exp_tpu.nbody.step import init_force_state as j_init
from exp_tpu.nbody.step import make_kdk_step as j_make_step

from exp_tpu_torch.bench_disk import DT, disk_sample
from exp_tpu_torch.bench_sphere import kdk_run
from exp_tpu_torch.convert import cyl_tables_from_numpy
from exp_tpu_torch.forces.cylinder import CylinderForce
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


N = 2000
STEPS = 5


@pytest.fixture(scope="module")
def disk():
    t = build_empcyl_tables(mmax=4, nmax=8, lmaxfid=24, nmaxfid=16,
                            acyl=0.01, hcyl=0.002, numx=128, numy=64,
                            rnum=100, tnum=40, cachename=None)
    x, v, mass = disk_sample(N)
    return t, cyl_tables_from_numpy(dataclasses.asdict(t)), x, v, mass


def test_bench_disk_sample_is_the_bench_suites():
    """disk_sample draws bench_suite.bench_disk's population: the same
    sampler and velocities with the same arguments, bit for bit."""
    x, v, mass = disk_sample(3000)
    xj, mj = j_disk(3000, acyl=0.01, hcyl=0.002, mass=0.05, seed=2)
    vj = j_vel(xj, lambda R: np.sqrt(0.05 * R * R / (R * R + 0.01 ** 2)
                                     ** 1.5), acyl=0.01)
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(mass, mj)
    assert DT == 1e-4


def _run_both(t, tp, x, v, mass, jdtype, tdtype, **kw):
    fj = JCylinderForce.from_tables(t, dtype=jdtype, **kw)
    fp = CylinderForce.from_tables(tp, dtype=tdtype, device="cpu", **kw)
    pj = JParticleSystem.from_arrays(x, v, mass, dtype=jdtype)
    pj, _, dj = j_init(fj, pj, accum_dtype=jdtype)
    pp = ParticleSystem.from_arrays(x, v, mass, dtype=tdtype, device="cpu")
    pp, _, dp = init_force_state(fp, pp, accum_dtype=tdtype)
    step_j = j_make_step(fj, DT, accum_dtype=jdtype)
    step_p = make_kdk_step(fp, DT, accum_dtype=tdtype)
    for _ in range(STEPS):
        pj, cj, dj = step_j(pj)
        pp, cp, dp = step_p(pp)
    return pj, cj, dj, pp, cp, dp


def test_disk_kdk_pallas_matches_jax(disk):
    """5 steps at dt=1e-4, f32, pallas backend ('spline', ncx=32): measured
    max|dx| 1.9e-9 (|x| up to 0.09), max|dv| 2.4e-7 (|v| up to 1.8),
    max|da| 7.8e-7 and the potential 4.1e-7 of their scales, the
    coefficients 1.9e-7, Etot 7.1e-7 and Lz 1.0e-7 relative; gated at
    rtol 2e-5 / atol 2e-6 (the sphere step test's bar), 2e-5 of the
    acceleration scale, the coefficients at 5e-6 relative, the energies
    and Lz at 1e-5 relative."""
    t, tp, x, v, mass = disk
    pj, cj, dj, pp, cp, dp = _run_both(t, tp, x, v, mass, jnp.float32,
                                       torch.float32, backend="pallas",
                                       ncx=32)
    for a, b in ((pp.x, pj.x), (pp.v, pj.v), (pp.pot, pj.pot)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-6)
    ascale = float(jnp.abs(pj.acc).max())
    assert float(np.abs(pp.acc.numpy() - np.asarray(pj.acc)).max()) \
        < 2e-5 * ascale
    c = np.asarray(cj)
    assert np.abs(cp.numpy() - c).max() / np.abs(c).max() < 5e-6
    ej, ep = j_energies(dj), energies(dp)
    for k in ("KE", "PE", "VC", "Etot"):
        assert ep[k] == pytest.approx(ej[k], rel=1e-5), k
    assert float(dp["L"][2]) == pytest.approx(float(dj["L"][2]), rel=1e-5)


def test_disk_kdk_xla_f64_matches_jax(disk):
    """5 steps at dt=1e-4 in f64 on the xla backend: the same arithmetic,
    measured max relative differences 1.7e-15 (acceleration) and below;
    gated at 1e-11."""
    t, tp, x, v, mass = disk
    pj, cj, dj, pp, cp, dp = _run_both(t, tp, x, v, mass, jnp.float64,
                                       torch.float64, backend="xla")
    for a, b in ((pp.x, pj.x), (pp.v, pj.v), (pp.acc, pj.acc),
                 (pp.pot, pj.pot), (cp, cj)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-11 * np.abs(b).max()
    ej, ep = j_energies(dj), energies(dp)
    assert ep["Etot"] == pytest.approx(ej["Etot"], rel=1e-11)


def test_kdk_run_reports_energy_and_lz(disk):
    """bench_disk's kdk run on the CPU at a small N: finite state, Lz and
    its change reported; over 10 steps |dLz/Lz| measured 0 and |dE/E|
    4.6e-5 (the 1M-particle run: 2.0e-7 and 6.8e-5 over 50 steps); gated
    at 1e-5 and 1e-4."""
    _, tp, x, v, mass = disk
    f = CylinderForce.from_tables(tp, backend="pallas", device="cpu")
    out = kdk_run(f, x, v, mass, steps=10, dt=DT, device="cpu")
    assert out["finite"] and out["n"] == N
    assert out["Lz0"] > 0
    assert out["dLz_rel"] < 1e-5
    assert out["dE_rel"] < 1e-4
