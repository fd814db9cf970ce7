"""The port's KDK step against exp_tpu's: init_force_state + 10 steps on the
same initial conditions with the pallas backend in f32 (the JAX kernels in
interpret mode, the port's plain versions), and the energy and virial bar
of an equilibrium halo on the port alone (f64 'gather')."""

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
from exp_tpu.nbody.particles import ParticleSystem as JParticleSystem
from exp_tpu.nbody.step import energies as j_energies
from exp_tpu.nbody.step import init_force_state as j_init
from exp_tpu.nbody.step import make_kdk_step as j_make_step

from exp_tpu_torch.convert import sph_tables_from_numpy
from exp_tpu_torch.forces.spherical import SphereSL
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


@pytest.fixture(scope="module")
def halo():
    m = hernquist_model(rmin=1e-4, rmax=20.0)
    t = build_sph_sl_tables(m, lmax=4, nmax=10, numr=2000, cmap=1, rmap=1.0)
    x, v, mass = sample_spherical_model(m, 3000, seed=5)
    return t, sph_tables_from_numpy(dataclasses.asdict(t)), x, v, mass


def test_kdk_trajectory_matches_jax(halo):
    """10 steps at dt=0.01 (f32, pallas backend): positions agree to
    measured max|dx| 2e-7 (|x| up to ~20), velocities 1e-6; gated at
    rtol 2e-5 / atol 2e-6 and the energies at 1e-5 relative."""
    t, tp, x, v, mass = halo
    dt = 0.01
    fj = JSphereSL.from_tables(t, dtype=jnp.float32, backend="pallas")
    fp = SphereSL.from_tables(tp, dtype=torch.float32, backend="pallas",
                              device="cpu")
    pj = JParticleSystem.from_arrays(x, v, mass, dtype=jnp.float32)
    pj, _, dj = j_init(fj, pj)
    pp = ParticleSystem.from_arrays(x, v, mass, device="cpu")
    pp, _, dp = init_force_state(fp, pp)
    step_j = j_make_step(fj, dt)
    step_p = make_kdk_step(fp, dt)
    for _ in range(10):
        pj, cj, dj = step_j(pj)
        pp, cp, dp = step_p(pp)
    for a, b in ((pp.x, pj.x), (pp.v, pj.v), (pp.acc, pj.acc),
                 (pp.pot, pj.pot)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-6)
    c = np.asarray(cj)
    assert np.abs(cp.numpy() - c).max() / np.abs(c).max() < 1e-6
    ej, ep = j_energies(dj), energies(dp)
    for k in ("KE", "PE", "VC", "Etot"):
        assert ep[k] == pytest.approx(ej[k], rel=1e-5), k


def test_energy_and_virial_bar_f64_gather():
    """The verify recipe's bar: Etot drift <~1e-6 over 60 steps and 2T/VC
    within a few % of 1 for an equilibrium sample.  Measured at dt=1e-3,
    5000 particles, lmax=2: max drift 3.4e-8, 2T/VC 0.983."""
    from exp_tpu_torch.basis.model import hernquist_model as hm
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables as build
    from exp_tpu_torch.ic.eddington import sample_spherical_model as sample

    mp = hm(rmin=1e-4, rmax=20.0)
    t = build(mp, lmax=2, nmax=10, numr=1000, cmap=1, rmap=1.0)
    f = SphereSL.from_tables(t, dtype=torch.float64, backend="gather",
                             device="cpu")
    x, v, mass = sample(mp, 5000, seed=7)
    ps = ParticleSystem.from_arrays(x, v, mass, dtype=torch.float64,
                                    device="cpu")
    ps, _, d = init_force_state(f, ps, accum_dtype=torch.float64)
    hist = [energies(d)]
    step = make_kdk_step(f, 1e-3, accum_dtype=torch.float64)
    for _ in range(60):
        ps, _, d = step(ps)
        hist.append(energies(d))
    e = np.array([h["Etot"] for h in hist])
    assert np.abs(e - e[0]).max() / abs(e[0]) < 1e-6
    ratios = np.array([h["2T/VC"] for h in hist])
    assert np.all(np.abs(ratios - 1.0) < 0.03), ratios.min()
