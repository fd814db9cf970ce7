"""The port's KDK step of the periodic slab against exp_tpu's:
init_force_state + 5 steps of a small genslab sheet (sample_slab(2000,
z0=0.01, seed=3), nmax 2 x 2 x 4), with the einsum backend in f64 and the
pallas backend in f32 (the JAX kernels in interpret mode, the port's plain
versions).  The step needs no change for the slab: its coefficients are
complex, as the cube's are, and the step's diagnostics read only real
tensors."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.slab import build_slab_tables as j_build
from exp_tpu.cli.genslab import main as genslab
from exp_tpu.forces.slab import SlabForce as JSlabForce
from exp_tpu.nbody.particles import ParticleSystem as JParticleSystem
from exp_tpu.nbody.particles import read_ascii_arrays
from exp_tpu.nbody.step import energies as j_energies
from exp_tpu.nbody.step import init_force_state as j_init
from exp_tpu.nbody.step import make_kdk_step as j_make_step

from exp_tpu_torch.basis.slab import build_slab_tables
from exp_tpu_torch.bench_slab import (DT, H, N, NMAX, NMAXXY, NUMZ, NZC, Z0,
                                      ZMAX, slab_force, slab_run, slab_sample,
                                      slab_tables)
from exp_tpu_torch.forces.slab import SlabForce
from exp_tpu_torch.ic.slab import sample_slab
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
STEP_DT = 0.002
KW = dict(nmaxx=2, nmaxy=2, nmax=4, zmax=0.1, h=0.01, numz=201)


@pytest.fixture(scope="module")
def ics():
    return sample_slab(2000, z0=0.01, seed=3)


def _run_both(x, v, mass, jdtype, tdtype, **kw):
    fj = JSlabForce.from_tables(j_build(**KW), dtype=jdtype, **kw)
    fp = SlabForce.from_tables(build_slab_tables(**KW), dtype=tdtype,
                               device="cpu", **kw)
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


def test_slab_kdk_einsum_f64_matches_jax(ics):
    """5 steps in f64 on the einsum backend: the same arithmetic, measured
    max relative differences 1.5e-15; gated at 1e-11.  The coefficients are
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


@pytest.mark.parametrize("interp", ["spline", "linear"])
def test_slab_kdk_pallas_matches_jax(ics, interp):
    """5 steps in f32 on the pallas backend: measured max|dx| 6.0e-8 (|x|
    up to 1.0), max|dv| 2.7e-7 (|v| up to 0.70), the acceleration and
    potential 8.6e-6 and 7.3e-6 of their scales (the JAX kernel's bf16
    splits), the coefficients 2.1e-7 of max|c|, the energies 1.2e-6
    relative; gated at rtol 2e-5 / atol 2e-6 on x, v and pot (the step
    tests' bar), 5e-5 of the acceleration scale, 2e-5 of the coefficient
    scale and 1e-5 relative on the energies."""
    pj, cj, dj, pp, cp, dp = _run_both(*ics, jnp.float32, torch.float32,
                                       backend="pallas",
                                       pallas_interp=interp)
    assert cp.dtype == torch.complex64
    for a, b in ((pp.x, pj.x), (pp.v, pj.v), (pp.pot, pj.pot)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-6)
    ascale = float(jnp.abs(pj.acc).max())
    assert float(np.abs(pp.acc.numpy() - np.asarray(pj.acc)).max()) \
        < 5e-5 * ascale
    c = np.asarray(cj)
    assert np.abs(cp.numpy() - c).max() < 2e-5 * np.abs(c).max()
    ej, ep = j_energies(dj), energies(dp)
    for k in ("KE", "PE", "VC", "Etot"):
        assert ep[k] == pytest.approx(ej[k], rel=1e-5), k


def test_bench_slab_configuration(tmp_path):
    """The bench's sample is genslab's sheet at z0 = 0.01, seed 11, bit for
    bit; its configuration is the JAX slab measurements' (nmax 4 x 4 x 6,
    zmax 0.1, h 0.01, numz 401, nzc 126 'spline', 2^20 particles,
    dt 1e-3), and its force is the pallas backend on those tables."""
    path = str(tmp_path / "s.bods")
    genslab(["-N", "3000", "-o", path, "--z0", "0.01", "-s", "11"])
    for a, b in zip(slab_sample(3000), read_ascii_arrays(path)):
        np.testing.assert_array_equal(a, b)
    assert (N, NMAXXY, NMAX, ZMAX, H, NUMZ, NZC, DT, Z0) == \
        (1_048_576, 4, 6, 0.1, 0.01, 401, 126, 1e-3, 0.01)
    t = slab_tables()
    f = slab_force(t, "cpu")
    assert (t.nmaxx, t.nmaxy, t.nmax, t.numz) == (4, 4, 6, 401)
    assert (f.backend, f.nzc, f.pallas_interp) == ("pallas", 126, "spline")
    assert f.phi_s.dtype == torch.float32


def test_slab_run_reports_its_gates():
    """bench_slab's KDK run on the CPU at 3000 particles, pallas backend,
    10 steps: finite; |dE/E| measured 2.5e-6, the change of the horizontal
    momentum 2.9e-10 and of the rms thickness 6.0e-3 (an equilibrium, but
    3000 particles' sheet breathes with its shot noise); gated at 1e-5,
    1e-8 and 2e-2."""
    x, v, m = slab_sample(3000)
    f = slab_force(device="cpu")
    out = slab_run(f, x, v, m, steps=10, device="cpu")
    assert out["finite"] and out["n"] == 3000
    assert out["dE_rel"] < 1e-5
    assert out["dPxy"] < 1e-8
    assert out["dzrms_rel"] < 2e-2
    assert len(out["Pxy0"]) == 2 and out["zrms0"] > 0
