"""The port's Cube against exp_tpu's: the einsum backend against JAX's in
f64 (coefficients, acceleration, density; positions outside [0, 1) and
nmin > 0), the pallas backend (v2 and v1; the kernels' plain versions)
against JAX's pallas backend (its kernels in interpret mode), and the
port-side physics of tests/test_cube_force.py: Hermitian coefficients, the
acceleration as the gradient of the potential (torch.autograd), periodic
wrap, and the Poisson solution of a single-mode perturbation."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.forces.cube import Cube as JCube

from exp_tpu_torch.forces.cube import Cube
from exp_tpu_torch.ic.cubeics import sample_cube


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
KW = dict(nmaxx=4, nmaxy=3, nmaxz=4, nminx=1, nminy=0, nminz=0)


def _inputs(n=N, lo=-1.5, hi=2.5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, 3)), rng.uniform(0.5, 1.5, n) / n


@pytest.fixture(scope="module")
def f64():
    jc = JCube.create(dtype=jnp.float64, **KW)
    pc = Cube.create(dtype=torch.float64, device="cpu", **KW)
    x, m = _inputs()
    cj = np.array(jc.coefficients(jnp.asarray(x), jnp.asarray(m),
                                  accum_dtype=jnp.float64))
    return jc, pc, x, m, cj


def test_einsum_coefficients_match_jax_f64(f64):
    """The same arithmetic in f64: measured 5e-16 of max|c|; gated at
    1e-12.  complex128 for accum_dtype float64, as _cdtype."""
    _, pc, x, m, cj = f64
    cp = pc.coefficients(torch.from_numpy(x), torch.from_numpy(m),
                         accum_dtype=torch.float64)
    assert cp.dtype == torch.complex128 and tuple(cp.shape) == pc.coef_shape
    assert np.abs(cp.numpy() - cj).max() <= 1e-12 * np.abs(cj).max()
    # the nmin mask and the k = 0 swindle give exact zeros
    assert np.all(cp.numpy()[KW["nmaxx"]] == 0)


def test_einsum_acceleration_and_density_match_jax_f64(f64):
    """acc, pot and density from the same coefficients: measured 3e-16 of
    their scales; gated at 1e-12."""
    jc, pc, x, _, cj = f64
    aj, pj = jc.acceleration(jnp.asarray(cj), jnp.asarray(x))
    ap, pp = pc.acceleration(torch.from_numpy(cj), torch.from_numpy(x))
    for a, b in ((ap, aj), (pp, pj)):
        b = np.asarray(b)
        assert a.dtype == torch.float64
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
    dj = np.asarray(jc.density(jnp.asarray(cj), jnp.asarray(x)))
    dp = pc.density(torch.from_numpy(cj), torch.from_numpy(x)).numpy()
    assert np.abs(dp - dj).max() <= 1e-12 * np.abs(dj).max()


@pytest.mark.parametrize("version", [2, 1])
def test_pallas_backend_matches_jax_pallas(version):
    """The pallas backend in f32 at nmax 3 on the inputs of
    tests/test_cube_force.py:141-164 (1500 particles over [-0.2, 1.2)):
    coefficients measured 4.6e-7 of max|c|, acceleration 3.7e-7 and
    potential 2.3e-7 of their scales (v1 and v2 alike); gated at rtol 2e-4 / atol 2e-7 (coefficients), atol
    2e-5 of max|a| (acceleration) and atol 2e-6 (potential), the
    tolerances of that test, and at 2e-6 of each scale, 100x tighter."""
    nm = 3
    jc = JCube.create(nm, nm, nm, dtype=jnp.float32, backend="pallas",
                      pallas_version=version)
    pc = Cube.create(nm, nm, nm, backend="pallas", pallas_version=version,
                     device="cpu")
    rng = np.random.default_rng(7)
    n = 1500
    x = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    m = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    cj = np.array(jc.coefficients_local(jnp.asarray(x), jnp.asarray(m)))
    cp = pc.coefficients_local(torch.from_numpy(x), torch.from_numpy(m))
    assert cp.dtype == torch.complex64
    cp = cp.numpy()
    np.testing.assert_allclose(cp, cj, rtol=2e-4, atol=2e-7)
    assert np.abs(cp - cj).max() <= 2e-6 * np.abs(cj).max()
    aj, pj = (np.asarray(a) for a in jc.acceleration(jnp.asarray(cj),
                                                      jnp.asarray(x)))
    ap, pp = (a.numpy() for a in pc.acceleration(torch.from_numpy(cj),
                                                 torch.from_numpy(x)))
    scale = np.abs(aj).max()
    np.testing.assert_allclose(ap, aj, rtol=2e-4, atol=2e-5 * scale)
    np.testing.assert_allclose(pp, pj, rtol=2e-4, atol=2e-6)
    assert np.abs(ap - aj).max() <= 2e-6 * scale
    assert np.abs(pp - pj).max() <= 2e-6 * np.abs(pj).max()


def test_pallas_v1_equals_v2_and_einsum():
    """pallas_version 1 runs the same kernels on the same b as version 2:
    identical output.  Both agree with the port's einsum backend in f32 to
    2e-4 relative, test_cube_force.py:155-164's tolerance (measured 5e-7)."""
    x, m = _inputs(1700, -0.2, 1.2, seed=3)
    xt = torch.tensor(x, dtype=torch.float32)
    mt = torch.tensor(m, dtype=torch.float32)
    out = {}
    for name, kw in (("v2", dict(backend="pallas")),
                     ("v1", dict(backend="pallas", pallas_version=1)),
                     ("einsum", {})):
        f = Cube.create(3, 4, 3, device="cpu", **kw)
        c = f.coefficients(xt, mt)
        out[name] = (c, *f.acceleration(c, xt))
    for a, b in zip(out["v1"], out["v2"]):
        assert torch.equal(a, b)
    for a, b in zip(out["v2"], out["einsum"]):
        assert float((a - b).abs().max() / b.abs().max()) < 2e-4


def test_coefficients_hermitian():
    """a_{-k} = conj(a_k) for a real mass distribution, f64 einsum (rtol
    1e-10, atol 1e-12 as test_cube_force.py:16-23) and the pallas backend's
    plain version in f32 (2e-6 of max|c|)."""
    x, m = _inputs(500, 0.0, 1.0)
    f = Cube.create(4, 4, 4, dtype=torch.float64, device="cpu")
    c = f.coefficients(torch.from_numpy(x), torch.from_numpy(m),
                       accum_dtype=torch.float64).numpy()
    np.testing.assert_allclose(c[::-1, ::-1, ::-1], np.conj(c), rtol=1e-10,
                               atol=1e-12)
    fp = Cube.create(4, 4, 4, backend="pallas", device="cpu")
    cp = fp.coefficients(torch.tensor(x, dtype=torch.float32),
                         torch.tensor(m, dtype=torch.float32)).numpy()
    assert np.abs(cp[::-1, ::-1, ::-1] - np.conj(cp)).max() \
        <= 2e-6 * np.abs(cp).max()


def test_acceleration_is_minus_gradient_of_potential():
    """acc = -grad pot by torch.autograd through the einsum potential, f64:
    rtol 1e-8, atol 1e-10 (test_cube_force.py:26-41)."""
    x, m = _inputs(2000, 0.0, 1.0, seed=1)
    f = Cube.create(4, 4, 4, dtype=torch.float64, device="cpu")
    coef = f.coefficients(torch.from_numpy(x), torch.from_numpy(m),
                          accum_dtype=torch.float64)
    rng = np.random.default_rng(1)
    pts = torch.tensor(rng.uniform(-0.9, 1.9, (6, 3)), requires_grad=True)
    acc, pot = f.acceleration(coef, pts)
    (g,) = torch.autograd.grad(pot.sum(), pts)
    np.testing.assert_allclose(acc.detach().numpy(), -g.numpy(), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_wrap_periodicity(backend):
    """Positions a whole number of periods apart give the same force and
    coefficients (test_cube_force.py:72-88): rtol 1e-10 / atol 1e-12 in f64
    (einsum); the pallas path in f32 wraps with x - floor(x) before the
    angle, so the same u gives the same bits."""
    x, m = _inputs(1000, 0.0, 1.0, seed=3)
    dt = torch.float64 if backend == "einsum" else torch.float32
    f = Cube.create(4, 4, 4, dtype=dt, backend=backend, device="cpu")
    xt, mt = torch.tensor(x, dtype=dt), torch.tensor(m, dtype=dt)
    coef = f.coefficients(xt, mt, accum_dtype=dt)
    p1 = torch.tensor([[0.25, 0.5, 0.5]], dtype=dt)
    p2 = torch.tensor([[1.25, -0.5, 2.5]], dtype=dt)
    a1, ph1 = f.acceleration(coef, p1)
    a2, ph2 = f.acceleration(coef, p2)
    np.testing.assert_allclose(a1.numpy(), a2.numpy(), rtol=1e-10)
    np.testing.assert_allclose(ph1.numpy(), ph2.numpy(), rtol=1e-10)
    c2 = f.coefficients(xt + 3.0, mt, accum_dtype=dt)
    tol = 1e-12 if backend == "einsum" else 2e-6 * float(coef.abs().max())
    np.testing.assert_allclose(c2.numpy(), coef.numpy(), rtol=1e-8, atol=tol)


def test_poisson_single_mode_on_pallas_backend():
    """The k = (1, 0, 0) cosine density 1 + A cos(2 pi x), A = 0.5, of
    sample_cube's perturbed sample at 200,000 particles through the pallas
    backend (plain versions, f32), nmax 6: Phi - mean = -A cos(2 pi x)/pi
    - mean with test_cube_force.py:44-69's atol 6e-3 (measured 4.3e-3), and
    a_x = -2 A sin(2 pi x) with atol 0.1 (measured 0.053).  a_x's shot
    noise carries the 2 pi k_x weights: its standard deviation is
    sqrt(sum_k (2 pi k_x)^2 norm_k^4 / N) = 0.0246 here (Phi's is
    sqrt(sum_k norm_k^4 / N) = 0.0028), and 0.1 is 4 of it."""
    A = 0.5
    x, _, m = sample_cube(200_000, sigma=0.1, pert_k=(1, 0, 0), pert_amp=A,
                          seed=2)
    f = Cube.create(6, 6, 6, backend="pallas", device="cpu")
    coef = f.coefficients(torch.tensor(x, dtype=torch.float32),
                          torch.tensor(m, dtype=torch.float32))
    xt = np.linspace(0.05, 0.95, 10)
    pts = np.stack([xt, np.full_like(xt, 0.5), np.full_like(xt, 0.5)], -1)
    acc, pot = f.acceleration(coef, torch.tensor(pts, dtype=torch.float32))
    pot = pot.numpy().astype(np.float64)
    expected = -A * np.cos(2 * np.pi * xt) / np.pi
    np.testing.assert_allclose(pot - pot.mean(), expected - expected.mean(),
                               atol=6e-3)
    np.testing.assert_allclose(acc.numpy()[:, 0],
                               -2 * A * np.sin(2 * np.pi * xt),
                               atol=0.1)


def test_create_checks_its_settings():
    with pytest.raises(ValueError, match="backend"):
        Cube.create(2, 2, 2, backend="xla", device="cpu")
    with pytest.raises(ValueError, match="pallas_precision"):
        Cube.create(2, 2, 2, pallas_precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="pallas_version"):
        Cube.create(2, 2, 2, pallas_version=3, device="cpu")
    for pp in ("mixed", "highest", "default"):
        f = Cube.create(2, 2, 2, backend="pallas", pallas_precision=pp,
                        device="cpu")
        assert f.coef_shape == (5, 5, 5) and f.nmax == 5 and f.lmax == 2
