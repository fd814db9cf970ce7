"""The port's f64 comparator (exp_tpu_torch/validate.py) and integral
transforms (exp_tpu_torch/ops/transforms.py) against exp_tpu's, and the
comparator's gates on the port's sphere step (tests/test_reference_
comparator.py:27 and :50, tests/test_ops.py:59 and :74).

Tolerances:
  * legendre_lm_np, dlegendre_lm_np, real_ylm_norm_np: equal to exp_tpu's
    bit for bit; ReferenceSphereStep on exp_tpu's tables too (the same
    NumPy operations on the same arrays), and within HOST (1e-12 of the
    largest value) on the port's own tables (each package's SL tables
    carry its own ARPACK roundoff, ~1e-15);
  * the port's SphereSL on backend 'gather', f64, through nbody/step.py's
    make_kdk_step / init_force_state, against the comparator, with the
    JAX test's tolerances unchanged: one step's coefficients < 1e-12 of
    max|c|, accelerations and potential at rtol 1e-10 / atol 1e-12 with
    deriv 'lerp'; < 1e-6 relative coefficient drift at 25 steps and
    < 1e-9 over 300;
  * QDHT and TransformFFT: their arrays to F64 (1e-10) of exp_tpu's, and
    exp_tpu's test's own checks;
  * the comparator's VR1 (b) run (backend 'pallas', 'hat', 'highest', the
    kernels' plain versions here) stays under chip_smoke.py's VR1 (b)
    bound."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

HOST = 1e-12
F64 = 1e-10
# chip_smoke.py's VR1B_BOUND: three times the CPU run's largest drift
# (python -m exp_tpu_torch.bench_validate b --device cpu --threads 1)
VR1B_BOUND = 3 * 4.5102455053879105e-07


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
def problem():
    """tests/test_reference_comparator.py's problem, from the port's
    modules: Hernquist over [1e-4, 20], lmax 2, nmax 8, numr 1000, cmap 1,
    2,000 bodies of seed 21."""
    from exp_tpu_torch.bench_validate import problem

    return problem()


@pytest.mark.parametrize("lmax", [0, 1, 4, 8])
def test_legendre_helpers_equal_exp_tpu(lmax):
    from exp_tpu import validate as jv
    from exp_tpu_torch import validate as tv

    x = np.concatenate([np.linspace(-1.0, 1.0, 41),
                        np.random.default_rng(lmax).uniform(-1, 1, 200)])
    assert tv.legendre_lm_np(lmax, x).tobytes() == \
        jv.legendre_lm_np(lmax, x).tobytes()
    for a, b in zip(tv.dlegendre_lm_np(lmax, x), jv.dlegendre_lm_np(lmax, x)):
        assert a.tobytes() == b.tobytes()
    assert tv.real_ylm_norm_np(lmax).tobytes() == \
        jv.real_ylm_norm_np(lmax).tobytes()


def test_reference_step_equals_exp_tpu(problem):
    """ReferenceSphereStep of the port equals exp_tpu's bit for bit on
    exp_tpu's tables, and to HOST on the port's own tables; a few KDK
    steps of both equal too."""
    from exp_tpu.basis.model import hernquist_model as j_hernquist
    from exp_tpu.basis.slgrid import build_sph_sl_tables as j_tables
    from exp_tpu.validate import ReferenceSphereStep as JRef
    from exp_tpu_torch.validate import ReferenceSphereStep as TRef

    t, x, v, mass = problem
    tj = j_tables(j_hernquist(rmin=1e-4, rmax=20.0), lmax=2, nmax=8,
                  numr=1000, cmap=1, rmap=1.0)
    xo = np.concatenate([x, [[30.0, 0.0, 0.0], [0.0, 0.0, 1e-5]]])
    mo = np.concatenate([mass, [1e-3, 1e-3]])
    for ta in (tj, t):
        rj, rt = JRef(tj), TRef(ta)
        cj, ct = rj.coefficients(xo, mo), rt.coefficients(xo, mo)
        # the row on the z axis divides 0 by 0 in the branch np.where drops
        with np.errstate(invalid="ignore", divide="ignore"):
            (aj, pj), (at, pt) = (rj.acceleration(cj, xo),
                                  rt.acceleration(cj, xo))
        if ta is tj:
            for p, q in ((ct, cj), (at, aj), (pt, pj)):
                assert p.tobytes() == q.tobytes()
            trj, (xj, vj) = rj.run(x, v, mass, 0.005, 3)
            trt, (xt, vt) = rt.run(x, v, mass, 0.005, 3)
            assert [k for k, _ in trt] == [k for k, _ in trj]
            for (_, p), (_, q) in zip(trt, trj):
                assert p.tobytes() == q.tobytes()
            assert xt.tobytes() == xj.tobytes()
        else:
            for p, q in ((ct, cj), (at, aj), (pt, pj)):
                assert np.abs(p - q).max() <= HOST * np.abs(q).max()


def test_single_step_equations_match(problem):
    """tests/test_reference_comparator.py:27 on the port: one step's
    coefficients and accelerations against the comparator."""
    from exp_tpu_torch.forces.spherical import SphereSL
    from exp_tpu_torch.validate import ReferenceSphereStep

    t, x, v, mass = problem
    f64 = dict(dtype=torch.float64, device="cpu")
    force = SphereSL.from_tables(t, backend="gather", **f64)
    ref = ReferenceSphereStep(t)
    c = force.coefficients(torch.as_tensor(x, **f64),
                           torch.as_tensor(mass, **f64),
                           accum_dtype=torch.float64).numpy()
    c_ref = ref.coefficients(x, mass)
    assert np.abs(c - c_ref).max() / np.abs(c_ref).max() < 1e-12
    a, p = force.acceleration(torch.as_tensor(c_ref, **f64),
                              torch.as_tensor(x, **f64), deriv="lerp")
    a_ref, p_ref = ref.acceleration(c_ref, x)
    np.testing.assert_allclose(a.numpy(), a_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-10, atol=1e-12)


def test_coefficient_trajectory_drift(problem):
    """tests/test_reference_comparator.py:50 on the port: KDK integration
    of the port's f64 gather step (deriv 'lerp') and the comparator from
    identical ICs; < 1e-6 relative coefficient drift at 25 steps, < 1e-9
    over 300 (bench_validate's case (a), as chip_smoke's VR1 (a) runs it
    on the card)."""
    from exp_tpu_torch.bench_validate import case_a

    rep = case_a(torch.device("cpu"), prob=problem)
    print({k: rep[k] for k in ("step_coef_rel", "drift_25", "drift_max")})
    assert rep["step_coef_rel"] < 1e-12
    assert rep["step_acc_excess"] <= 1e-12
    assert rep["step_pot_excess"] <= 1e-12
    assert rep["drift_25"] < 1e-6
    assert rep["drift_max"] < 1e-9
    assert sorted(int(k) for k in rep["drift"]) == list(range(25, 301, 25))


def test_hat_pallas_run_within_vr1_bound(problem):
    """bench_validate's case (b) here (the plain versions of K1 'hat' and
    K2 'hat'): the CPU run whose drift, times three, is chip_smoke.py's
    VR1 (b) bound stays under that bound."""
    from exp_tpu_torch.bench_validate import case_b

    rep, force = case_b(torch.device("cpu"), prob=problem)
    print(rep)
    assert force._interp_eff == "hat" and force.pallas_precision == "highest"
    assert rep["drift_max"] <= VR1B_BOUND


def test_qdht_gaussian_pair():
    """tests/test_ops.py:59: the zero-order Hankel transform of
    exp(-r^2/2) is its own, the matrix orthogonal, and the port's arrays
    those of exp_tpu's QDHT to F64."""
    from exp_tpu.ops.transforms import QDHT as JQ
    from exp_tpu_torch.ops.transforms import QDHT

    q, qj = QDHT(0, 128, 12.0), JQ(0, 128, 12.0)
    assert q.check() < 1e-8
    f = np.exp(-q.r ** 2 / 2)
    F = q(f)
    assert np.abs(F - np.exp(-q.k ** 2 / 2)).max() < 1e-12
    assert np.abs(q(F, forward=False) - f).max() < 1e-12
    assert abs(q.interp(1.3, F) - np.exp(-1.3 ** 2 / 2)) < 1e-12
    for a, b in ((q.T, qj.T), (q.r, qj.r), (q.k, qj.k), (F, qj(f)),
                 (q(F, forward=False), qj(F, forward=False)),
                 (q.interp(np.linspace(0, 5, 9), F),
                  qj.interp(np.linspace(0, 5, 9), F))):
        assert np.abs(a - b).max() <= F64 * max(1.0, np.abs(b).max())
    for nu, n, r in ((2, 32, 3.0),):
        a, b = QDHT(nu, n, r), JQ(nu, n, r)
        assert np.abs(a.T - b.T).max() <= F64
    for bad in ((-1, 4, 1.0), (0, 0, 1.0)):
        with pytest.raises(ValueError):
            QDHT(*bad)


def test_transform_fft_power_peak():
    """tests/test_ops.py:74 and the port's spectra to F64 of exp_tpu's."""
    from exp_tpu.ops.transforms import TransformFFT as JT
    from exp_tpu_torch.ops.transforms import TransformFFT

    y = np.cos(2 * np.pi * 1.5 * np.arange(256) * 0.1)
    t, tj = TransformFFT(0.1, y), JT(0.1, y)
    fr, P = t.power()
    assert abs(fr[P.argmax()] / (2 * np.pi) - 1.5) < 0.05
    fr2, W = t.inverse()
    assert W.shape == fr2.shape
    for a, b in zip(t.power() + t.inverse(), tj.power() + tj.inverse()):
        assert np.abs(a - b).max() <= F64 * max(1.0, np.abs(b).max())
    assert t.dk == tj.dk
