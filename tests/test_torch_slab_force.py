"""The port's SlabForce against exp_tpu's: the einsum backend against JAX's
in f64 (coefficients, acceleration with the vacuum continuation, density;
x, y outside [0, 1)), the pallas backend (the kernels' plain versions)
against JAX's pallas backend (its kernels in interpret mode) for 'spline'
and 'linear', and the port-side physics of tests/test_slab.py and
tests/test_slab_pallas.py: the sech^2 sheet's mean field, the vacuum
continuation beyond zmax, and the acceleration as the gradient of the
einsum potential (torch.autograd)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.slab import build_slab_tables as j_build
from exp_tpu.forces.slab import SlabForce as JSlabForce

from exp_tpu_torch.basis.slab import build_slab_tables
from exp_tpu_torch.bench_slab import truncated_sheet
from exp_tpu_torch.forces.slab import SlabForce


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


ZMAX, H = 0.1, 0.01
KW = dict(nmaxx=2, nmaxy=3, nmax=4, zmax=ZMAX, h=H, numz=201)


@pytest.fixture(scope="module")
def tables():
    return j_build(**KW)


def _inputs(n=2000, seed=0, outside=200):
    """x, y over [-1.5, 2.5) (so that the wrap matters), z of a sheet of
    scale 0.02 with `outside` particles at zmax < |z| <= 3 zmax."""
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 0.02, n)
    z[:outside] = rng.uniform(ZMAX, 3 * ZMAX, outside) * rng.choice([-1, 1],
                                                                    outside)
    x = np.stack([rng.uniform(-1.5, 2.5, n), rng.uniform(-1.5, 2.5, n), z],
                 -1)
    return x, rng.uniform(0.5, 1.5, n) / n


@pytest.fixture(scope="module")
def f64(tables):
    jf = JSlabForce.from_tables(tables, dtype=jnp.float64)
    pf = SlabForce.from_tables(build_slab_tables(**KW), dtype=torch.float64,
                               device="cpu")
    x, m = _inputs(1000)
    cj = np.array(jf.coefficients(jnp.asarray(x), jnp.asarray(m),
                                  accum_dtype=jnp.float64))
    return jf, pf, x, m, cj


def test_einsum_coefficients_match_jax_f64(f64):
    """The same arithmetic in f64: measured 4e-17 of max|c|; gated at
    1e-12.  complex128 for accum_dtype float64; particles beyond |z| = zmax
    carry no mass into the coefficients."""
    _, pf, x, m, cj = f64
    cp = pf.coefficients(torch.from_numpy(x), torch.from_numpy(m),
                         accum_dtype=torch.float64)
    assert cp.dtype == torch.complex128 and tuple(cp.shape) == pf.coef_shape
    assert np.abs(cp.numpy() - cj).max() <= 1e-12 * np.abs(cj).max()
    inside = np.abs(x[:, 2]) <= ZMAX
    c_in = pf.coefficients(torch.from_numpy(x[inside]),
                           torch.from_numpy(m[inside]),
                           accum_dtype=torch.float64)
    assert torch.allclose(c_in, cp, rtol=0, atol=1e-14 * float(cp.abs().max()))


def test_einsum_acceleration_and_density_match_jax_f64(f64):
    """acc (with the vacuum continuation for the 200 particles beyond
    zmax), pot and density from the same coefficients on unwrapped x:
    measured 5.0e-16, 2.7e-16 and 3.1e-16 of their scales; gated at 1e-12."""
    jf, pf, x, _, cj = f64
    aj, pj = jf.acceleration(jnp.asarray(cj), jnp.asarray(x))
    ap, pp = pf.acceleration(torch.from_numpy(cj), torch.from_numpy(x))
    for a, b in ((ap, aj), (pp, pj)):
        b = np.asarray(b)
        assert a.dtype == torch.float64
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
    out = np.abs(x[:, 2]) > ZMAX
    assert np.abs(ap.numpy()[out] - np.asarray(aj)[out]).max() \
        <= 1e-12 * np.abs(np.asarray(aj)).max()
    dj = np.asarray(jf.density(jnp.asarray(cj), jnp.asarray(x)))
    dp = pf.density(torch.from_numpy(cj), torch.from_numpy(x)).numpy()
    assert np.abs(dp - dj).max() <= 1e-12 * np.abs(dj).max()


@pytest.mark.parametrize("interp", ["spline", "linear"])
def test_pallas_backend_matches_jax_pallas(tables, interp):
    """The pallas backend in f32 on the inputs of
    tests/test_slab_pallas.py:21-28 and :86-111 (1500 particles, and 600
    half beyond zmax): coefficients measured 2.2e-7 of max|c|, acceleration
    and potential up to 9.9e-6 and 5.8e-6 of their scales (the JAX kernel's
    bf16 splits); gated at 1e-5 (coefficients) and 5e-5, 100x tighter than
    that test's 2e-3 and 5e-3."""
    jf = JSlabForce.from_tables(tables, backend="pallas",
                                pallas_interp=interp)
    pf = SlabForce.from_tables(build_slab_tables(**KW), backend="pallas",
                               pallas_interp=interp, device="cpu")
    for seed, n, outside in ((8, 1500, 0), (11, 600, 300)):
        x, m = _inputs(n, seed, outside)
        x, m = x.astype(np.float32), m.astype(np.float32)
        cj = np.array(jf.coefficients_local(jnp.asarray(x), jnp.asarray(m)))
        cp = pf.coefficients_local(torch.from_numpy(x), torch.from_numpy(m))
        assert cp.dtype == torch.complex64
        assert np.abs(cp.numpy() - cj).max() <= 1e-5 * np.abs(cj).max()
        aj, pj = (np.asarray(a) for a in jf.acceleration(jnp.asarray(cj),
                                                          jnp.asarray(x)))
        ap, pp = (a.numpy() for a in pf.acceleration(torch.from_numpy(cj),
                                                     torch.from_numpy(x)))
        assert ap.dtype == np.float32 and np.isfinite(ap).all()
        assert np.abs(ap - aj).max() <= 5e-5 * np.abs(aj).max()
        assert np.abs(pp - pj).max() <= 5e-5 * np.abs(pj).max()


def test_pallas_matches_einsum_and_zero_mass(tables):
    """The port's pallas backend against its einsum backend at the
    tolerances of tests/test_slab_pallas.py:31-52, 86-111 (coefficients
    2e-3, acceleration and potential 5e-3 of their scales; measured 2.0e-5,
    1.7e-3 and 3.1e-5: the coarse z grid), inside and beyond zmax; zero
    masses give exactly 0."""
    pt = build_slab_tables(**KW)
    fx = SlabForce.from_tables(pt, device="cpu")
    fp = SlabForce.from_tables(pt, backend="pallas", device="cpu")
    x, m = _inputs(1500, 8, 300)
    xt = torch.tensor(x, dtype=torch.float32)
    mt = torch.tensor(m, dtype=torch.float32)
    cx = fx.coefficients_local(xt, mt)
    cp = fp.coefficients_local(xt, mt)
    assert float((cp - cx).abs().max() / cx.abs().max()) < 2e-3
    ax, px = fx.acceleration(cx, xt)
    ap, pp = fp.acceleration(cx, xt)
    assert float((ap - ax).abs().max() / ax.abs().max()) < 5e-3
    assert float((pp - px).abs().max() / px.abs().max()) < 5e-3
    assert float(fp.coefficients_local(xt, torch.zeros_like(mt)).abs()
                 .max()) == 0.0


@pytest.fixture(scope="module")
def sheet():
    """A sech^2 sheet truncated at zmax (tests/test_slab.py::_sample) of
    150,000 particles, as the JAX tests draw it (at 60,000 the field at
    z = 0.003 misses by 5.85e-2, too close to the 0.06 bound), and its
    coefficients through the pallas backend (the kernels' function)."""
    t = build_slab_tables(nmaxx=3, nmaxy=3, nmax=6, zmax=ZMAX, h=H)
    f = SlabForce.from_tables(t, backend="pallas", device="cpu")
    x, m = truncated_sheet(150_000, seed=1)
    coef = f.coefficients(torch.tensor(x, dtype=torch.float32),
                          torch.tensor(m, dtype=torch.float32))
    return f, coef


def test_sech2_vertical_force(sheet):
    """g_z = -2 pi Sigma tanh(z/h) within rtol 0.06 (tests/test_slab.py
    :38-50; measured 4.9e-2 at z = 0.003, where the einsum path in f64 on
    the same sample misses by as much: the basis, not the kernels), and the
    horizontal force, sampling noise, under 5% of max|g_z| (measured
    1.4%)."""
    f, coef = sheet
    zt = np.array([0.003, 0.01, 0.03, 0.06])
    pts = np.stack([np.full(4, 0.3), np.full(4, 0.7), zt], -1)
    acc, _ = f.acceleration(coef, torch.tensor(pts, dtype=torch.float32))
    acc = acc.double().numpy()
    gz = -2 * np.pi * np.tanh(zt / H)
    np.testing.assert_allclose(acc[:, 2], gz, rtol=0.06)
    assert np.abs(acc[:, :2]).max() < 0.05 * np.abs(gz).max()


def test_outside_vacuum_continuation(sheet):
    """|z| > zmax (tests/test_slab.py:157-191, same bounds): continuous
    across the faces, the plane sheet's g_z at 3 and 6 zmax, the transverse
    force decays, the potential grows linearly, mirror symmetry below the
    slab.  The deviations measured are at most 0.41 of each bound (the
    potential's continuity)."""
    f, coef = sheet

    def at(z):
        a, p = f.acceleration(coef, torch.tensor([[0.31, 0.72, z]],
                                                 dtype=torch.float32))
        return a.double().numpy()[0], float(p[0])

    a_in, p_in = at(ZMAX * 0.999)
    a_out, p_out = at(ZMAX * 1.001)
    np.testing.assert_allclose(a_out, a_in, rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(p_out, p_in, rtol=5e-3)
    gz_sheet = -2.0 * np.pi * np.tanh(ZMAX / H)
    a3, p3 = at(3.0 * ZMAX)
    a6, p6 = at(6.0 * ZMAX)
    np.testing.assert_allclose(a3[2], gz_sheet, rtol=0.08)
    np.testing.assert_allclose(a6[2], gz_sheet, rtol=0.08)
    assert abs(a6[0]) <= abs(a3[0]) + 1e-8
    np.testing.assert_allclose((p6 - p3) / (3.0 * ZMAX), -gz_sheet, rtol=0.1)
    am, pm = at(-6.0 * ZMAX)
    np.testing.assert_allclose(am[2], -a6[2], rtol=1e-3)
    np.testing.assert_allclose(pm, p6, rtol=0.05)


def test_acceleration_matches_autodiff():
    """acc = -grad pot by torch.autograd through the einsum potential, f64
    (tests/test_slab.py:53-71): horizontal exact (rtol 1e-6, atol 1e-8);
    vertical: the tabulated dphi against the derivative of the
    interpolated phi, rtol 0.03."""
    t = build_slab_tables(nmaxx=3, nmaxy=3, nmax=6, zmax=ZMAX, h=H)
    f = SlabForce.from_tables(t, dtype=torch.float64, device="cpu")
    x, m = truncated_sheet(5000, seed=2)
    coef = f.coefficients(torch.from_numpy(x), torch.from_numpy(m),
                          accum_dtype=torch.float64)
    pts = torch.tensor([[0.2, 0.4, 0.01], [0.8, 0.1, -0.03]],
                       dtype=torch.float64, requires_grad=True)
    acc, pot = f.acceleration(coef, pts)
    (g,) = torch.autograd.grad(pot.sum(), pts)
    acc, g = acc.detach().numpy(), g.numpy()
    np.testing.assert_allclose(acc[:, :2], -g[:, :2], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(acc[:, 2], -g[:, 2], rtol=0.03)


def test_settings_are_checked():
    """Unknown backend or interp raise ValueError; a geometry the kernels
    are not built for raises NotImplementedError on the pallas backend
    only; nzc is capped at numz, as exp_tpu caps it."""
    t = build_slab_tables(nmaxx=1, nmaxy=1, nmax=2, zmax=ZMAX, h=H, numz=201)
    with pytest.raises(ValueError, match="backend"):
        SlabForce.from_tables(t, backend="xla", device="cpu")
    with pytest.raises(ValueError, match="pallas_interp"):
        SlabForce.from_tables(t, pallas_interp="hat", device="cpu")
    with pytest.raises(NotImplementedError, match="rows in z"):
        SlabForce.from_tables(t, backend="pallas", nzc=127, device="cpu")
    f = SlabForce.from_tables(t, backend="pallas", nzc=128,
                              pallas_interp="linear", device="cpu")
    assert f.nzc == 128 and f.phi_s.shape[0] == 128
    assert SlabForce.from_tables(t, nzc=300, device="cpu").nzc == 201
    big = build_slab_tables(nmaxx=9, nmaxy=1, nmax=2, zmax=ZMAX, h=H,
                            numz=51)
    with pytest.raises(NotImplementedError, match="nmax"):
        SlabForce.from_tables(big, backend="pallas", device="cpu")
    fe = SlabForce.from_tables(big, device="cpu")      # einsum takes any
    assert fe.coef_shape == (19, 3, 2) and fe.lmax == 9


def test_unwrapped_positions_in_f32():
    """The einsum force, as exp_tpu's, takes the phases of unwrapped x, y;
    the kernels wrap first.  Shifting a sheet by (1000, -1000) periods in
    f32 moves the horizontal acceleration by 1.3e-3 of its largest value on
    the einsum path (angles of ~2.5e4 rad) and by 3.5e-4 on the pallas path
    (f32 holds x ~ 1000 to 6e-5), port against port; gated at 5e-3 and
    1e-3.  A shift of 3 periods moves either by under 1e-5."""
    t = build_slab_tables(**KW)
    rng = np.random.default_rng(0)
    x = np.stack([rng.uniform(0, 1, 1500), rng.uniform(0, 1, 1500),
                  rng.normal(0, 0.02, 1500)], -1)
    xt = torch.tensor(x, dtype=torch.float32)
    for backend, bound in (("einsum", 5e-3), ("pallas", 1e-3)):
        f = SlabForce.from_tables(t, backend=backend, device="cpu")
        c = f.coefficients(xt, torch.full((1500,), 1.0 / 1500))
        a0, _ = f.acceleration(c, xt)
        scale = float(a0[:, :2].abs().max())
        for shift, tol in ((3.0, 1e-5), (1000.0, bound)):
            xs = torch.tensor(x + [shift, -shift, 0.0], dtype=torch.float32)
            a1, _ = f.acceleration(c, xs)
            rel = float((a1[:, :2] - a0[:, :2]).abs().max()) / scale
            print(f"{backend} shift {shift}: max|da_xy|/max|a_xy| = {rel:.2e}")
            assert rel < tol
