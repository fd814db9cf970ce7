"""The port's CylinderForce against exp_tpu's on the same tables and inputs.

The 'xla' backend (plain torch gathers) against the JAX 'xla' backend in
f64; the 'pallas' backend (K4/K5, their plain versions here) against the
port's own 'xla' backend with the JAX tests' tolerances; the monopole
continuation, zero-mass rows, the precision mapping, the flatdisk tables
through the same kernels, and the constructor's argument checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.empcyl import build_empcyl_tables
from exp_tpu.basis.flatdisk import build_flatdisk_tables as j_flat
from exp_tpu.forces.cylinder import CylinderForce as JCylinderForce

from exp_tpu_torch.basis.flatdisk import build_flatdisk_tables
from exp_tpu_torch.convert import cyl_tables_from_numpy
from exp_tpu_torch.forces.cylinder import CylinderForce
from exp_tpu_torch.ops import cyl_kernels as ck
from test_torch_cyl_kernels import N_SAMPLE, disk_inputs


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
def tables():
    t = build_empcyl_tables(mmax=4, nmax=8, lmaxfid=24, nmaxfid=16,
                            acyl=0.01, hcyl=0.002, numx=128, numy=64,
                            rnum=100, tnum=40, cachename=None)
    return t, cyl_tables_from_numpy(dataclasses.asdict(t))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_xla_backend_matches_jax_xla_f64(tables):
    """Coefficients, acceleration, potential and density in f64: measured
    max relative differences 5e-17, 1.9e-15, 5e-16 and 1.1e-15 (the same
    arithmetic); gated at 1e-12."""
    t, tp = tables
    x, m = (a.astype(np.float64) for a in disk_inputs())
    fj = JCylinderForce.from_tables(t, dtype=jnp.float64, backend="xla")
    fp = CylinderForce.from_tables(tp, dtype=torch.float64, backend="xla",
                                   device="cpu")
    cj = np.array(fj.coefficients(jnp.asarray(x), jnp.asarray(m),
                                  accum_dtype=jnp.float64))
    cp = fp.coefficients(torch.from_numpy(x), torch.from_numpy(m),
                         accum_dtype=torch.float64)
    assert cp.dtype == torch.float64 and tuple(cp.shape) == fp.coef_shape
    assert _rel(cp, cj) < 1e-12
    c = jnp.asarray(cj)
    aj, pj = fj.acceleration(c, jnp.asarray(x))
    ap, pp = fp.acceleration(torch.from_numpy(cj), torch.from_numpy(x))
    assert _rel(ap, aj) < 1e-12 and _rel(pp, pj) < 1e-12
    dj = fj.density(c, jnp.asarray(x))
    dp = fp.density(torch.from_numpy(cj), torch.from_numpy(x))
    assert _rel(dp, dj) < 1e-12
    assert float(dp[N_SAMPLE + 2]) == 0.0         # vacuum beyond rmax_grid


def test_pallas_matches_xla(tables):
    """The port's 'pallas' backend (coarse x grid, ncx=32) against its own
    'xla' backend, with the bounds of the JAX test_pallas_matches_xla:
    coefficients 2e-3, acceleration 2e-2 (5e-3 for R > 2 acyl), potential
    5e-3 of the field scale."""
    _, tp = tables
    x, m = (torch.from_numpy(a) for a in disk_inputs())
    fx = CylinderForce.from_tables(tp, backend="xla", device="cpu")
    fp = CylinderForce.from_tables(tp, backend="pallas", ncx=32,
                                   device="cpu")
    cx = fx.coefficients(x, m)
    assert _rel(fp.coefficients(x, m), cx) < 2e-3
    ax, px = fx.acceleration(cx, x)
    ap, pp = fp.acceleration(cx, x)
    ascale = float(ax.abs().max())
    assert float((ap - ax).abs().max()) / ascale < 2e-2
    assert _rel(pp, px) < 5e-3
    sel = x[:, :2].norm(dim=1) > 0.02
    assert float((ap - ax)[sel].abs().max()) / ascale < 5e-3


def test_pallas_outside_continuation(tables):
    """Beyond the table sphere both backends apply the same monopole
    continuation: rtol 5e-3, as the JAX test."""
    _, tp = tables
    x, m = (torch.from_numpy(a) for a in disk_inputs())
    fx = CylinderForce.from_tables(tp, backend="xla", device="cpu")
    fp = CylinderForce.from_tables(tp, backend="pallas", ncx=32,
                                   device="cpu")
    cx = fx.coefficients(x, m)
    far = torch.tensor([[0.5, 0.1, 0.2], [0.0, 0.0, 0.9]])
    ax, px = fx.acceleration(cx, far)
    ap, pp = fp.acceleration(cx, far)
    torch.testing.assert_close(pp, px, rtol=5e-3, atol=0)
    torch.testing.assert_close(ap, ax, rtol=5e-3, atol=1e-8)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_zero_mass_gives_zero_coefficients(tables, backend):
    _, tp = tables
    x, _ = disk_inputs()
    f = CylinderForce.from_tables(tp, backend=backend, ncx=32, device="cpu")
    c = f.coefficients(torch.from_numpy(x), torch.zeros(x.shape[0]))
    assert c.abs().max().item() == 0.0


def test_precisions_both_run_fp32(tables):
    """'default' and 'highest' are one FP32 computation on this port: the
    results are identical."""
    _, tp = tables
    x, m = (torch.from_numpy(a) for a in disk_inputs())
    out = []
    for prec in ("default", "highest"):
        f = CylinderForce.from_tables(tp, backend="pallas", ncx=32,
                                      pallas_precision=prec, device="cpu")
        c = f.coefficients(x, m)
        out.append((c, *f.acceleration(c, x)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_flatdisk_tables_through_the_pallas_backend():
    """The port's flatdisk tables serve CylinderForce unchanged: the
    'pallas' backend against the 'xla' one with the JAX
    test_pallas_flatdisk_tables bounds (coefficients 1e-3, acceleration
    5e-3; measured 1.4e-4 and 1.0e-3), and against the JAX 'pallas'
    backend on the JAX tables: measured 3.5e-7 and 1.2e-6, gated at
    1e-5."""
    kw = dict(mmax=2, nmax=6, model="kuzmin", acyl=1.0, numx=96, numy=48,
              knots=200, numk=128, cachename=None)
    t = build_flatdisk_tables(**kw)
    rng = np.random.default_rng(5)
    n = 1200
    R = rng.exponential(1.0, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    x = np.stack([R * np.cos(ph), R * np.sin(ph), rng.normal(0, 0.05, n)],
                 -1).astype(np.float32)
    m = np.full(n, 1.0 / n, np.float32)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    fx = CylinderForce.from_tables(t, backend="xla", device="cpu")
    fp = CylinderForce.from_tables(t, backend="pallas", ncx=32, device="cpu")
    cx = fx.coefficients(xt, mt)
    cp = fp.coefficients(xt, mt)
    assert _rel(cp, cx) < 1e-3
    ax, _ = fx.acceleration(cx, xt)
    ap, _ = fp.acceleration(cx, xt)
    assert _rel(ap, ax) < 5e-3

    fj = JCylinderForce.from_tables(j_flat(**kw), backend="pallas", ncx=32)
    cj = np.array(fj.coefficients_local(jnp.asarray(x), jnp.asarray(m)))
    assert _rel(cp, cj) < 1e-5
    aj, _ = fj.acceleration(jnp.asarray(cj), jnp.asarray(x))
    ap, _ = fp.acceleration(torch.from_numpy(cj), xt)
    assert _rel(ap, aj) < 1e-5


def test_constructor_checks(tables):
    _, tp = tables
    with pytest.raises(ValueError, match="backend"):
        CylinderForce.from_tables(tp, backend="gather", device="cpu")
    with pytest.raises(ValueError, match="pallas_precision"):
        CylinderForce.from_tables(tp, backend="pallas", device="cpu",
                                  pallas_precision="bf16")
    with pytest.raises(ValueError, match="pallas_interp"):
        CylinderForce.from_tables(tp, backend="pallas", device="cpu",
                                  pallas_interp="hat")
    # mmax past the kernels' 16 trig rows: the pallas backend's kernel
    # wrappers refuse it on every device, the CPU's plain versions included
    big = CylinderForce(*(torch.zeros(1),) * 6, mmax=8, nmax=1, numx=2,
                        numy=2, acyl=1.0, hcyl=1.0, xmin=0.0, dx=1.0,
                        ymin=0.0, dy=1.0, rmax_grid=1.0, backend="pallas")
    x1 = torch.zeros((1, 3))
    with pytest.raises(ValueError, match="mmax"):
        ck.cyl_coef(x1, torch.ones(1), big._kernel_params())
    with pytest.raises(ValueError, match="mmax"):
        ck.cyl_accel(x1, torch.zeros(1), big._kernel_params())
    f = CylinderForce.from_tables(tp, backend="xla", device="cpu")
    assert f.lmax == tp.mmax and f.coef_shape == (2, tp.mmax + 1, tp.nmax)
    assert f.rmax_grid == pytest.approx(tp.rcylmax * tp.acyl)
