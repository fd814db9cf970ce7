"""K4 and K5 of the port against exp_tpu's Pallas cylinder kernels.

The port's plain versions (the code the kernel wrappers take for CPU
tensors) against the JAX CylinderForce(backend='pallas') coefficient and
force passes, run in interpret mode on the CPU, for pallas_interp 'spline'
and 'linear', on EOF tables carried across with cyl_tables_from_numpy.
Inputs are the small disk of tests/test_cylinder_pallas.py (N = 1500 plus
edge rows, not a multiple of the TPU's 1024-particle block) and edge rows:
the origin, the z axis, r > rmax_grid in the plane and off it, |z| at and
near ymax, R at the inner and outer x edge, and a zero-mass row.  The CUDA
kernels against these plain versions on the card: tests/test_torch_gpu.py.
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
from exp_tpu.forces.cylinder import CylinderForce as JCylinderForce
from exp_tpu.ops import pallas_cylinder as pk

from exp_tpu_torch.convert import cyl_tables_from_numpy
from exp_tpu_torch.forces.cylinder import CylinderForce
from exp_tpu_torch.ops import cyl_kernels as ck


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


N_SAMPLE = 1500
NCX = 32
INTERPS = ["spline", "linear"]

# rmax_grid = 0.2, the inner x edge R = 1e-5, ymax = asinh(0.2 / 0.002)
EDGE_X = np.array([[0.0, 0.0, 0.0],            # origin
                   [0.0, 0.0, 0.05],           # z axis
                   [0.3, 0.0, 0.0],            # beyond rmax_grid, in plane
                   [0.15, 0.1, 0.12],          # beyond rmax_grid, off plane
                   [0.0, 0.0, 0.25],           # shrunk onto y = ymax
                   [0.001, 0.0, 0.1999],       # |z| near ymax
                   [0.002, 0.001, -0.1995],    # z near -ymax
                   [1e-5, 0.0, 0.0],           # R at the inner x edge
                   [0.0, -3e-6, 1e-6],         # inside the inner x edge
                   [0.1999, 0.0, 0.0],         # R at the outer x edge
                   [0.01, 0.01, 0.0]])         # zero mass below
EDGE_M = np.array([1e-3] * 10 + [0.0])


def disk_inputs():
    """The particles of tests/test_cylinder_pallas.py plus EDGE_X, f32."""
    rng = np.random.default_rng(3)
    R = rng.exponential(0.01, N_SAMPLE)
    z = rng.normal(0, 0.002, N_SAMPLE)
    ph = rng.uniform(0, 2 * np.pi, N_SAMPLE)
    x = np.stack([R * np.cos(ph), R * np.sin(ph), z], -1)
    m = rng.uniform(0.5, 1.5, N_SAMPLE) / N_SAMPLE
    x = np.concatenate([x, EDGE_X]).astype(np.float32)
    m = np.concatenate([m, EDGE_M]).astype(np.float32)
    assert x.shape[0] % 1024 != 0
    return x, m


@pytest.fixture(scope="module")
def setup():
    t = build_empcyl_tables(mmax=4, nmax=8, lmaxfid=24, nmaxfid=16,
                            acyl=0.01, hcyl=0.002, numx=128, numy=64,
                            rnum=100, tnum=40, cachename=None)
    tp = cyl_tables_from_numpy(dataclasses.asdict(t))
    x, m = disk_inputs()
    out = {}
    for interp in INTERPS:
        fj = JCylinderForce.from_tables(t, backend="pallas", ncx=NCX,
                                        pallas_interp=interp)
        fp = CylinderForce.from_tables(tp, backend="pallas", ncx=NCX,
                                       pallas_interp=interp, device="cpu")
        cj = np.array(fj.coefficients_local(jnp.asarray(x), jnp.asarray(m)))
        out[interp] = (fj, fp, cj)
    return x, m, out


@pytest.mark.parametrize("interp", INTERPS)
def test_k4_plain_raw_sums_match_jax_kernel(setup, interp):
    """G, the raw MTTKRP sums: max|dG|/max|G| measured 1.3e-6 ('spline')
    and 1.2e-6 ('linear'), f32 sums taken in another order; gated at 1e-5.
    The JAX kernel's trig rows past 2(M+1) are its padding to 16, all 0."""
    x, m, out = setup
    fj, fp, _ = out[interp]
    ckj, _ = fj._pallas_kernels()
    xp, mp, _ = fj._pad1024(jnp.asarray(x), jnp.asarray(m))
    Gj = np.asarray(ckj(pk.pack_xyzm(xp, mp)))
    prm = fp._kernel_params()
    Gp = ck.cyl_coef_plain(torch.from_numpy(x), torch.from_numpy(m), prm)
    assert Gp.shape == (prm.xrows, prm.trig_rows, prm.ncy)
    assert Gp.dtype == torch.float32
    T = prm.trig_rows
    assert np.abs(Gj[:, T:]).max() == 0.0
    rel = np.abs(Gp.numpy() - Gj[:, :T]).max() / np.abs(Gj).max()
    assert rel < 1e-5, rel


@pytest.mark.parametrize("interp", INTERPS)
def test_k4_coefficients_match_jax_pallas(setup, interp):
    """The public coefficients (2, M+1, nmax): max|dc|/max|c| measured
    2.2e-7 ('spline') and 5.4e-7 ('linear'); gated at 5e-6, 400x tighter
    than the JAX tests' 2e-3 between the pallas and xla paths."""
    x, m, out = setup
    _, fp, cj = out[interp]
    cp = fp.coefficients(torch.from_numpy(x), torch.from_numpy(m))
    assert cp.dtype == torch.float32 and tuple(cp.shape) == cj.shape
    rel = np.abs(cp.numpy() - cj).max() / np.abs(cj).max()
    assert rel < 5e-6, rel


@pytest.mark.parametrize("interp", INTERPS)
def test_k4_masked_and_zero_mass_rows_add_nothing(setup, interp):
    """Zero-mass rows and rows beyond rmax_grid give exactly 0, as the JAX
    test_pallas_zero_mass_padding demands of the TPU kernel."""
    x, m, out = setup
    _, fp, _ = out[interp]
    c0 = fp.coefficients(torch.from_numpy(x), torch.zeros(x.shape[0]))
    assert c0.abs().max().item() == 0.0
    rows = N_SAMPLE + np.array([2, 3, 4, 10])      # r > rmax_grid, mass 0
    c1 = fp.coefficients(torch.from_numpy(x[rows]), torch.from_numpy(m[rows]))
    assert c1.abs().max().item() == 0.0


@pytest.mark.parametrize("interp", INTERPS)
def test_k5_plain_matches_jax_pallas(setup, interp):
    """Acceleration and potential from the same coefficients: max|da| /
    max|a| measured 1.1e-6 and max|dpot| / max|pot| 3.8e-7 ('spline'; 3.4e-7
    'linear'), the tables' f32 contraction summed in another order; gated
    at 1e-5.  The edge rows (measured 8e-9 and 1.4e-7 of the scales) are
    held to the same 1e-5 and must be finite."""
    x, _, out = setup
    fj, fp, cj = out[interp]
    aj, pj = fj.acceleration(jnp.asarray(cj), jnp.asarray(x))
    aj, pj = np.asarray(aj), np.asarray(pj)
    ap, pp = fp.acceleration(torch.from_numpy(cj), torch.from_numpy(x))
    ap, pp = ap.numpy(), pp.numpy()
    assert ap.dtype == np.float32 and ap.shape == aj.shape
    assert np.isfinite(ap).all() and np.isfinite(pp).all()
    ascale, pscale = np.abs(aj).max(), np.abs(pj).max()
    assert np.abs(ap - aj).max() / ascale < 1e-5
    assert np.abs(pp - pj).max() / pscale < 1e-5
    edge = slice(N_SAMPLE, None)
    assert np.abs(ap[edge] - aj[edge]).max() / ascale < 1e-5
    assert np.abs(pp[edge] - pj[edge]).max() / pscale < 1e-5


def test_k5_continuation_beyond_the_table_sphere(setup):
    """Beyond rmax_grid the potential is Phi_b r_b / r with Phi_b the
    lookup at the shrunk point, and the force is radial: rel 1e-6 (f32)."""
    x, _, out = setup
    _, fp, cj = out["spline"]
    prm = fp._kernel_params()
    Ct = ck.contract_coef_tables(torch.from_numpy(cj), fp.tab3, prm.xrows,
                                 prm.ncy)
    pts = torch.tensor([[0.3, 0.0, 0.0], [0.2, 0.0, 0.0],
                        [0.0, 0.0, -0.5], [0.0, 0.0, -0.2]])
    a, p = ck.cyl_accel_plain(pts, Ct, prm)
    assert float(p[0]) == pytest.approx(float(p[1]) * 0.2 / 0.3, rel=1e-6)
    assert float(p[2]) == pytest.approx(float(p[3]) * 0.2 / 0.5, rel=1e-6)
    assert float(a[0, 0]) == pytest.approx(float(p[0]) / 0.3, rel=1e-6)
    assert float(a[0, 1]) == 0.0 and float(a[0, 2]) == 0.0


def test_wrappers_take_the_plain_version_only_on_the_cpu(setup):
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on any other non-CUDA device raises (there is no fallback)."""
    x, m, out = setup
    _, fp, cj = out["spline"]
    prm = fp._kernel_params()
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    before = dict(ck.launch_counts)
    torch.testing.assert_close(ck.cyl_coef(xt, mt, prm),
                               ck.cyl_coef_plain(xt, mt, prm), rtol=0,
                               atol=0)
    Ct = ck.contract_coef_tables(torch.from_numpy(cj), fp.tab3, prm.xrows,
                                 prm.ncy)
    a, p = ck.cyl_accel(xt, Ct, prm)
    a0, p0 = ck.cyl_accel_plain(xt, Ct, prm)
    torch.testing.assert_close(a, a0, rtol=0, atol=0)
    torch.testing.assert_close(p, p0, rtol=0, atol=0)
    assert ck.launch_counts == before
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.cyl_coef(meta, torch.empty(4, device="meta"), prm)
    with pytest.raises(ValueError, match="unsupported device"):
        ck.cyl_accel(meta, Ct.to("meta"), prm)
