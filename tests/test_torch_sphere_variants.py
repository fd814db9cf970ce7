"""The sphere's non-default pallas settings in the port against exp_tpu.

SphereSL(backend='pallas') selects its kernels from pallas_harmonics,
pallas_interp and lmax (exp_tpu/forces/spherical.py _harmonics_eff,
_pallas_kernels): K3 (recurrence coefficients), K6 (poly force), and the
'hat' branches of K1 and K2, K2 also above lmax 6.  The port's plain
versions (what the wrappers take for CPU tensors) run against the JAX
force's Pallas kernels in interpret mode, on tables carried across with
sph_tables_from_numpy.  Each gate is no looser than the JAX test it mirrors
(tests/test_spherical_force.py :184-267); the measured differences are
printed with -rP.  The CUDA kernels against these plain versions:
tests/test_torch_gpu.py.
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
from exp_tpu.ic.eddington import sample_spherical_model
from exp_tpu.ops.pallas_sphere import _poly_matrices

from exp_tpu_torch.convert import sph_tables_from_numpy
from exp_tpu_torch.forces.spherical import SphereSL
from exp_tpu_torch.ops import sphere_kernels as sk


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


N = 3000
# hat nodes of numr_c = 256 that the sample's rows are pinned to
NODES = [20, 90, 140, 200]


def _edge_rows(rmin):
    x = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.7], [0.0, 0.0, -1.3],
                  [30.0, 0.0, 0.0], [0.0, -25.0, 10.0],
                  [0.3 * rmin, 0.0, 0.1 * rmin], [0.3, 0.2, 0.1]])
    m = np.array([1e-4] * 6 + [0.0])
    return x, m


@pytest.fixture(scope="module")
def halo():
    m = hernquist_model(rmin=1e-4, rmax=20.0)
    t = build_sph_sl_tables(m, lmax=4, nmax=10, numr=2000, cmap=1, rmap=1.0)
    tp = sph_tables_from_numpy(dataclasses.asdict(t))
    x, _, mass = sample_spherical_model(m, N, seed=42)
    ex, em = _edge_rows(t.rmin)
    hat = SphereSL.from_tables(tp, backend="pallas", device="cpu",
                               numr_c=256, pallas_interp="hat")
    nx = sk.hat_node_points(hat._kernel_params(), NODES)
    x = np.concatenate([x, ex, nx]).astype(np.float32)
    mass = np.concatenate([mass, em, np.full(len(NODES), 1e-4)])
    return m, t, tp, x, mass.astype(np.float32)


def _pair(t, tp, **kw):
    """The JAX and the port force of the same tables and pallas settings."""
    fj = JSphereSL.from_tables(t, dtype=jnp.float32, backend="pallas", **kw)
    fp = SphereSL.from_tables(tp, backend="pallas", device="cpu", **kw)
    return fj, fp


def _coef(f, x, mass):
    if isinstance(f, JSphereSL):
        return np.asarray(f.coefficients(jnp.asarray(x), jnp.asarray(mass)))
    return f.coefficients(torch.from_numpy(x), torch.from_numpy(mass)).numpy()


def _accel(f, c, x):
    if isinstance(f, JSphereSL):
        a, p = f.acceleration(jnp.asarray(c, jnp.float32), jnp.asarray(x))
        return np.asarray(a), np.asarray(p)
    a, p = f.acceleration(torch.tensor(c, dtype=torch.float32),
                          torch.from_numpy(x))
    return a.numpy(), p.numpy()


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


SETTINGS = {
    "recurrence": dict(pallas_harmonics="recurrence"),
    "poly": dict(pallas_harmonics="poly"),
    "hat": dict(pallas_interp="hat", numr_c=256),
    "hat+recurrence": dict(pallas_interp="hat", numr_c=256,
                           pallas_harmonics="recurrence"),
    "hat+poly": dict(pallas_interp="hat", numr_c=256,
                     pallas_harmonics="poly"),
}


#: force tolerances (acc rtol, atol) against the JAX kernels: 'spline' at the
#: K2 gate of test_torch_sphere_kernels.py (10x tighter than the JAX tests);
#: 'hat' at the JAX hat test's own (tests/test_spherical_force.py:204):
#: its derivative is (T[j+1] - T[j]) / dxc of adjacent table rows, which
#: JAX's dense dot and the port round in another order, ~3.6e-5 of a force
#: of 0.4, and one of the node rows rounds t to the cell below in JAX
ACC_TOL = {"spline": (2e-4, 2e-6), "hat": (2e-3, 2e-5)}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_plain_matches_jax_pallas(halo, name):
    """Each setting's plain coefficient and force passes against the JAX
    kernels it selects, on the sample plus edge rows and rows exactly on
    hat nodes: coefficients max|d|/max|c| < 5e-7 (100x tighter than the
    JAX tests' 5e-5), force at ACC_TOL, pot rtol 2e-5 / atol 1e-7.
    Measured: coefficients 1.9e-7 to 2.4e-7; acc max|d| 2.4e-7 to 2.7e-6
    ('spline'), 3.6e-5 ('hat'); pot max|d| 1.8e-7 to 3.0e-7."""
    _, t, tp, x, mass = halo
    fj, fp = _pair(t, tp, **SETTINGS[name])
    assert fp._interp_eff == fj._interp_eff
    for kind in ("coef", "accel"):
        assert fp._harmonics_eff(kind) == fj._harmonics_eff(kind)
    cj, cp = _coef(fj, x, mass), _coef(fp, x, mass)
    rel = _rel(cp, cj)
    aj, pj = _accel(fj, cj, x)
    ap, pp = _accel(fp, cj, x)
    print(f"{name}: coefficients {rel:.2e}, acc max|d| "
          f"{np.abs(ap - aj).max():.2e}, pot max|d| {np.abs(pp - pj).max():.2e}")
    assert rel < 5e-7, rel
    assert np.isfinite(ap).all() and np.isfinite(pp).all()
    rtol, atol = ACC_TOL[fp._interp_eff]
    np.testing.assert_allclose(ap, aj, rtol=rtol, atol=atol)
    np.testing.assert_allclose(pp, pj, rtol=2e-5, atol=1e-7)


def test_hat_pallas_matches_matmul(halo):
    """tests/test_spherical_force.py:184-207 on the port: backend='pallas'
    interp='hat' (K1-hat, K2-hat plain) == the 'matmul' backend (the same
    hat math), coefficients within 5e-5, force rtol 2e-3 / atol 2e-5, pot
    rtol 1e-4 / atol 1e-6."""
    _, _, tp, x, mass = halo
    fm = SphereSL.from_tables(tp, backend="matmul", numr_c=256, device="cpu")
    fp = SphereSL.from_tables(tp, backend="pallas", numr_c=256,
                              pallas_interp="hat", device="cpu")
    xs, ms = x[:1500], mass[:1500]
    cm, cp = _coef(fm, xs, ms), _coef(fp, xs, ms)
    assert _rel(cp, cm) < 5e-5
    am, pm = _accel(fm, cm, xs[:300])
    ap, pp = _accel(fp, cm, xs[:300])
    np.testing.assert_allclose(ap, am, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(pp, pm, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("interp", ["spline", "hat"])
def test_poly_matches_recurrence(halo, interp):
    """tests/test_spherical_force.py:210-235 on the port: 'poly' (K1, K6)
    and 'recurrence' (K3, K2) agree on both passes, coefficients within
    5e-5, force rtol 2e-3 / atol 2e-5, pot rtol 1e-4 / atol 1e-6."""
    _, _, tp, x, mass = halo
    kw = dict(backend="pallas", device="cpu", pallas_interp=interp,
              numr_c=256)
    fr = SphereSL.from_tables(tp, pallas_harmonics="recurrence", **kw)
    fq = SphereSL.from_tables(tp, pallas_harmonics="poly", **kw)
    assert fr._harmonics_eff("accel") == "recurrence"
    assert fq._harmonics_eff("accel") == "poly"
    xs, ms = x[:2048], mass[:2048]
    cr, cq = _coef(fr, xs, ms), _coef(fq, xs, ms)
    assert _rel(cq, cr) < 5e-5
    ar, pr_ = _accel(fr, cr, xs[:300])
    aq, pq = _accel(fq, cr, xs[:300])
    np.testing.assert_allclose(aq, ar, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(pq, pr_, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("harm", ["poly", "recurrence"])
def test_lmax0_and_custom_fac(halo, harm):
    """tests/test_spherical_force.py:244-267 on the port: lmax=0 tables run
    on both harmonics, and a doubled `fac` doubles the coefficients (rtol
    1e-6) on both, equal to the JAX kernels' (5e-7) with the force too."""
    m, _, _, x, mass = halo
    t0 = build_sph_sl_tables(m, lmax=0, nmax=6, numr=400, cmap=1, rmap=1.0)
    tp0 = sph_tables_from_numpy(dataclasses.asdict(t0))
    fj, fp = _pair(t0, tp0, pallas_harmonics=harm)
    fj2 = dataclasses.replace(fj, fac=2.0 * fj.fac)
    fp2 = fp.replace(fac=2.0 * fp.fac)
    xs, ms = x[:1024], mass[:1024]
    c1, c2 = _coef(fp, xs, ms), _coef(fp2, xs, ms)
    cj2 = _coef(fj2, xs, ms)
    assert np.isfinite(c1).all() and abs(c1[0, 0, 0, 0]) > 0
    np.testing.assert_allclose(c2, 2.0 * c1, rtol=1e-6)
    assert _rel(c2, cj2) < 5e-7
    aj, pj = _accel(fj2, cj2, xs)
    ap, pp = _accel(fp2, cj2, xs)
    np.testing.assert_allclose(ap, aj, rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(pp, pj, rtol=2e-5, atol=1e-7)


@pytest.fixture(scope="module")
def halo8(halo):
    m, _, _, x, mass = halo
    t8 = build_sph_sl_tables(m, lmax=8, nmax=6, numr=400, cmap=1, rmap=1.0)
    return t8, sph_tables_from_numpy(dataclasses.asdict(t8)), x, mass


def test_lmax8_matches_jax_pallas(halo8):
    """'auto' at lmax 8 runs K3 and K2 in both packages: the plain versions
    against the JAX kernels, coefficients < 5e-7, force rtol 2e-4 / atol
    2e-6, pot rtol 2e-5 / atol 1e-7."""
    t8, tp8, x, mass = halo8
    fj, fp = _pair(t8, tp8)
    assert fp._harmonics_eff("coef") == "recurrence"
    cj, cp = _coef(fj, x, mass), _coef(fp, x, mass)
    rel = _rel(cp, cj)
    aj, pj = _accel(fj, cj, x)
    ap, pp = _accel(fp, cj, x)
    print(f"lmax 8: coefficients {rel:.2e}, acc max|d| "
          f"{np.abs(ap - aj).max():.2e}")
    assert rel < 5e-7, rel
    np.testing.assert_allclose(ap, aj, rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(pp, pj, rtol=2e-5, atol=1e-7)


def test_lmax8_matches_gather(halo8):
    """K3 + K2 (plain) at lmax 8 track the exact f64 gather backend as
    tests/test_spherical_force.py:270-294 holds the spline pallas path:
    coefficients within 5e-5, force rtol 2e-3 / atol 2e-5, pot rtol 2e-4 /
    atol 1e-6."""
    _, tp8, x, mass = halo8
    fg = SphereSL.from_tables(tp8, dtype=torch.float64, backend="gather",
                              device="cpu")
    fp = SphereSL.from_tables(tp8, backend="pallas", device="cpu")
    xs, ms = x[:2048], mass[:2048]
    cg = fg.coefficients(torch.tensor(xs, dtype=torch.float64),
                         torch.tensor(ms, dtype=torch.float64),
                         accum_dtype=torch.float64).numpy()
    cp = _coef(fp, xs, ms)
    assert _rel(cp, cg) < 5e-5
    ag, pg = fg.acceleration(torch.tensor(cg),
                             torch.tensor(xs[:300], dtype=torch.float64))
    ap, pp = _accel(fp, cg, xs[:300])
    np.testing.assert_allclose(ap, ag.numpy(), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(pp, pg.numpy(), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["poly", "hat+recurrence"])
def test_kdk_step_matches_jax(halo, name):
    """One KDK step (init + 1 step, dt=0.01, f32) under poly (K1, K6) and
    hat + recurrence (K3-hat, K2-hat) in both packages: positions,
    velocities and potentials rtol 2e-5 / atol 2e-6, as the default
    setting's trajectory test; forces at ACC_TOL."""
    from exp_tpu.nbody.particles import ParticleSystem as JParticleSystem
    from exp_tpu.nbody.step import init_force_state as j_init
    from exp_tpu.nbody.step import make_kdk_step as j_make_step

    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    m, t, tp, _, _ = halo
    x, v, mass = sample_spherical_model(m, 2000, seed=5)
    fj, fp = _pair(t, tp, **SETTINGS[name])
    pj = JParticleSystem.from_arrays(x, v, mass, dtype=jnp.float32)
    pj, _, _ = j_init(fj, pj)
    pj, cj, _ = j_make_step(fj, 0.01)(pj)
    pp = ParticleSystem.from_arrays(x, v, mass, device="cpu")
    pp, _, _ = init_force_state(fp, pp)
    pp, cp, _ = make_kdk_step(fp, 0.01)(pp)
    for a, b in ((pp.x, pj.x), (pp.v, pj.v), (pp.pot, pj.pot)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-6)
    rtol, atol = ACC_TOL[fp._interp_eff]
    np.testing.assert_allclose(pp.acc.numpy(), np.asarray(pj.acc), rtol=rtol,
                               atol=atol)
    assert _rel(cp.numpy(), np.asarray(cj)) < 1e-6


@pytest.mark.parametrize("lmax", range(7))
def test_poly_matrix_stack(lmax):
    """poly_matrix_stack equals exp_tpu's _poly_matrices(accel=True) on its
    unpadded entries, and every entry K6 skips is zero."""
    from exp_tpu.ops.pallas_sphere import _round_up

    P = (lmax + 1) ** 2
    nm = (lmax + 1) * (lmax + 2) * (lmax + 3) // 6
    C1 = _round_up(P, 8)
    jm = _poly_matrices(lmax, accel=True).reshape(4, C1, -1)[:, :P, :nm]
    Ms = sk.poly_matrix_stack(lmax)
    np.testing.assert_array_equal(Ms, jm.reshape(4 * P, nm))
    assert not Ms[~sk.poly_support(lmax)].any()


def test_hat_node_rows_keep_their_cell(halo):
    """Rows exactly on hat nodes: the cell is floor(t) = the node, so the
    plain hat derivative is the forward difference of the node's cell, as
    in exp_tpu's _hat_rows."""
    _, _, tp, x, _ = halo
    fp = SphereSL.from_tables(tp, backend="pallas", numr_c=256,
                              pallas_interp="hat", device="cpu")
    prm = fp._kernel_params()
    xs = torch.from_numpy(x[-len(NODES):])
    r = sk._radius(xs[:, 0], xs[:, 1], xs[:, 2])
    t = sk._grid_t(sk._ximap(r / prm.scale, prm), prm)
    assert t.tolist() == [float(k) for k in NODES]
    j0, w0, w1 = sk._hat_cell(sk._ximap(r / prm.scale, prm), prm)
    assert j0.tolist() == NODES
    assert w0.tolist() == [1.0] * len(NODES) and w1.tolist() == [0.0] * len(NODES)
