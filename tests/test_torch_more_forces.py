"""The port's remaining forces against exp_tpu's on the same inputs: the
Bessel and analytic (Clutton-Brock, Hernquist) bases and their SphereSL
forces, ShellsForce and HaloBulgeForce, DirectForce in its four source
models, and the jnp.interp counterpart they share.

Tolerances:
  * the host tables (NumPy/SciPy on both sides, the same arithmetic in the
    same order): equal bit for bit;
  * f64 forces: coefficients max|dc|/max|c| and accelerations/potentials
    relative to their largest value, 1e-12 (EXACT) — the sums run in
    another order;
  * hernq on backend 'pallas' in f32: K1's and K2's plain versions against
    exp_tpu's Pallas kernels in interpret mode at the tolerances of
    tests/test_spherical_force.py:270-294 (coefficients 5e-5 of the
    largest, acceleration rtol 2e-3 atol 2e-5, potential rtol 2e-4 atol
    1e-6).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis import analytic as janalytic
from exp_tpu.basis import bessel as jbessel
from exp_tpu.basis.model import hernquist_model, plummer_model
from exp_tpu.forces.direct import DirectForce as JDirect
from exp_tpu.forces.shells import HaloBulgeForce as JHaloBulge
from exp_tpu.forces.shells import ShellsForce as JShells
from exp_tpu.ic.eddington import sample_spherical_model

from exp_tpu_torch.basis import analytic as panalytic
from exp_tpu_torch.basis import bessel as pbessel
from exp_tpu_torch.basis.model import SphericalModelTable
from exp_tpu_torch.forces.direct import DirectForce
from exp_tpu_torch.forces.shells import HaloBulgeForce, ShellsForce
from exp_tpu_torch.ops.interp import interp


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


EXACT = 1e-12
F64 = torch.float64


def close(t, j, tol=EXACT):
    """max|t - j| <= tol max|j|."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    err = np.abs(t - j).max() / np.abs(j).max()
    assert err <= tol, err


@pytest.fixture(scope="module")
def halo():
    """A Hernquist halo (rmax 50) of 3,000 particles plus edge rows: the
    origin, one on the z axis, one beyond rmax and a massless one."""
    m = hernquist_model(rmin=1e-3, rmax=50.0)
    x, _, mass = sample_spherical_model(m, 3000, seed=4)
    x = np.concatenate([x, [[0.0, 0.0, 0.0], [0.0, 0.0, 0.5],
                            [70.0, 0.0, 0.0], [1.0, 1.0, 0.0]]])
    mass = np.concatenate([mass, [1e-4, 1e-4, 1e-4, 0.0]])
    return m, x, mass


def _both(fj, fp, x, mass, pts):
    """(coefficients, acceleration, potential) of both forces in f64."""
    cj = fj.coefficients(jnp.asarray(x), jnp.asarray(mass),
                         accum_dtype=jnp.float64)
    cp = fp.coefficients(torch.tensor(x), torch.tensor(mass),
                         accum_dtype=F64)
    aj, pj = fj.acceleration(cj, jnp.asarray(pts))
    ap, pp = fp.acceleration(cp, torch.tensor(pts))
    return (cp, cj), (ap, aj), (pp, pj)


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------

def test_host_tables_equal_exp_tpu():
    """sph_bessel_zeros, build_bessel_tables, build_cb_tables and
    build_hq_tables: equal to exp_tpu's bit for bit."""
    for l in (0, 1, 5):
        np.testing.assert_array_equal(pbessel.sph_bessel_zeros(l, 6),
                                      jbessel.sph_bessel_zeros(l, 6))
    for a, b in zip(pbessel.build_bessel_tables(3, 8, 2.0, numr=300),
                    jbessel.build_bessel_tables(3, 8, 2.0, numr=300)):
        np.testing.assert_array_equal(a, b)
    for name in ("build_cb_tables", "build_hq_tables"):
        kw = dict(rmin=1e-3, rmax=100.0, numr=300)
        for a, b in zip(getattr(panalytic, name)(2, 6, **kw),
                        getattr(janalytic, name)(2, 6, **kw)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the SphereSL forces over the analytic tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,backend", [("bessel", "gather"),
                                          ("bessel", "matmul"),
                                          ("hernq", "matmul"),
                                          ("hernq", "gather"),
                                          ("CBsphere", "matmul")])
def test_analytic_forces_match(halo, kind, backend):
    """make_bessel_force / make_analytic_force in f64: the grids and
    tables equal exp_tpu's, coefficients and fields to EXACT."""
    _, x, mass = halo
    if kind == "bessel":
        fj = jbessel.make_bessel_force(2, 8, 60.0, numr=600,
                                       dtype=jnp.float64, backend=backend)
        fp = pbessel.make_bessel_force(2, 8, 60.0, numr=600, dtype=F64,
                                       backend=backend, device="cpu")
    else:
        kw = dict(rmin=1e-3, rmax=60.0, numr=600, scale=1.0)
        fj = janalytic.make_analytic_force(kind, 2, 8, dtype=jnp.float64,
                                           backend=backend, **kw)
        fp = panalytic.make_analytic_force(kind, 2, 8, dtype=F64,
                                           backend=backend, device="cpu",
                                           **kw)
    g, h = fp.grid, fj.grid
    assert (g.numr, g.cmap, g.xmin, g.dxi, g.rmin, g.rmax) == \
        (h.numr, h.cmap, h.xmin, h.dxi, h.rmin, h.rmax)
    np.testing.assert_array_equal(g.pot_t.numpy(), np.asarray(h.pot_t))
    np.testing.assert_array_equal(fp.tabc.numpy(), np.asarray(fj.tabc))
    np.testing.assert_array_equal(fp.tabc_s.numpy(), np.asarray(fj.tabc_s))
    np.testing.assert_array_equal(fp.tabd_s.numpy(), np.asarray(fj.tabd_s))
    # the kernels take their tables contiguous on the card
    assert all(t.is_contiguous() for t in (fp.tabc, fp.tabc_s, fp.tabd_s))
    for t, j in _both(fj, fp, x, mass, x[::7]):
        close(t, j)


def test_hernq_pallas_through_k1_k2_plain(halo):
    """hernq with backend 'pallas' (f32, lmax 4, nmax 10): the port runs
    K1's and K2's plain versions on the CPU, exp_tpu its Pallas kernels in
    interpret mode, on the same particles and the same f64-derived
    coefficients; within tests/test_spherical_force.py:270-294's bounds
    of each other."""
    _, x, mass = halo
    kw = dict(rmin=1e-3, rmax=60.0, numr=1000)
    fj = janalytic.make_analytic_force("hernq", 4, 10, dtype=jnp.float32,
                                       backend="pallas", **kw)
    fp = panalytic.make_analytic_force("hernq", 4, 10, dtype=torch.float32,
                                       backend="pallas", device="cpu", **kw)
    assert fp._interp_eff == "spline" and fp._harmonics_eff("coef") == "poly"
    xs, ms = x[:2048], mass[:2048]
    cj = np.asarray(fj.coefficients(jnp.asarray(xs, jnp.float32),
                                    jnp.asarray(ms, jnp.float32)))
    cp = fp.coefficients(torch.tensor(xs, dtype=torch.float32),
                         torch.tensor(ms, dtype=torch.float32)).numpy()
    assert np.abs(cp - cj).max() / np.abs(cj).max() < 5e-5
    pts = x[:300]
    aj, pj = fj.acceleration(jnp.asarray(cj), jnp.asarray(pts, jnp.float32))
    ap, pp = fp.acceleration(torch.tensor(cj),
                             torch.tensor(pts, dtype=torch.float32))
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=2e-3,
                               atol=2e-5)
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), rtol=2e-4,
                               atol=1e-6)


def test_analytic_physics_bar(halo):
    """tests/test_more_forces.py's bar on the port: hernq reproduces its
    own Hernquist halo's M(<r)/r^2 to a median 3% on 12 radii."""
    m, x, mass = halo
    f = panalytic.make_analytic_force("hernq", 2, 8, rmin=1e-3, rmax=60.0,
                                      dtype=F64, device="cpu")
    c = f.coefficients(torch.tensor(x), torch.tensor(mass), accum_dtype=F64)
    pts = np.stack([np.geomspace(0.1, 10, 12), np.zeros(12), np.zeros(12)],
                   -1)
    acc, _ = f.acceleration(c, torch.tensor(pts))
    exact = m.get_mass(pts[:, 0]) / pts[:, 0] ** 2
    assert np.median(np.abs(-acc[:, 0].numpy() / exact - 1.0)) < 0.03


# ---------------------------------------------------------------------------
# shells and halobulge
# ---------------------------------------------------------------------------

def test_shells_match(halo):
    """ShellsForce: exp_tpu's floor(tb) bins summed by index_add_ in
    another order, so M(<r) and the fields agree to EXACT, not bit for
    bit."""
    _, x, mass = halo
    pts = np.concatenate([x[::5], [[0.0, 0.0, 1e-7], [20.0, 0.0, 0.0]]])
    for t, j in _both(JShells(rmax=10.0, nbins=64), ShellsForce(10.0, 64),
                      x, mass, pts):
        close(t, j)


def test_halobulge_matches(halo):
    """HaloBulgeForce on the halo's model table, in f64 and f32 (f32 to
    4e-7 of the largest value: log r and the interpolation round in
    f32 on both sides)."""
    m, x, _ = halo
    pts = np.concatenate([x[::5], [[80.0, 0.0, 0.0], [0.0, 1e-5, 0.0]]])
    pm = SphericalModelTable(m.r, m.rho, m.mass, m.pot)
    for jd, td, tol in ((jnp.float64, F64, EXACT),
                        (jnp.float32, torch.float32, 4e-7)):
        fj = JHaloBulge.from_model(m, dtype=jd)
        fp = HaloBulgeForce.from_model(pm, dtype=td)
        aj, pj = fj.acceleration(None, jnp.asarray(pts, jd))
        ap, pp = fp.acceleration(None, torch.tensor(pts, dtype=td))
        close(ap, aj, tol)
        close(pp, pj, tol)
        assert fp.coefficients(torch.tensor(pts, dtype=td), None).shape == (1,)


# ---------------------------------------------------------------------------
# direct summation
# ---------------------------------------------------------------------------

def _direct_pair(kind, **kw):
    if kind == "pm":
        mod = plummer_model(a=0.5, M=1.0, rmin=1e-3, rmax=5.0)
        pmod = SphericalModelTable(mod.r, mod.rho, mod.mass, mod.pot)
        return (JDirect.with_pm_model(mod, eps=1e-3, kernel="plummer", **kw),
                DirectForce.with_pm_model(pmod, eps=1e-3, kernel="plummer",
                                          **kw))
    args = {"plummer": dict(eps=0.05, kernel="plummer"),
            "spline": dict(eps=0.3, kernel="spline"),
            "mn": dict(mn_model=True, a=0.8, b=0.2)}[kind]
    return JDirect(**args, **kw), DirectForce(**args, **kw)


@pytest.mark.parametrize("kind", ["plummer", "spline", "mn", "pm"])
@pytest.mark.parametrize("chunked", [False, True])
def test_direct_matches(halo, kind, chunked):
    """DirectForce in each source model on the halo's 3,000 sources (the
    massless row skipped, self-pairs skipped): all sources at once, and
    exp_tpu's chunked branch (n % chunk == 0 and n > chunk: 3,000 sources
    in chunks of 500) with the port's target chunks too (tmp_bytes
    small enough for 64 targets a chunk); f64 to EXACT."""
    _, x, mass = halo
    xs, ms = x[:3000], mass[:3000]
    kw = dict(chunk=500) if chunked else {}
    fj, fp = _direct_pair(kind, **kw)
    if chunked:
        fp.tmp_bytes = 64 * 500 * 16 * 8
        assert fp.target_chunk(3000, F64) == 64
    pts = np.concatenate([x[:3000:3], x[3000:]])
    cj = fj.coefficients(jnp.asarray(xs), jnp.asarray(ms))
    cp = fp.coefficients(torch.tensor(xs), torch.tensor(ms))
    aj, pj = fj.acceleration(cj, jnp.asarray(pts))
    ap, pp = fp.acceleration(cp, torch.tensor(pts))
    assert np.isfinite(ap.numpy()).all() and np.isfinite(pp.numpy()).all()
    close(ap, aj)
    close(pp, pj)


def test_direct_ring_waits_for_multi_device(monkeypatch):
    """The ring over a World's ranks (exp_tpu's ppermute ring): rank r adds
    the source block of rank (r - i) mod size at pass i.  The blocks of a
    3-rank world are handed in by a stand-in for the gather (the 2-rank
    gloo world runs in tests/test_torch_distributed.py); each rank's sum
    is the three partial sums in its ring order, bit for bit, and within
    1e-12 of the one-rank sum over all sources."""
    from exp_tpu_torch.parallel import distributed as pdist
    from exp_tpu_torch.parallel.distributed import World

    rng = np.random.default_rng(4)
    blocks = [(torch.tensor(rng.normal(size=(n, 3))),
               torch.tensor(rng.uniform(0.5, 1.5, n))) for n in (7, 5, 9)]
    src = torch.cat([torch.cat([xs, ms[:, None]], 1) for xs, ms in blocks])
    monkeypatch.setattr(pdist, "allgather_rows",
                        lambda t, world: (src, [7, 5, 9]))
    f = DirectForce(eps=0.05)
    x = torch.tensor(rng.normal(size=(6, 3)))
    xa = torch.cat([b[0] for b in blocks])
    ma = torch.cat([b[1] for b in blocks])
    a1, p1 = f.acceleration((xa, ma), x)
    for r in range(3):
        a, p = f.acceleration(blocks[r], x, group=World(rank=r, size=3))
        acc = torch.zeros_like(x)
        pot = torch.zeros(6, dtype=F64)
        for i in range(3):
            aa, pp = f.acceleration(blocks[(r - i) % 3], x)
            acc, pot = acc + aa, pot + pp
        assert torch.equal(a, acc) and torch.equal(p, pot), r
        np.testing.assert_allclose(a.numpy(), a1.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(a1.abs().max()))
        np.testing.assert_allclose(p.numpy(), p1.numpy(), rtol=1e-12)
    # a one-rank world sums its own sources only
    a, p = f.acceleration(blocks[0], x, group=World())
    assert torch.equal(a, f.acceleration(blocks[0], x)[0])


def test_interp_matches_jnp_interp():
    """The port's interp against jnp.interp: inside, on nodes, outside on
    both sides, repeated nodes, f32 tables at f64 points, and explicit
    left/right values; to 1e-15 of the largest value (XLA's compiled
    interp may contract its multiply-add into one rounding)."""
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(0.0, 5.0, 40))
    xp[10] = xp[11]
    fp = rng.normal(size=40)
    x = np.concatenate([rng.uniform(-1.0, 6.0, 500), xp])
    for fdt in (np.float64, np.float32):
        for lr in ((None, None), (0.0, -2.5)):
            j = jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                           jnp.asarray(fp.astype(fdt)), *lr)
            t = interp(torch.tensor(x), torch.tensor(xp),
                       torch.tensor(fp.astype(fdt)), *lr)
            assert t.dtype == torch.float64
            close(t, j, 1e-15)
