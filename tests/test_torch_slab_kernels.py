"""K9 and K10 of the port against exp_tpu's Pallas slab kernels.

The port's plain versions (the code the kernel wrappers take for CPU
tensors) against make_slab_coef_kernel (K9) and make_slab_accel_kernel
(K10), run in interpret mode on the CPU on pad_particles + pack_xyzm input
(the TPU layout, built here on the test side only).  The force kernels get
the same coefficients through each package's packing: the JAX Ct and Aux
(contract_slab_tables, slab_accel_aux) and the port's folded table and
boundary rows (slab_force_table, slab_force_aux).  Inputs: 1500 particles,
not a multiple of the TPU's 1024-particle block, with x, y over [-0.3, 1.3)
so that the wrap matters, a sample half outside |z| <= zmax, and edge rows
at the wrap's edges, at and near the faces z = +-zmax and beyond them, and
a zero-mass row.  The CUDA kernels against these plain versions on the
card: tests/test_torch_gpu.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.slab import build_slab_tables as j_build
from exp_tpu.forces.slab import SlabForce as JSlabForce
from exp_tpu.ops import pallas_slab as pk
from exp_tpu.ops.padding import pack_xyzm, pad_particles

from exp_tpu_torch.forces.slab import SlabForce
from exp_tpu_torch.ops import slab_kernels as sk


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


ZMAX = 0.1
NZC = 126
EDGE_X = np.array([[1.0, -1e-7, 0.1], [-1e-7, -2.75, -0.1],
                   [-2.75, 1000.3, 0.0999], [1000.3, 1.0, 0.1001],
                   [1.0, -1e-7, -0.0999], [-1e-7, -2.75, -0.1001],
                   [-2.75, 1000.3, 0.3], [1000.3, 1.0, -0.3],
                   [1.0, -1e-7, 1.0], [-1e-7, -2.75, -1.0],
                   [0.3, 0.2, 0.01]])            # zero mass below
EDGE_M = np.array([1e-3] * 10 + [0.0])


def slab_inputs(outside=False, n=1500):
    """The sheet (or, for `outside`, half of it at zmax < |z| <= 3 zmax of
    both signs, as tests/test_slab_pallas.py:86-111) plus the edge rows,
    f32."""
    rng = np.random.default_rng(11 if outside else 8)
    z = rng.normal(0, 0.02, n)
    if outside:
        k = n // 2
        z[k:] = rng.uniform(ZMAX, 3 * ZMAX, n - k) * rng.choice([-1, 1], n - k)
    x = np.stack([rng.uniform(-0.3, 1.3, n), rng.uniform(-0.3, 1.3, n), z], -1)
    m = rng.uniform(0.5, 1.5, n) / n
    x = np.concatenate([x, EDGE_X]).astype(np.float32)
    m = np.concatenate([m, EDGE_M]).astype(np.float32)
    assert x.shape[0] % 1024 != 0
    return x, m


@pytest.fixture(scope="module", params=[(2, 2), (3, 2)],
                ids=lambda p: "nmax%d%d" % p)
def tables(request):
    nx, ny = request.param
    return j_build(nmaxx=nx, nmaxy=ny, nmax=4, zmax=ZMAX, h=0.01, numz=201)


def _jax_G(t, x, m, interp):
    xp, mp, _ = pad_particles(jnp.asarray(x), jnp.asarray(m))
    fn = pk.make_slab_coef_kernel(t.nmaxx, t.nmaxy, NZC, ZMAX,
                                  interpret=True, interp=interp)
    return np.asarray(fn(pack_xyzm(xp, mp)))


@pytest.mark.parametrize("interp", ["spline", "linear"])
def test_k9_plain_matches_jax_kernel(tables, interp):
    """G over k != 0 (shot noise of the uniform (x, y)) and the k = 0 row
    (the mass profile, ~sqrt(N) times larger), each relative to its own
    largest value: measured up to 5.2e-6 and 1.2e-6 (f32 sums in another
    order), gated at 2e-5.  The coefficients after each package's
    contract_coef_output: measured 2.2e-7 of max|c|, gated at 1e-5
    (tests/test_slab_pallas.py:39 holds the pallas coefficients to 2e-3 of
    the einsum path's).  Real weights give G(-k) = conj G(k)."""
    x, m = slab_inputs()
    prm = sk.SlabKernelParams(tables.nmaxx, tables.nmaxy, NZC, ZMAX, interp)
    Gj = _jax_G(tables, x, m, interp)
    Gp = sk.slab_coef_plain(torch.from_numpy(x), torch.from_numpy(m), prm)
    assert Gp.dtype == torch.complex64 and tuple(Gp.shape) == (prm.C,
                                                               prm.zrows)
    Gp = Gp.numpy()
    ctr = (prm.C - 1) // 2
    kn = np.arange(prm.C) != ctr
    g_rel = np.abs(Gp - Gj)[kn].max() / np.abs(Gj[kn]).max()
    g0_rel = np.abs(Gp - Gj)[ctr].max() / np.abs(Gj[ctr]).max()
    assert g_rel < 2e-5 and g0_rel < 2e-5
    assert np.abs(Gp[::-1] - np.conj(Gp)).max() < 1e-6 * np.abs(Gp).max()
    jf = JSlabForce.from_tables(tables, backend="pallas", nzc=NZC,
                                pallas_interp=interp)
    cj = np.asarray(pk.contract_coef_output(jnp.asarray(Gj), jf.phi_s,
                                            jf.sgn))
    cp = sk.contract_coef_output(torch.from_numpy(Gp),
                                 torch.from_numpy(np.array(jf.phi_s)),
                                 torch.from_numpy(np.array(jf.sgn))).numpy()
    c_rel = np.abs(cp - cj).max() / np.abs(cj).max()
    print(f"K9 plain vs JAX: G {g_rel:.2e} (k != 0), {g0_rel:.2e} (k = 0); "
          f"coefficients {c_rel:.2e}")
    assert c_rel < 1e-5


def test_k9_zero_mass_outside_and_wrap(tables):
    """Zero-mass rows and rows beyond |z| = zmax add exactly 0; positions
    shifted by whole periods in x and y give the same sums to f32 phase
    rounding (the angle 2 pi k u is rounded after the wrap: 2e-6 of the
    sums' scale)."""
    x, m = slab_inputs(outside=True)
    prm = sk.SlabKernelParams(tables.nmaxx, tables.nmaxy, NZC, ZMAX)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    assert sk.slab_coef_plain(xt, torch.zeros_like(mt), prm).abs().max() == 0
    dead = (mt == 0) | (xt[:, 2].abs() > ZMAX)
    assert int(dead.sum()) > 700
    assert sk.slab_coef_plain(xt[dead], mt[dead], prm).abs().max() == 0
    G = sk.slab_coef_plain(xt, mt, prm)
    Gs = sk.slab_coef_plain(xt + torch.tensor([3.0, -2.0, 0.0]), mt, prm)
    assert float((G - Gs).abs().max() / G.abs().max()) < 2e-6


def _coef(tables, interp):
    """Coefficients of the outside sample through JAX's pallas backend
    (its K9 in interpret mode), shared by both packages' force passes."""
    x, m = slab_inputs(outside=True)
    jf = JSlabForce.from_tables(tables, backend="pallas", nzc=NZC,
                                pallas_interp=interp)
    return jf, np.array(jf.coefficients_local(jnp.asarray(x),
                                              jnp.asarray(m)))


@pytest.mark.parametrize("outside", [False, True], ids=["sheet", "outside"])
@pytest.mark.parametrize("interp", ["spline", "linear"])
def test_k10_plain_matches_jax_kernel(tables, interp, outside):
    """Acceleration and potential from the same coefficients: the JAX Ct
    and Aux through make_slab_accel_kernel against the port's folded table
    and boundary rows through slab_accel_plain.  The JAX kernel rounds its
    z-profile matmul (bf16x3) and its phase outer product (2-pass bf16) to
    ~1e-5 even in interpret mode: max|da|/max|a| measured up to 7.2e-6 and
    max|dpot|/max|pot| 8.4e-7; gated at 5e-5, 100x tighter than
    tests/test_slab_pallas.py:44-45 (5e-3).  Rows beyond zmax (the vacuum
    continuation) and the edge rows are held to the same bound."""
    jf, c = _coef(tables, interp)
    x, _ = slab_inputs(outside=outside)
    n = x.shape[0]
    nx, ny = tables.nmaxx, tables.nmaxy
    cj = jnp.asarray(c)
    Ct = pk.contract_slab_tables(cj, jf.phi_s, jf.dphi_s, nx, ny)
    Aux = pk.slab_accel_aux(cj, jf.phi_t[-1], jf.phi_t[0], jf.dphi_t[-1],
                            jf.dphi_t[0], nx, ny)
    xp, _, _ = pad_particles(jnp.asarray(x))
    out = pk.make_slab_accel_kernel(nx, ny, NZC, ZMAX, interpret=True,
                                    interp=interp)(
        pack_xyzm(xp, jnp.zeros(xp.shape[0], jnp.float32)), Ct, Aux)
    out = np.asarray(out)[:, :n]
    aj, pj = out[:3].T, out[3]

    pf = SlabForce.from_tables(tables, backend="pallas", nzc=NZC,
                               pallas_interp=interp, device="cpu")
    prm = pf._kernel_params()
    ct = torch.from_numpy(c)
    tab = sk.slab_force_table(ct, pf.zq_s, prm)
    aux = sk.slab_force_aux(ct, pf.bnd_s, prm)
    assert tab.shape == (prm.force_rows, prm.H, prm.kz, 4)
    assert aux.shape == (prm.H, 8)
    a, p = sk.slab_accel_plain(torch.from_numpy(x), tab, aux, prm)
    a, p = a.numpy(), p.numpy()
    assert a.dtype == np.float32 and a.shape == aj.shape
    assert np.isfinite(a).all() and np.isfinite(p).all()
    ascale, pscale = np.abs(aj).max(), np.abs(pj).max()
    a_rel = np.abs(a - aj).max() / ascale
    p_rel = np.abs(p - pj).max() / pscale
    print(f"K10 plain vs JAX: acc {a_rel:.2e}, pot {p_rel:.2e}")
    assert a_rel < 5e-5 and p_rel < 5e-5
    out_rows = np.abs(x[:, 2]) > ZMAX
    assert out_rows.sum() >= (750 if outside else 6)
    assert np.abs(a - aj)[out_rows].max() / ascale < 5e-5
    edge = slice(n - len(EDGE_X), None)
    assert np.abs(a[edge] - aj[edge]).max() / ascale < 5e-5
    assert np.abs(p[edge] - pj[edge]).max() / pscale < 5e-5


def test_port_packings_equal_the_jax_packings(tables):
    """resample_z copied as a port function, and signed_k, the port's
    expand_signed, give the JAX arrays bit for bit; the TPU packings contract_slab_tables and
    slab_accel_aux agree to f32 rounding of their complex contractions
    (1e-6 of each scale)."""
    jf, c = _coef(tables, "spline")
    np.testing.assert_array_equal(sk.resample_z(tables.phi, tables.numz, NZC),
                                  pk.resample_z(tables.phi, tables.numz, NZC))
    a = pk.resample_z(tables.dphi, tables.numz, NZC)
    np.testing.assert_array_equal(sk.signed_k(torch.from_numpy(a)).numpy(),
                                  pk.expand_signed(a))
    nx, ny = tables.nmaxx, tables.nmaxy
    cj, ct = jnp.asarray(c), torch.from_numpy(c)
    pf = SlabForce.from_tables(tables, backend="pallas", nzc=NZC,
                               device="cpu")
    Ctj = np.asarray(pk.contract_slab_tables(cj, jf.phi_s, jf.dphi_s, nx, ny))
    Ctp = sk.contract_slab_tables(ct, pf.phi_s, pf.dphi_s, nx, ny).numpy()
    assert Ctp.shape == Ctj.shape
    assert np.abs(Ctp - Ctj).max() <= 1e-6 * np.abs(Ctj).max()
    Auxj = np.asarray(pk.slab_accel_aux(cj, jf.phi_t[-1], jf.phi_t[0],
                                        jf.dphi_t[-1], jf.dphi_t[0], nx, ny))
    Auxp = sk.slab_accel_aux(ct, pf.phi_t[-1], pf.phi_t[0], pf.dphi_t[-1],
                             pf.dphi_t[0], nx, ny).numpy()
    assert Auxp.shape == Auxj.shape
    assert np.abs(Auxp - Auxj).max() <= 1e-6 * np.abs(Auxj).max()


def test_folded_tables_keep_the_force_of_any_coefficients():
    """The fold onto the half lattice needs no symmetry of the
    coefficients: for random complex coefficients (not Hermitian) the
    folded force equals the sum over the full lattice, computed here in
    f64 with the same z nodes and weights, inside the slab and beyond it
    (f32 rounding of the folded path: 1e-5 of the scale)."""
    t = j_build(nmaxx=2, nmaxy=3, nmax=4, zmax=ZMAX, h=0.01, numz=201)
    f = SlabForce.from_tables(t, backend="pallas", nzc=NZC, device="cpu")
    prm = f._kernel_params()
    rng = np.random.default_rng(5)
    c = rng.normal(size=f.coef_shape) + 1j * rng.normal(size=f.coef_shape)
    x, _ = slab_inputs(outside=True, n=400)
    a, p = sk.slab_accel_plain(
        torch.from_numpy(x), sk.slab_force_table(torch.from_numpy(c),
                                                 f.zq_s, prm),
        sk.slab_force_aux(torch.from_numpy(c), f.bnd_s, prm), prm)
    xd = x.astype(np.float64)
    u = xd[:, :2] - np.floor(xd[:, :2])
    kx, ky = np.meshgrid(np.arange(-2, 3), np.arange(-3, 4), indexing="ij")
    kx, ky = kx.reshape(-1), ky.reshape(-1)
    e = np.exp(2j * np.pi * (u[:, :1] * kx + u[:, 1:] * ky))     # (N, C)
    cf = c.reshape(prm.C, -1)
    zc = np.clip(x[:, 2], -ZMAX, ZMAX)
    j0, ws = sk.z_nodes(sk.z_grid(torch.from_numpy(zc), prm), prm)
    zq = torch.stack([f.phi_s, f.dphi_s]).double().reshape(
        2, prm.zrows, prm.C, -1).numpy()                          # (2, zr, C, n)
    T = sum(w.double().numpy()[:, None, None, None] * zq[:, j0 + k]
            .transpose(1, 0, 2, 3) for k, w in enumerate(ws))     # (N, 2, C, n)
    T = (T * cf[None, None]).sum(-1)
    pot = (T[:, 0] * e).real.sum(1)
    ax = ((T[:, 0] * e).imag * 2 * np.pi * kx).sum(1)
    ay = ((T[:, 0] * e).imag * 2 * np.pi * ky).sum(1)
    az = -(T[:, 1] * e).real.sum(1)
    bnd = f.bnd_s.double().numpy()                                # (4, C, n)
    B = (bnd * cf[None]).sum(-1)                                  # (4, C)
    dz = np.abs(xd[:, 2]) - ZMAX
    top = xd[:, 2] >= 0
    s = np.where(top, 1.0, -1.0)
    km = 2 * np.pi * np.sqrt(kx ** 2.0 + ky ** 2.0)
    OE = np.where(top[:, None], B[0], B[1]) * e * np.exp(-km * dz[:, None])
    td = np.where(top, B[2, prm.H - 1], B[3, prm.H - 1]).real
    out = dz > 0
    pot = np.where(out, OE.real.sum(1) + td * dz * s, pot)
    ax = np.where(out, (OE.imag * 2 * np.pi * kx).sum(1), ax)
    ay = np.where(out, (OE.imag * 2 * np.pi * ky).sum(1), ay)
    az = np.where(out, -td + s * (km * OE.real).sum(1), az)
    acc = np.stack([ax, ay, az], -1)
    assert out.sum() > 150
    assert np.abs(p.numpy() - pot).max() < 1e-5 * np.abs(pot).max()
    assert np.abs(a.numpy() - acc).max() < 1e-5 * np.abs(acc).max()


def test_wrappers_take_the_plain_version_only_on_the_cpu(tables):
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on any other non-CUDA device raises (there is no fallback); a geometry
    outside the kernels' range raises NotImplementedError."""
    x, m = slab_inputs(outside=True)
    prm = sk.SlabKernelParams(tables.nmaxx, tables.nmaxy, NZC, ZMAX)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    before = dict(sk.launch_counts)
    G = sk.slab_coef(xt, mt, prm)
    assert torch.equal(G, sk.slab_coef_plain(xt, mt, prm))
    f = SlabForce.from_tables(tables, backend="pallas", device="cpu")
    c = sk.contract_coef_output(G, f.phi_s, f.sgn)
    tab = sk.slab_force_table(c, f.zq_s, prm)
    aux = sk.slab_force_aux(c, f.bnd_s, prm)
    a, p = sk.slab_accel(xt, tab, aux, prm)
    a0, p0 = sk.slab_accel_plain(xt, tab, aux, prm)
    assert torch.equal(a, a0) and torch.equal(p, p0)
    assert sk.launch_counts == before
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sk.slab_coef(meta, torch.empty(4, device="meta"), prm)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.slab_accel(meta, tab.to("meta"), aux.to("meta"), prm)
    for bad in (sk.SlabKernelParams(9, 2, NZC, ZMAX),
                sk.SlabKernelParams(2, 2, 127, ZMAX),
                sk.SlabKernelParams(2, 2, 1, ZMAX, "linear")):
        with pytest.raises(NotImplementedError):
            sk.slab_coef(xt, mt, bad)
    sk.check_params(sk.SlabKernelParams(8, 8, 128, ZMAX, "linear"))
