"""K7/K11a and K8/K11b of the port against exp_tpu's Pallas cube kernels.

The port's plain versions (the code the kernel wrappers take for CPU
tensors) against the JAX kernels make_cube_coef_kernel_v2 (K7),
make_cube_coef_kernel (K11a), make_cube_accel_kernel_v2 (K8) and
make_cube_accel_kernel (K11b), run in interpret mode on the CPU on
pad_particles + pack_xyzm input (the TPU layout, built here on the test
side only).  The force kernels get the same b = coef * norm through each
package's packing.  Inputs: 1500 particles, not a multiple of the TPU's
1024-particle block, drawn over [-0.2, 1.2) so that the wrap matters, plus
the edge rows x = 1.0, -1e-7, -2.75, 3.25, 1000.3 and a zero-mass row.
The CUDA kernels against these plain versions on the card:
tests/test_torch_gpu.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.forces.cube import Cube as JCube
from exp_tpu.ic.cubeics import sample_cube as j_sample_cube
from exp_tpu.ops import pallas_cube as pk
from exp_tpu.ops.padding import pack_xyzm, pad_particles

from exp_tpu_torch.convert import complex_from_numpy, cube_from_numpy
from exp_tpu_torch.forces.cube import Cube
from exp_tpu_torch.ic.cubeics import sample_cube
from exp_tpu_torch.ops import cube_kernels as ck


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
NMAXES = [(3, 3, 3), (4, 3, 2)]

EDGE_X = np.array([[1.0, -1e-7, -2.75],
                   [3.25, 1000.3, 0.5],
                   [-1e-7, 1.0, 1000.3],
                   [-2.75, 3.25, 1.0],
                   [0.3, 0.2, 0.1]])            # zero mass below
EDGE_M = np.array([1e-3] * 4 + [0.0])


def cube_inputs():
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.2, 1.2, (N_SAMPLE, 3))
    m = rng.uniform(0.5, 1.5, N_SAMPLE) / N_SAMPLE
    x = np.concatenate([x, EDGE_X]).astype(np.float32)
    m = np.concatenate([m, EDGE_M]).astype(np.float32)
    assert x.shape[0] % 1024 != 0
    return x, m


@pytest.fixture(scope="module", params=NMAXES, ids=lambda p: "nmax%d%d%d" % p)
def setup(request):
    nm = request.param
    x, m = cube_inputs()
    prm = ck.CubeKernelParams(*nm)
    xp, mp, _ = pad_particles(jnp.asarray(x), jnp.asarray(m))
    x8 = pack_xyzm(xp, mp)
    S2 = np.asarray(pk.make_cube_coef_kernel_v2(*nm, interpret=True)(x8))
    S1 = np.asarray(pk.make_cube_coef_kernel(*nm, interpret=True)(x8))
    norm = np.asarray(JCube.create(*nm, dtype=jnp.float32).norm)
    b = (-S2 * norm * norm).astype(np.complex64)     # coef * norm
    return nm, prm, x, m, S2, S1, b


def _k_nonzero(shape):
    mask = np.ones(shape, bool)
    mask[tuple(s // 2 for s in shape)] = False
    return mask


def test_k7_plain_matches_jax_kernels(setup):
    """The raw sums S over k != 0 (S at k = 0 is the total mass, ~sqrt(N)
    times any other entry, and would hide the errors): max|dS|/max|S|
    measured 2.6e-7 against both the v2 and v1 kernels, f32 sums in
    another order; gated at 2e-6.  S at k = 0 to 1e-6 relative."""
    nm, prm, x, m, S2, S1, _ = setup
    Sp = ck.cube_coef_plain(torch.from_numpy(x), torch.from_numpy(m), prm)
    assert Sp.dtype == torch.complex64 and tuple(Sp.shape) == prm.shape
    Sp = Sp.numpy()
    mask = _k_nonzero(prm.shape)
    for Sj in (S2, S1):
        scale = np.abs(Sj[mask]).max()
        assert np.abs(Sp - Sj)[mask].max() / scale < 2e-6
        assert Sp[~mask][0] == pytest.approx(Sj[~mask][0], rel=1e-6)


def test_k7_zero_mass_and_wrap(setup):
    """Zero-mass rows add exactly 0; positions shifted by whole periods
    give the same sums to f32 phase rounding (|x| up to 1000.3: the angle
    2 pi k u is rounded after the wrap, 2e-6 of the sums' scale)."""
    nm, prm, x, m, _, _, _ = setup
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    assert ck.cube_coef_plain(xt, torch.zeros_like(mt), prm).abs().max() == 0
    assert ck.cube_coef_plain(xt[-1:], mt[-1:], prm).abs().max() == 0
    S = ck.cube_coef_plain(xt, mt, prm)
    Ss = ck.cube_coef_plain(xt + torch.tensor([3.0, -2.0, 1.0]), mt, prm)
    assert float((S - Ss).abs().max() / S.abs().max()) < 2e-6


@pytest.mark.parametrize("version", [2, 1])
def test_k8_plain_matches_jax_kernels(setup, version):
    """Acceleration and potential from the same b: the port's folded table
    through cube_accel_plain (v2) or its v1 entry cube_accel_v1 fed by
    pack_force_matrix, against the JAX v2 (M2) or v1 (R_re, R_im) kernel.
    max|da|/max|a| and max|dpot|/max|pot| measured 3.0e-7 and 2.6e-7;
    gated at 2e-6, 100x tighter than tests/test_cube_force.py:155-164
    (rtol 2e-4, atol 2e-5 of max|a|).  The edge rows are finite and held to
    the same bound."""
    nm, prm, x, _, _, _, b = setup
    n = x.shape[0]
    xp, _, _ = pad_particles(jnp.asarray(x))
    x8 = pack_xyzm(xp, jnp.zeros(xp.shape[0], jnp.float32))
    bj = jnp.asarray(b)
    bt = torch.from_numpy(b)
    xt = torch.from_numpy(x)
    if version == 2:
        out = pk.make_cube_accel_kernel_v2(*nm, interpret=True)(
            x8, pk.pack_force_matrix_v2(bj, *nm))
        a, p = ck.cube_accel_plain(xt, ck.cube_force_table(bt, prm), prm)
    else:
        out = pk.make_cube_accel_kernel(*nm, interpret=True)(
            x8, *pk.pack_force_matrix(bj, *nm))
        a, p = ck.cube_accel_v1(xt, *ck.pack_force_matrix(bt, *nm), prm)
    out = np.asarray(out)[:, :n]
    aj, pj = out[:3].T, out[3]
    a, p = a.numpy(), p.numpy()
    assert a.dtype == np.float32 and a.shape == aj.shape
    assert np.isfinite(a).all() and np.isfinite(p).all()
    ascale, pscale = np.abs(aj).max(), np.abs(pj).max()
    assert np.abs(a - aj).max() / ascale < 2e-6
    assert np.abs(p - pj).max() / pscale < 2e-6
    edge = slice(N_SAMPLE, None)
    assert np.abs(a[edge] - aj[edge]).max() / ascale < 2e-6
    assert np.abs(p[edge] - pj[edge]).max() / pscale < 2e-6


def test_port_packings_equal_the_jax_packings(setup):
    """pack_force_matrix and pack_force_matrix_v2 copied as port functions
    give the JAX packings bit for bit, and the v1 entry reads b back
    exactly, so v1 and v2 give the same force bit for bit."""
    nm, prm, x, _, _, _, b = setup
    bt = torch.from_numpy(b)
    Rr, Ri = ck.pack_force_matrix(bt, *nm)
    Rrj, Rij = pk.pack_force_matrix(jnp.asarray(b), *nm)
    np.testing.assert_array_equal(Rr.numpy(), np.asarray(Rrj))
    np.testing.assert_array_equal(Ri.numpy(), np.asarray(Rij))
    np.testing.assert_array_equal(
        ck.pack_force_matrix_v2(bt, *nm).numpy(),
        np.asarray(pk.pack_force_matrix_v2(jnp.asarray(b), *nm)))
    assert torch.equal(ck.v1_matrix_to_b(Rr, Ri, prm), bt)
    xt = torch.from_numpy(x)
    a1, p1 = ck.cube_accel_v1(xt, Rr, Ri, prm)
    a2, p2 = ck.cube_accel(xt, ck.cube_force_table(bt, prm), prm)
    assert torch.equal(a1, a2) and torch.equal(p1, p2)


def test_folded_table_keeps_the_force_of_any_b():
    """The fold onto kx >= 0 needs no symmetry of b: for a random complex
    b (not Hermitian) the folded force equals the unfolded sum
    Re/Im sum_k b_k e_k over the full lattice, computed here in f64
    (f32 rounding of the folded path: 1e-5 of the scale)."""
    nm = (2, 3, 2)
    prm = ck.CubeKernelParams(*nm)
    rng = np.random.default_rng(11)
    b = (rng.normal(size=prm.shape) + 1j * rng.normal(size=prm.shape))
    x = rng.uniform(-1, 2, (200, 3))
    a, p = ck.cube_accel_plain(torch.tensor(x, dtype=torch.float32),
                               ck.cube_force_table(torch.from_numpy(b), prm),
                               prm)
    ks = [np.arange(-n, n + 1) for n in nm]
    K = np.stack(np.meshgrid(*ks, indexing="ij"), -1).reshape(-1, 3)
    e = np.exp(2j * np.pi * (x - np.floor(x)) @ K.T)         # (N, K)
    w = e * b.reshape(-1)[None, :]
    pot = w.real.sum(1)
    acc = np.stack([(w.imag * 2 * np.pi * K[:, c]).sum(1) for c in range(3)],
                   -1)
    assert np.abs(p.numpy() - pot).max() < 1e-5 * np.abs(pot).max()
    assert np.abs(a.numpy() - acc).max() < 1e-5 * np.abs(acc).max()


def test_sample_cube_is_the_jax_samplers():
    """The same seed gives the same arrays bit for bit, with and without
    the rejection-sampled perturbation."""
    for kw in ({}, {"sigma": 0.1, "pert_k": (1, 0, 0), "pert_amp": 0.5},
               {"pert_k": (1, 2, 0), "pert_amp": -0.3, "mass": 2.0}):
        for a, b in zip(sample_cube(3001, seed=5, **kw),
                        j_sample_cube(3001, seed=5, **kw)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cube_from_numpy_equals_create(dtype):
    """convert.cube_from_numpy on the JAX Cube's arrays builds the port's
    own Cube.create for the same arguments, buffer for buffer."""
    kw = dict(nmaxx=4, nmaxy=3, nmaxz=2, nminx=1, nminy=0, nminz=1)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    jc = JCube.create(dtype=jd, backend="pallas", **kw)
    pc = cube_from_numpy(np.asarray(jc.norm), np.asarray(jc.lap), dtype=dtype,
                         backend="pallas", device="cpu", **kw)
    own = Cube.create(dtype=dtype, backend="pallas", device="cpu", **kw)
    assert torch.equal(pc.norm, own.norm) and torch.equal(pc.lap, own.lap)
    assert pc.norm.dtype == dtype
    assert (pc.coef_shape, pc.backend) == (own.coef_shape, "pallas")
    with pytest.raises(ValueError, match="shape"):
        cube_from_numpy(np.asarray(jc.norm)[1:], np.asarray(jc.lap),
                        device="cpu", **kw)
    c = complex_from_numpy(np.array([1 + 2j, 3j]), device="cpu")
    assert c.dtype == torch.complex128 and c[1].imag == 3.0
    with pytest.raises(TypeError, match="complex"):
        complex_from_numpy(np.ones(2), device="cpu")


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on any other non-CUDA device raises (there is no fallback); an nmax
    outside the kernels' range raises NotImplementedError."""
    x, m = cube_inputs()
    prm = ck.CubeKernelParams(3, 3, 3)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    before = dict(ck.launch_counts)
    assert torch.equal(ck.cube_coef(xt, mt, prm),
                       ck.cube_coef_plain(xt, mt, prm))
    tab = ck.cube_force_table(ck.cube_coef_plain(xt, mt, prm), prm)
    a, p = ck.cube_accel(xt, tab, prm)
    a0, p0 = ck.cube_accel_plain(xt, tab, prm)
    assert torch.equal(a, a0) and torch.equal(p, p0)
    assert ck.launch_counts == before
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.cube_coef(meta, torch.empty(4, device="meta"), prm)
    with pytest.raises(ValueError, match="unsupported device"):
        ck.cube_accel(meta, tab.to("meta"), prm)
    big = ck.CubeKernelParams(9, 3, 3)
    with pytest.raises(NotImplementedError, match="nmax"):
        ck.cube_coef(xt, mt, big)
    with pytest.raises(NotImplementedError, match="nmax"):
        Cube.create(3, 3, 9, backend="pallas", device="cpu")
    Cube.create(3, 3, 9, device="cpu")          # the einsum path takes any
