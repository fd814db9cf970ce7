"""The algebra and launch plans of the tensor-core cube kernels K7
(csrc/cube_coef.cu) and K8 (csrc/cube_accel.cu), on the CPU.

A plain-torch emulation of what the kernels compute -- the kz axis folded
into cosines and sines over the half (kx, ky) lattice, K8's folded table of
4 real columns a row (ky folded with -ky on the plane kx = 0), and every
product as three TF32 passes of operands split hi + lo with the rounding
of cvt.rna.tf32.f32 emulated on the bits -- against the port's plain
versions (cube_coef_plain, cube_accel_plain) and the JAX v2 kernels in
interpret mode, at the nmax sets of tests/test_torch_gpu.py (CUBE_NMAX),
under the tolerances chip_smoke.py's phase C2 holds the kernels to.  Then
the launch plans (ops/cube_kernels.coef_plan, accel_plan): pure arithmetic
at the H100's figures, for every nmax the kernels take; and the split
probe's patches against the kernels' sources.
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.forces.cube import Cube as JCube
from exp_tpu.ops import pallas_cube as pk
from exp_tpu.ops.padding import pack_xyzm, pad_particles

from exp_tpu_torch.bench_cube import cube_sample
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


CUBE_NMAX = [(3, 3, 3), (6, 6, 6), (4, 3, 2), (0, 8, 1), (8, 8, 8)]
N_SAMPLE = 2_003                 # not a multiple of K7's 64 or K8's 32
EDGE_X = [[1.0, -1e-7, -2.75], [3.25, 1000.3, 0.5], [-1e-7, 1.0, 1000.3],
          [-2.75, 3.25, 1.0], [0.3, 0.2, 0.1]]        # zero mass last
# chip_smoke.py C2: K7 max|dc|/max|c|, K8 of the largest |a| and |pot|
COEF_RTOL = {False: 1e-4, True: 5e-6}
FORCE_RTOL = 2e-5
H100_SMS, H100_OPTIN = 132, 232_448

_TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# the emulation

def tf32_round(x):
    """f32 rounded to TF32 as the kernels round it (tf32_mma.cuh round):
    half an ulp of 10 mantissa bits added to the magnitude, 13 low bits
    cleared; for finite x, cvt.rna.tf32.f32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32x3(a, b):
    """a @ b as three TF32 passes, hi hi + hi lo + lo hi: the tensor core
    multiplies TF32 values exactly (f64 here) and adds in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    d = lambda p, q: p.double() @ q.double()            # noqa: E731
    return (d(al, bh) + d(ah, bl) + d(ah, bh)).float()


def half_pairs(prm):
    """The half (kx, ky) lattice in the kernels' order: kx = 0 with ky =
    0..nmaxy, then kx = 1..nmaxx with every ky."""
    return ([(0, b) for b in range(prm.nmaxy + 1)]
            + [(a, b) for a in range(1, prm.nmaxx + 1)
               for b in range(-prm.nmaxy, prm.nmaxy + 1)])


def phase_powers(u, nmax, sign):
    """e^{sign 2 pi i k u}, k = 0..nmax, (N, nmax + 1) complex64, as the
    kernels make them: one correctly rounded e^{i t}, then powers by angle
    addition in f32."""
    t = (sign * _TWO_PI) * u.double()
    e1 = torch.complex(torch.cos(t), torch.sin(t)).to(torch.complex64)
    out = [torch.ones_like(e1)]
    for _ in range(nmax):
        out.append(out[-1] * e1)
    return torch.stack(out, dim=1)


def kz_phases(u, nmaxz):
    """[c_0..c_nz, s_1..s_nz] (N, 2 nmaxz + 1) of e^{+2 pi i q uz}."""
    p = phase_powers(u, nmaxz, 1.0)
    return torch.cat([p.real, p.imag[:, 1:]], dim=1)


def xy_rows(u, prm, sign, pairs):
    """e_x^a e_y^b for the pairs, (N, len(pairs)) complex64."""
    ex = phase_powers(u[:, 0], prm.nmaxx, sign)
    ey = phase_powers(u[:, 1], prm.nmaxy, sign)
    a = torch.tensor([p[0] for p in pairs])
    b = torch.tensor([p[1] for p in pairs])
    eyb = ey[:, b.abs()]
    eyb = torch.where(b < 0, eyb.conj(), eyb)
    return ex[:, a] * eyb


def emulate_coef(x, m, prm):
    """K7's algebra: U, V = [Re XY; Im XY] against [m c_q, m s_q] over the
    half lattice, S(a, b, +-q) = U -+ i V, and the rest by S(-k) =
    conj S(k)."""
    nz = prm.nmaxz
    pairs = half_pairs(prm)
    u = ck.wrap(x.float())
    XY = xy_rows(u, prm, -1.0, pairs)                    # (N, R)
    cols = m.float()[:, None] * kz_phases(u[:, 2], nz)   # (N, kz)
    R = len(pairs)
    G = tf32x3(torch.cat([XY.real, XY.imag], dim=1).T, cols)   # (2R, kz)
    U = torch.complex(G[:R, :nz + 1], G[R:, :nz + 1])
    V = torch.zeros_like(U)
    V[:, 1:] = torch.complex(G[:R, nz + 1:], G[R:, nz + 1:])
    S = torch.zeros(prm.shape, dtype=torch.complex64)
    for i, (a, b) in enumerate(pairs):
        for q in range(nz + 1):
            for sgn, val in ((1, U[i, q] - 1j * V[i, q]),
                             (-1, U[i, q] + 1j * V[i, q])):
                if sgn < 0 and (q == 0 or (a == 0 and b == 0)):
                    continue
                k = (prm.nmaxx + a, prm.nmaxy + b, nz + sgn * q)
                S[k] = val
                S[(prm.nmaxx - a, prm.nmaxy - b, nz - sgn * q)] = val.conj()
    return S


def folded_table(tab, prm):
    """K8's B: (kz, 4 R) real, the columns Re t, Im t, Re t_z, Im t_z of
    each half-lattice row against the phases [c_0..c_nz, s_1..s_nz], from
    the force table (cube_force_table); the plane kx = 0 folds ky with -ky
    (t_b + conj t_-b, t_z,b - conj t_z,-b)."""
    T = torch.view_as_complex(tab)                       # (AX, KY, KZ)
    nz, ny = prm.nmaxz, prm.nmaxy
    q = torch.arange(1, nz + 1)

    def coefs(a, b):
        row = T[a, ny + b]
        tp, tm = row[nz + q], row[nz - q]
        P, D = tp + tm, tp - tm
        w = _TWO_PI * q.to(tab.dtype)
        t = torch.cat([row[nz:nz + 1], P, 1j * D])
        tz = torch.cat([torch.zeros(1, dtype=T.dtype), w * D, 1j * w * P])
        return t, tz

    cols = []
    for a, b in half_pairs(prm):
        t, tz = coefs(a, b)
        if a == 0 and b > 0:
            t2, tz2 = coefs(0, -b)
            t, tz = t + t2.conj(), tz - tz2.conj()
        cols += [t.real, t.imag, tz.real, tz.imag]
    return torch.stack(cols, dim=1).to(tab.dtype)


def emulate_accel(x, tab, prm):
    """K8's algebra: the phases against the folded table (three TF32
    passes), then e = e_x^a e_y^b a row: pot = Re sum t e, a_x, a_y = Im
    sum 2 pi (a, b) t e, a_z = Im sum t_z e."""
    pairs = half_pairs(prm)
    u = ck.wrap(x.float())
    D = tf32x3(kz_phases(u[:, 2], prm.nmaxz), folded_table(tab, prm))
    t = torch.complex(D[:, 0::4], D[:, 1::4])
    tz = torch.complex(D[:, 2::4], D[:, 3::4])
    e = xy_rows(u, prm, 1.0, pairs)
    w = t * e
    wa = _TWO_PI * torch.tensor([float(p[0]) for p in pairs])
    wb = _TWO_PI * torch.tensor([float(p[1]) for p in pairs])
    acc = torch.stack([(w.imag * wa).sum(1), (w.imag * wb).sum(1),
                       (tz * e).imag.sum(1)], dim=1)
    return acc, w.real.sum(1)


# ---------------------------------------------------------------------------
# inputs

def _inputs(perturbed):
    x, _, m = cube_sample(N_SAMPLE, perturbed=perturbed, seed=3)
    x = np.concatenate([x, EDGE_X]).astype(np.float32)
    m = np.concatenate([m, [1.0 / N_SAMPLE] * (len(EDGE_X) - 1) + [0.0]])
    return torch.from_numpy(x), torch.from_numpy(m.astype(np.float32))


def _norm(nm):
    return torch.from_numpy(np.array(JCube.create(*nm, dtype=jnp.float32)
                                     .norm))


@pytest.fixture(scope="module", params=CUBE_NMAX,
                ids=lambda p: "nmax%d%d%d" % p)
def case(request):
    """Per nmax: the JAX v2 coefficient sums of the perturbed sample (the
    TPU kernel in interpret mode) and the port's norm."""
    nm = request.param
    x, m = _inputs(True)
    xp, mp, _ = pad_particles(jnp.asarray(x.numpy()), jnp.asarray(m.numpy()))
    S2 = np.asarray(pk.make_cube_coef_kernel_v2(*nm, interpret=True)(
        pack_xyzm(xp, mp)))
    return nm, ck.CubeKernelParams(*nm), _norm(nm), torch.from_numpy(S2)


# ---------------------------------------------------------------------------
# K7

@pytest.mark.parametrize("perturbed", [False, True],
                         ids=["uniform", "perturbed"])
def test_k7_algebra_matches_the_plain_version(case, perturbed):
    """The folded split-TF32 sums against cube_coef_plain: max|dc|/max|c|
    within C2's tolerance (1e-4 uniform, 5e-6 perturbed; measured ~1e-7),
    S Hermitian bit for bit (each value and its mirror are written from
    one number), a zero mass exactly 0."""
    nm, prm, norm, _ = case
    x, m = _inputs(perturbed)
    S = emulate_coef(x, m, prm)
    S0 = ck.cube_coef_plain(x, m, prm)
    c, c0 = -S * norm, -S0 * norm
    assert float((c - c0).abs().max() / c0.abs().max()) <= COEF_RTOL[perturbed]
    assert torch.equal(S, S.flip(0, 1, 2).conj())
    assert float(emulate_coef(x[-1:], m[-1:], prm).abs().max()) == 0.0


def test_k7_algebra_matches_the_jax_kernel(case):
    """The same sums against make_cube_coef_kernel_v2 (interpret mode) on
    the perturbed sample, under C2's 5e-6 of max|c|."""
    nm, prm, norm, S2 = case
    x, m = _inputs(True)
    c = -emulate_coef(x, m, prm) * norm
    c2 = -S2 * norm
    assert float((c - c2).abs().max() / c2.abs().max()) <= COEF_RTOL[True]


# ---------------------------------------------------------------------------
# K8

def _table(case, perturbed):
    nm, prm, norm, _ = case
    x, m = _inputs(perturbed)
    b = -ck.cube_coef_plain(x, m, prm) * norm * norm
    return x, b, ck.cube_force_table(b, prm)


@pytest.mark.parametrize("perturbed", [False, True],
                         ids=["uniform", "perturbed"])
def test_k8_algebra_matches_the_plain_version(case, perturbed):
    """The folded table's split-TF32 product and epilogue against
    cube_accel_plain on the sample and its edge rows: within 2e-5 of the
    largest |a| and |pot| (C2)."""
    _, prm, _, _ = case
    x, _, tab = _table(case, perturbed)
    a, p = emulate_accel(x, tab, prm)
    a0, p0 = ck.cube_accel_plain(x, tab, prm)
    assert float((a - a0).abs().max()) <= FORCE_RTOL * float(a0.abs().max())
    assert float((p - p0).abs().max()) <= FORCE_RTOL * float(p0.abs().max())


def test_k8_algebra_matches_the_jax_kernel(case):
    """The same force against make_cube_accel_kernel_v2 (interpret mode)
    fed pack_force_matrix_v2 of the same b, under C2's 2e-5."""
    nm, prm, _, _ = case
    x, b, tab = _table(case, True)
    xp, _, _ = pad_particles(jnp.asarray(x.numpy()))
    x8 = pack_xyzm(xp, jnp.zeros(xp.shape[0], jnp.float32))
    out = np.asarray(pk.make_cube_accel_kernel_v2(*nm, interpret=True)(
        x8, pk.pack_force_matrix_v2(jnp.asarray(b.numpy()), *nm)))
    aj = torch.from_numpy(out[:3, :x.shape[0]].T.copy())
    pj = torch.from_numpy(out[3, :x.shape[0]].copy())
    a, p = emulate_accel(x, tab, prm)
    assert float((a - aj).abs().max()) <= FORCE_RTOL * float(aj.abs().max())
    assert float((p - pj).abs().max()) <= FORCE_RTOL * float(pj.abs().max())


def test_folded_table_is_the_table():
    """In f64, to rounding: the folded table's columns against the phases
    give t and t_z of every row as the unfolded sums over kz do, and the
    kx = 0 plane's ky fold keeps pot, a_y and a_z of any b."""
    prm = ck.CubeKernelParams(2, 3, 4)
    g = torch.Generator().manual_seed(5)
    b = torch.complex(torch.randn(prm.shape, generator=g),
                      torch.randn(prm.shape, generator=g))
    tab = ck.cube_force_table(b, prm).double()
    x = torch.rand((64, 3), generator=g, dtype=torch.float64)
    u = ck.wrap(x)
    q = torch.arange(prm.nmaxz + 1, dtype=torch.float64)
    ph = torch.cat([torch.cos(_TWO_PI * q * u[:, 2:]),
                    torch.sin(_TWO_PI * q[1:] * u[:, 2:])], dim=1)
    D = ph @ folded_table(tab, prm)
    pairs = half_pairs(prm)
    k = lambda n: torch.arange(-n, n + 1, dtype=torch.float64)   # noqa: E731
    ez = torch.exp(1j * _TWO_PI * u[:, 2:] * k(prm.nmaxz))
    ey = torch.exp(1j * _TWO_PI * u[:, 1:2] * k(prm.nmaxy))
    T = torch.view_as_complex(tab)
    for i, (a, bb) in enumerate(pairs):
        t = ez @ T[a, prm.nmaxy + bb].to(ez.dtype)
        tz = (ez * (_TWO_PI * k(prm.nmaxz))) @ T[a, prm.nmaxy + bb].to(ez.dtype)
        got_t = torch.complex(D[:, 4 * i], D[:, 4 * i + 1])
        got_tz = torch.complex(D[:, 4 * i + 2], D[:, 4 * i + 3])
        if a == 0 and bb > 0:
            # pot and a_y take Re, Im of t e; a_z takes Im of t_z e
            e = ey[:, prm.nmaxy + bb]
            m_ = ez @ T[0, prm.nmaxy - bb].to(ez.dtype)
            mz = (ez * (_TWO_PI * k(prm.nmaxz))) @ T[0, prm.nmaxy - bb].to(ez.dtype)
            want = t * e + m_ * e.conj()
            torch.testing.assert_close((got_t * e).real, want.real,
                                       rtol=1e-10, atol=1e-10)
            torch.testing.assert_close(
                bb * (got_t * e).imag,
                bb * (t * e).imag - bb * (m_ * e.conj()).imag,
                rtol=1e-10, atol=1e-10)
            torch.testing.assert_close(
                (got_tz * e).imag, (tz * e + mz * e.conj()).imag,
                rtol=1e-10, atol=1e-10)
        else:
            torch.testing.assert_close(got_t, t, rtol=1e-10, atol=1e-10)
            torch.testing.assert_close(got_tz, tz, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# the launch plans

ALL_NMAX = list(itertools.product(ck.KERNEL_NMAX, repeat=3))


def _chunks(seq, k):
    return [seq[i::k] for i in range(k)]


@pytest.mark.parametrize("nmaxes", _chunks(ALL_NMAX, 9),
                         ids=[f"part{i}" for i in range(9)])
def test_plans_fit_every_nmax(nmaxes):
    """For every nmax 0..8 on each axis, at the H100's 227 KB a block: K8
    holds the whole folded table and at least one warp's stage (K7's
    largest block is held to it at compile time, csrc/cube_coef.cu); the
    counts are the half lattice, (kx ky + 1) / 2, in groups of 8 (K7, at
    most 3 a warp) and 4 (K8), and ceil(kz / 8) k-steps."""
    for nm in nmaxes:
        prm = ck.CubeKernelParams(*nm)
        kx, ky, kz = prm.shape
        half = (kx * ky + 1) // 2
        c = ck.coef_plan(2 ** 22, prm, H100_SMS)
        groups = -(-half // 8)
        assert c.pairs == half
        assert c.warps * ck.K7_GROUPS_PER_WARP >= groups
        assert (c.warps - 1) * ck.K7_GROUPS_PER_WARP < groups
        assert c.warps <= 8
        a = ck.accel_plan(2 ** 22, prm, H100_SMS, H100_OPTIN)
        assert a.rows == half and a.groups == -(-half // 4)
        assert a.ks == -(-kz // 8)
        assert a.table_bytes == 4 * 32 * 4 * 2 * a.ks * a.groups + 64 * a.groups
        assert 1 <= a.warps <= ck.K8_MAX_WARPS
        assert a.smem == a.table_bytes + a.warps * a.warp_bytes <= H100_OPTIN
        assert a.warps == ck.K8_MAX_WARPS or (
            a.smem + a.warp_bytes > H100_OPTIN)


def test_plans_at_the_benches_nmax():
    """nmax 6: K7 runs 4 warps (11 pair groups), 4 blocks an SM;
    K8 one block an SM of 16 warps on 225 KB, its table 45 KB.  nmax 8 on
    every axis: K8's table takes 113 KB and still fits, with 7 warps."""
    p6 = ck.CubeKernelParams(6, 6, 6)
    c = ck.coef_plan(2 ** 22, p6, H100_SMS)
    assert (c.pairs, c.warps) == (85, 4)
    assert c.nblocks == 4 * H100_SMS
    a = ck.accel_plan(2 ** 22, p6, H100_SMS, H100_OPTIN)
    assert (a.rows, a.groups, a.ks, a.warps) == (85, 22, 2, 16)
    assert a.table_bytes == 46_464 and a.nblocks == H100_SMS
    a8 = ck.accel_plan(2 ** 22, ck.CubeKernelParams(8, 8, 8), H100_SMS,
                       H100_OPTIN)
    assert a8.table_bytes == 116_032 and a8.warps == 7
    assert a8.smem <= H100_OPTIN


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 64, 65, 4_097, 2 ** 22])
def test_plans_size_the_grid_by_n(n):
    """Small n takes fewer blocks: K7 one a 64-particle tile, K8 one a
    block's warp tiles; never fewer than one."""
    prm = ck.CubeKernelParams(6, 6, 6)
    c = ck.coef_plan(n, prm, H100_SMS)
    assert c.nblocks == max(1, min(-(-n // ck.K7_TILE), 4 * H100_SMS))
    a = ck.accel_plan(n, prm, H100_SMS, H100_OPTIN)
    assert a.nblocks == max(1, min(H100_SMS,
                                   -(-n // (a.warps * ck.K8_WARP_TILE))))


def test_accel_plan_refuses_a_device_without_room():
    with pytest.raises(ValueError, match="no room"):
        ck.accel_plan(1000, ck.CubeKernelParams(8, 8, 8), H100_SMS, 100_000)


@pytest.mark.parametrize("nm", CUBE_NMAX, ids=lambda p: "nmax%d%d%d" % p)
def test_half_lattice_and_mirror_cover_the_lattice(nm):
    """K7's reduce writes S at each half-lattice point (its pairs with every
    kz, less S(0, 0, -q)) and conj S at the mirror: every lattice point
    once, the centre written once as its own mirror."""
    prm = ck.CubeKernelParams(*nm)
    seen = {}
    for a, b in half_pairs(prm):
        for q in range(-prm.nmaxz, prm.nmaxz + 1):
            if a == 0 and b == 0 and q < 0:
                continue
            for k in {(a, b, q), (-a, -b, -q)}:
                seen[k] = seen.get(k, 0) + 1
    assert len(seen) == math.prod(prm.shape)
    assert set(seen.values()) == {1}


def test_cube_split_probe_patches_the_kernels(tmp_path):
    """probe_cube_split's variants: each patch matches its source once (so
    the probe times the kernels as they are), every variant's sources
    differ from the kernels', and a patch that no longer matches raises;
    the first kernels' patches (--first) no longer match these sources."""
    from exp_tpu_torch import probe_cube_split as pc
    from exp_tpu_torch.probe_accel_split import make_variants, patched_sources

    roots = make_variants(tmp_path, pc.VARIANTS)
    for name, root in roots.items():
        for src in {s for s, _, _ in pc.VARIANTS[name][1]}:
            text = (root / "exp_tpu_torch" / "csrc" / src).read_text()
            assert text != (pc.PORT / "csrc" / src).read_text()
    for name, (_, patches) in pc.FIRST_VARIANTS.items():
        if patches:
            with pytest.raises(ValueError):
                patched_sources(patches)
