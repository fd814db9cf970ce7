"""The launch plans of K1 (ops/sphere_kernels.k1_plan), K2 (k2_plan), K3
(k3_plan), K4 (ops/cyl_kernels.coef_plan), K5 (accel_plan) and P1
(ops/slab_kernels.stream_plan): pure arithmetic on the device's SM count
and shared memory, checked here on the CPU at the H100's figures (132 SMs,
232,448 bytes of shared memory a block) and at a smaller device's; and the
split probes' patches against the kernels' sources."""

import dataclasses

import jax
import numpy as np
import pytest
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu_torch.ops import cyl_kernels as ck
from exp_tpu_torch.ops import sphere_kernels as sk
from exp_tpu_torch.ops.solidharm import monomial_exponents
import torch


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


H100 = (132, 232_448, 233_472)
SMALL = (46, 101_376, 102_400)
SIZES = [1, 2, 31, 32, 33, 224, 225, 768, 4095, 4096, 4097, 5_120, 10_240,
         49_152, 131_072, 196_608, 1_048_576, 4_194_304]

DISK = ck.CylKernelParams(mmax=6, ncx=64, ncy=128, acyl=0.01, hcyl=0.002,
                          xmin=-0.998, dxc=0.0302, ymin=-5.298, dy=0.0834,
                          rmax_grid=0.2)
SPHERE = sk.SphereKernelParams(lmax=4, nmax=10, nc=256, xmin=-0.998,
                               dxc=0.0075, rmin=1e-3, rmax=20.0, cmap=1,
                               rmap=1.0, scale=1.0, interp="spline")


def _disk(**kw):
    return dataclasses.replace(DISK, **kw)


def _sphere(**kw):
    return dataclasses.replace(SPHERE, **kw)


# --------------------------------------------------------------------- K4

@pytest.mark.parametrize("device", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("interp", ["spline", "linear"])
def test_k4_chunks_grow_with_n_and_fill_the_sms_once(device, interp):
    sms, optin, _ = device
    prm = _disk(interp=interp)
    plans = [ck.coef_plan(n, prm, sms, optin) for n in SIZES]
    chunks = [p.chunks for p in plans]
    assert chunks == sorted(chunks)
    for n, p in zip(SIZES, plans):
        assert p.chunks * p.groups <= sms
        assert p.chunks == max(1, min(n // ck.K4_MIN_CHUNK, sms // p.groups))
        # at least K4_MIN_CHUNK particles a chunk whenever there are two
        assert p.chunks == 1 or n / p.chunks >= ck.K4_MIN_CHUNK
    assert chunks[-1] == sms // plans[-1].groups


@pytest.mark.parametrize("n", [1, 224, 768, ck.K4_MIN_CHUNK,
                               2 * ck.K4_MIN_CHUNK - 1])
def test_k4_one_chunk_below_the_threshold(n):
    assert ck.coef_plan(n, DISK, *H100[:2]).chunks == 1
    assert ck.coef_plan(2 * ck.K4_MIN_CHUNK, DISK, *H100[:2]).chunks == 2


@pytest.mark.parametrize("mmax", list(ck.KERNEL_MMAX))
@pytest.mark.parametrize("interp", ["spline", "linear"])
@pytest.mark.parametrize("ncx,ncy", [(64, 128), (32, 64), (48, 100),
                                     (16, 31)])
def test_k4_layout_fits_and_matches_the_kernel(mmax, interp, ncx, ncy):
    """The plan's shared memory is what csrc/cyl_coef.cu allocates (the
    (xrows, tg, ncyp) i32 accumulator, a sum a warp and nw warps' stages of
    32 records of a base offset and kx * 2 * tg updates), and fits; a
    particle's updates fit one warp's lanes; the row stride puts those
    lanes on distinct banks; the groups cover the 2M+1 nonzero trig
    rows."""
    prm = _disk(mmax=mmax, interp=interp, ncx=ncx, ncy=ncy)
    p = ck.coef_plan(1_048_576, prm, *H100[:2])
    kx = 3 if interp == "spline" else 2
    R = 2 * mmax + 1
    rec = ck.k4_record_words(kx, p.tg)
    assert rec % 2 == 1 and rec >= 1 + 2 * kx * p.tg
    assert p.smem == 4 * (prm.xrows * p.tg * p.ncyp + p.nw + p.nw * 32 * rec)
    assert p.smem <= H100[1]
    assert 4 <= p.nw <= ck.K4_MAX_WARPS
    assert kx * 2 * p.tg <= 32
    assert p.ncyp >= ncy and p.ncyp % 32 == 2 and p.ncyp - ncy < 32
    assert p.groups * p.tg >= R and (p.groups - 1) * p.tg < R
    # the rows of group g, [g R / groups, (g + 1) R / groups), at most tg
    bounds = [g * R // p.groups for g in range(p.groups + 1)]
    assert bounds[0] == 0 and bounds[-1] == R
    assert max(b - a for a, b in zip(bounds, bounds[1:])) <= p.tg
    # one particle's updates: lane 2 (a tg + t) + b at row (jx0 + a) tg + t
    # of stride ncyp, column jy0 + b: 32 distinct banks
    lanes = [(a, t, b) for a in range(kx) for t in range(p.tg)
             for b in range(2)]
    for jx0, jy0 in ((0, 0), (5, 17), (prm.xrows - kx, ncy - 2)):
        banks = {(((jx0 + a) * p.tg + t) * p.ncyp + jy0 + b) % 32
                 for a, t, b in lanes}
        assert len(banks) == len(lanes)


def test_k4_refuses_a_table_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        ck.coef_plan(1000, _disk(ncx=512, ncy=512), *H100[:2])


# --------------------------------------------------------------------- K1

@pytest.mark.parametrize("device", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("lmax,interp,nc", [(4, "spline", 256),
                                            (6, "spline", 256),
                                            (4, "hat", 512), (0, "hat", 64),
                                            (6, "hat", 2000),
                                            (10, "spline", 256),
                                            (10, "hat", 512)])
def test_k1_row_to_block_assignment_is_independent_of_n(device, lmax, interp,
                                                        nc):
    """Tile t (rows 32 t .. 32 t + 31) runs on block (t // nw) mod nblocks
    (csrc/sphere_coef.cu); the plan's nblocks makes that (t // nw) mod V
    for every tile of every n, V the blocks a SM the shared memory allows
    (at most 2) times the SMs, and the grid grows with n up to V."""
    sms, optin, per_sm_bytes = device
    prm = _sphere(lmax=lmax, interp=interp, nc=nc)
    big = sk.k1_plan(1 << 30, prm, sms, optin, per_sm_bytes)
    V = big.nblocks
    assert V in (sms, 2 * sms)
    assert (V == 2 * sms) == (2 * (big.smem + 1024) <= per_sm_bytes)
    prev = 0
    for n in SIZES:
        p = sk.k1_plan(n, prm, sms, optin, per_sm_bytes)
        assert p.nw == big.nw and p.smem == big.smem
        tiles = np.arange(-(-n // 32))
        assert np.array_equal((tiles // p.nw) % p.nblocks,
                              (tiles // p.nw) % V)
        assert 1 <= p.nblocks <= V and p.nblocks >= prev
        assert p.nblocks == min(-(-len(tiles) // p.nw), V)
        prev = p.nblocks


@pytest.mark.parametrize("lmax", list(sk.POLY_LMAX))
@pytest.mark.parametrize("interp,nc", [("spline", 256), ("spline", 2000),
                                       ("hat", 512)])
def test_k1_layout_fits_and_matches_the_kernel(lmax, interp, nc):
    """The plan's shared memory is what csrc/sphere_coef.cu allocates.  The
    one-accumulator form (lmax 0..6, where one warp's stage and the
    accumulator fit): each warp's stage (32 float4 weights and 32 rows of
    P, P rounded up to odd), the block's (P, rows | 1) i32 accumulator and
    a sum a warp; nw is the most (at most K1_WARPS) that fit.  Otherwise
    the split form, laid out as K3 (k3_smem) and a float4 a lane
    (k1_split_smem) for its largest group, in the fewest groups that fit;
    it fits."""
    prm = _sphere(lmax=lmax, interp=interp, nc=nc)
    P = (lmax + 1) ** 2

    def smem(nw):
        return 4 * (nw * 32 * (4 + (P | 1)) + P * (prm.rows | 1) + nw)

    p = sk.k1_plan(1_048_576, prm, *H100)
    assert p.smem <= H100[1]
    if lmax in sk.K1_ONE_LMAX and smem(1) <= H100[1]:
        assert p.qstart == ()
        assert p.smem == sk.k1_smem(prm, p.nw) == smem(p.nw)
        assert p.nw == sk.K1_WARPS or smem(p.nw + 1) > H100[1]
        return
    R = max(b - a for a, b in zip(p.qstart, p.qstart[1:]))
    assert p.smem == sk.k1_split_smem(prm, p.nw, R) == (
        sk.k3_smem(prm, p.nw, R) + 16 * 32 * p.nw)
    ng = len(p.qstart) - 1
    assert ng == 1 or sk.k1_split_smem(prm, 1, -(-P // (ng - 1))) > H100[1]
    assert (p.finish_threads, p.finish_staged) == sk.k3_finish(prm, H100[1])


def test_k1_plan_at_the_benches_shapes():
    """lmax 4 'spline' on 258 rows: 16 warps on one (25, 259) accumulator,
    85,356 bytes, two blocks an SM; one block for a 224-row bucket, two an
    SM at 2^20 rows."""
    assert sk.k1_plan(224, SPHERE, *H100) == sk.SphereCoefPlan(
        16, 1, 85_356)
    assert sk.k1_plan(1_048_576, SPHERE, *H100).nblocks == 264


def test_k1_refuses_a_hat_table_too_long_for_shared_memory():
    """A 'hat' table whose (P, rows) accumulator does not fit a block
    splits the packed rows into groups whose blocks each fit the H100's
    227 KB: 2,000 nodes at lmax 6 (49 rows, 392 KB in one accumulator) and
    the default 512 at lmax 10 (121 rows, 248 KB) in 2 groups each, which
    cover the rows in order.  A table of which not even one row and a
    warp's stage fit a block is still refused, with the numbers."""
    for lmax, nc, groups in ((6, 2000, 2), (10, 512, 2)):
        prm = _sphere(lmax=lmax, interp="hat", nc=nc)
        P = (lmax + 1) ** 2
        assert 4 * P * (nc | 1) > H100[1]
        p = sk.k1_plan(1_048_576, prm, *H100)
        assert len(p.qstart) - 1 == groups
        assert p.qstart[0] == 0 and p.qstart[-1] == P
        assert all(a < b for a, b in zip(p.qstart, p.qstart[1:]))
        for a, b in zip(p.qstart, p.qstart[1:]):
            assert sk.k1_split_smem(prm, p.nw, b - a) <= H100[1] < 232_449
    prm = _sphere(lmax=6, interp="hat", nc=60_000)
    with pytest.raises(ValueError, match=r"sphere_coef: one row of a "
                                         r"60000-row table"):
        sk.k1_plan(1000, prm, *H100)


@pytest.mark.parametrize("lmax", list(sk.POLY_LMAX))
def test_k1_support_holds_every_nonzero_of_m(lmax):
    """k1_support (the entries K1 multiplies) holds every nonzero entry of
    poly_matrix, with and without a custom fac; and it is the kernel's
    rule: degree <= l, exponents of the row's parities."""
    sup = sk.k1_support(lmax)
    M = sk.poly_matrix(lmax)
    assert not np.any(M[~sup])
    fac = np.arange(1.0, (lmax + 1) ** 2 + 1).reshape(lmax + 1, lmax + 1)
    assert not np.any(sk.poly_matrix(lmax, fac)[~sup])
    exps = monomial_exponents(lmax)
    for p, (cs, l, m) in enumerate(sk.packed_rows(lmax)):
        for k, (i, j, kz) in enumerate(exps):
            if sup[p, k]:
                assert i + j + kz <= l and (i + j + kz - l) % 2 == 0
                assert j % 2 == cs and (i - m - cs) % 2 == 0


def test_k1_support_counts():
    """94 of the 25 x 35 entries at lmax 4 (the first port multiplied 334),
    362 of 49 x 84 at lmax 6, 2,513 of 121 x 286 at lmax 10 (the split
    form's launch parameters: 10 KB)."""
    assert int(sk.k1_support(4).sum()) == 94
    assert int(sk.k1_support(6).sum()) == 362
    assert int(sk.k1_support(10).sum()) == 2513


@pytest.mark.parametrize("lmax", list(sk.POLY_LMAX))
@pytest.mark.parametrize("custom", [False, True], ids=["fac", "custom_fac"])
def test_k1_row_bounds_hold_every_row_on_the_sphere(lmax, custom):
    """K1's fixed-point scales rest on bound_p >= |Y_p| = |M[p] . mono(u)|
    for every unit u: held against 20,000 random directions (f64), for the
    standard fac, a custom one, and an M whose rows are no harmonic's
    multiple (each entry scaled on its own), which get sum_k |M[p, k]|;
    the bounds are never looser than that sum."""
    from exp_tpu_torch.ops.solidharm import monomial_exponents

    fac = None
    if custom:
        rng = np.random.default_rng(lmax)
        fac = rng.uniform(0.1, 5.0, (lmax + 1, lmax + 1))
    M = sk.poly_matrix(lmax, fac)
    u = np.random.default_rng(7).normal(size=(20_000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    mono = np.stack([u[:, 0] ** i * u[:, 1] ** j * u[:, 2] ** k
                     for i, j, k in monomial_exponents(lmax)], axis=1)
    skew = (1.0 + 0.1 * np.arange(M.shape[1]))[None, :].astype(np.float32)
    for mat in (M, M * skew):
        bound = sk.k1_row_bounds(mat, lmax)
        Y = np.abs(mono @ mat.astype(np.float64).T).max(axis=0)
        assert np.all(Y <= bound)
        assert np.all(bound <= np.abs(mat).sum(axis=1) * (1 + 1e-6))
    several = np.count_nonzero(M, axis=1) > 1
    np.testing.assert_allclose(sk.k1_row_bounds(M * skew, lmax)[several],
                               np.abs(M * skew).sum(axis=1)[several],
                               rtol=1e-6)


def test_k4_split_probe_patches_the_kernel(tmp_path):
    """probe_k4_split's variants: each patch matches csrc/cyl_coef.cu once
    (so the probe times the kernel as it is), every variant's source
    differs from the others, and a patch that no longer matches raises."""
    from exp_tpu_torch import probe_k4_split as pk

    roots = pk.make_variants(tmp_path)
    texts = {name: (root / "exp_tpu_torch" / "csrc" / "cyl_coef.cu")
             .read_text() for name, root in roots.items()}
    assert texts["full"] == (pk.PORT / "csrc" / "cyl_coef.cu").read_text()
    assert len(set(texts.values())) == len(pk.VARIANTS)
    assert "cyl::cyl_maps" not in texts["no_geometry"]
    assert "cyl::cyl_maps" in texts["no_adds"]
    with pytest.raises(ValueError):
        pk.patched_source(texts["neither"], pk.VARIANTS["neither"])


# ------------------------------------------------------------- K2 and K5

# the composite's bucket sizes (halo L0-L4, disk L0-L4) and the sweep's
BUCKETS = [224, 640, 768, 1_792, 5_120, 10_240, 49_152, 131_072, 196_608,
           786_432, 1_048_576]


@pytest.mark.parametrize("device", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("interp,nc", [("spline", 256), ("hat", 512)])
@pytest.mark.parametrize("lmax", list(sk.REC_LMAX))
def test_k2_plan_covers_the_triangle_and_the_rows(lmax, interp, nc, device):
    """k2_plan at every lmax K2 takes: the lanes (the power of 2 >= 1 +
    ceil(lmax/2)) and their columns depend on lmax alone and deal every
    column m to exactly one lane, no lane holding more than column 0's
    lmax + 1 entries; a particle runs on its lanes while the rows' lanes
    fit K2_THREADS_PER_SM threads a SM, on one thread above; the blocks
    cover the n rows with none to spare; the shared memory (fac and the
    reciprocals) fits, the table going through L1."""
    sms, optin, _ = device
    prm = _sphere(lmax=lmax, interp=interp, nc=nc)
    lanes = sk.k2_lanes(lmax)
    assert lanes in (1, 2, 4, 8) and lanes // 2 < 1 + (lmax + 1) // 2 <= lanes
    cols = sk.k2_columns(lmax)
    assert len(cols) == lanes
    assert sorted(m for c in cols for m in c) == list(range(lmax + 1))
    assert max(sum(lmax + 1 - m for m in c) for c in cols) == lmax + 1
    plans = [sk.k2_plan(n, prm, sms, optin) for n in BUCKETS]
    for n, p in zip(BUCKETS, plans):
        small = n * lanes <= sk.K2_THREADS_PER_SM * sms
        assert p.threads == (lanes if small else 1)
        cover = sk.K2_THREADS // p.threads
        assert p.blocks * cover >= n > (p.blocks - 1) * cover
        assert p.smem == 4 * ((lmax + 1) ** 2 + lmax + 1) <= optin
    assert plans[0].threads == lanes and plans[-1].threads == 1


def test_k2_plan_at_the_benches_shapes():
    """lmax 4: 4 lanes (columns 0 | 1, 4 | 2, 3 | none), a particle on them
    up to 25,344 rows (28 blocks at 1,792), a thread a particle above;
    lmax 10: 8 lanes (6 of them holding columns); only 1 or the lanes
    threads a particle."""
    p = sk.k2_plan(1_792, SPHERE, *H100[:2])
    assert (p.threads, p.blocks) == (4, 28)
    assert sk.k2_columns(4) == [[0], [1, 4], [2, 3], []]
    assert sk.k2_plan(25_344, SPHERE, *H100[:2]).threads == 4
    assert sk.k2_plan(25_345, SPHERE, *H100[:2]).threads == 1
    assert sk.k2_plan(1_048_576, SPHERE, *H100[:2]).threads == 1
    assert sk.k2_lanes(10) == 8
    assert sk.k2_columns(10)[5:] == [[5, 6], [], []]
    assert sk.k2_plan(224, _sphere(lmax=10), *H100[:2]).threads == 8
    assert sk.k2_plan(224, _sphere(lmax=0), *H100[:2]).threads == 1
    with pytest.raises(ValueError, match="threads a particle"):
        sk.k2_plan(224, SPHERE, *H100[:2], threads=2)
    with pytest.raises(ValueError, match="threads a particle"):
        sk.k2_plan(224, _sphere(lmax=10), *H100[:2], threads=4)


@pytest.mark.parametrize("device", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("interp", ["spline", "linear"])
@pytest.mark.parametrize("mmax", list(ck.KERNEL_MMAX))
def test_k5_plan_covers_the_rows(mmax, interp, device):
    """accel_plan at every mmax K5 takes and the composite's bucket sizes:
    K5_LANES threads a particle's column work, the set-up broadcast once
    the rows' lanes pass K5_LANES_PER_SM a SM, blocks that cover the rows
    with none to spare, no shared memory."""
    sms, optin, _ = device
    prm = _disk(mmax=mmax, interp=interp)
    for n in BUCKETS:
        p = ck.accel_plan(n, prm, sms, optin)
        assert (p.lanes, p.smem) == (ck.K5_LANES, 0)
        assert p.broadcast == (n * ck.K5_LANES > ck.K5_LANES_PER_SM * sms)
        cover = ck.K5_THREADS // (1 if p.broadcast else ck.K5_LANES)
        assert p.blocks * cover >= n > (p.blocks - 1) * cover
    assert ck.accel_plan(224, prm, sms, optin).blocks == 4
    assert not ck.accel_plan(224, prm, sms, optin).broadcast
    assert ck.accel_plan(1_048_576, prm, sms, optin).blocks == 4_096
    assert not ck.accel_plan(1_048_576, prm, sms, optin,
                             broadcast=False).broadcast


@pytest.mark.parametrize("mmax", list(ck.KERNEL_MMAX))
def test_k5_table_columns(mmax):
    """table_columns places the 6(M+1) values in the SP-wide node row once
    each; float4 column m <= M holds (pot.c, pot.s, dUdR.c, dUdR.s) of m,
    float4 column M+1+j (dUdz.c, dUdz.s) of m = 2j, 2j+1."""
    M1 = mmax + 1
    cols = ck.table_columns(mmax)
    SP = ck.table_row_width(mmax)
    assert len(set(cols.tolist())) == 6 * M1 and cols.max() < SP
    for q in range(6):
        for m in range(M1):
            c = int(cols[q * M1 + m])
            if q < 4:
                assert (c // 4, c % 4) == (m, q)
            else:
                assert (c // 4, c % 4) == (M1 + m // 2, 2 * (m % 2) + q - 4)


@pytest.mark.parametrize("mmax", [0, 3, 6, 7])
def test_k5_table_is_the_old_layout_permuted(mmax):
    """contract_coef_tables' node rows hold bit for bit the values of the
    first layout (the JAX order, then zeros), at table_columns."""
    import torch

    rng = np.random.default_rng(mmax)
    M1, nn, xrows, ncy = mmax + 1, 5, 6, 7
    tab3 = torch.tensor(rng.normal(size=(3, xrows * ncy, M1, nn)),
                        dtype=torch.float32)
    coef = torch.tensor(rng.normal(size=(2, M1, nn)), dtype=torch.float32)
    Ct = ck.contract_coef_tables(coef, tab3, xrows, ncy)
    eye = torch.eye(M1)
    B = coef.permute(1, 2, 0)[:, :, :, None] * eye[:, None, None, :]
    C = tab3.reshape(3 * xrows * ncy, M1 * nn) @ B.reshape(M1 * nn, 2 * M1)
    old = C.reshape(3, xrows * ncy, 2 * M1).permute(1, 0, 2).reshape(
        xrows, ncy, 6 * M1)
    cols = ck.table_columns(mmax)
    assert torch.equal(Ct[..., cols], old)
    pad = np.setdiff1d(np.arange(Ct.shape[-1]), cols)
    assert torch.count_nonzero(Ct[..., pad]) == 0


def test_accel_split_probe_patches_the_kernels(tmp_path):
    """probe_accel_split's variants: each patch matches its kernel source
    once (so the probe times the kernels as they are), the variants'
    sources differ from the kernels', and a patch that no longer matches
    raises."""
    from exp_tpu_torch import probe_accel_split as pa

    roots = pa.make_variants(tmp_path)
    for name, root in roots.items():
        for src in ("sphere_accel.cu", "cyl_accel.cu"):
            text = (root / "exp_tpu_torch" / "csrc" / src).read_text()
            patched = any(s == src for s, _, _ in pa.VARIANTS[name][1])
            assert (text != (pa.PORT / "csrc" / src).read_text()) == patched
    src, old, new = pa.VARIANTS["no_gather"][1][0]
    with pytest.raises(ValueError):
        pa.patched_sources([(src, new + "x", old)])


# --------------------------------------------------------------------- K3

@pytest.mark.parametrize("device", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("lmax", list(sk.REC_LMAX))
@pytest.mark.parametrize("interp,nc", [("spline", 64), ("spline", 256),
                                       ("hat", 128), ("hat", 512),
                                       ("hat", 5000)])
def test_k3_plan_uses_the_fewest_groups(device, lmax, interp, nc):
    """One group of rows wherever the (P, rows) i32 accumulator and one
    warp's stage fit a block; otherwise the fewest groups that fit,
    ceil(P / the most rows that fit), of sizes within one row of each
    other; the boundaries cover 0..P in order."""
    sms, optin, per_sm_bytes = device
    prm = _sphere(lmax=lmax, interp=interp, nc=nc)
    P = (lmax + 1) ** 2
    p = sk.k3_plan(1_048_576, prm, sms, optin, per_sm_bytes)
    q = p.qstart
    assert q[0] == 0 and q[-1] == P and list(q) == sorted(set(q))
    sizes = [b - a for a, b in zip(q, q[1:])]
    rmax = max(R for R in range(1, P + 1) if sk.k3_smem(prm, 1, R) <= optin)
    assert (len(sizes) == 1) == (rmax == P)
    assert len(sizes) == -(-P // rmax)
    assert max(sizes) <= rmax and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("lmax", list(sk.REC_LMAX))
@pytest.mark.parametrize("nc", [64, 512, 2000, 5000, 20_000, 50_000])
@pytest.mark.parametrize("interp", ["spline", "hat"])
def test_k3_accepts_every_table_the_first_kernel_did(lmax, nc, interp):
    """The first K3 (groups of G <= 32 rows, a private (G, rows) f32
    accumulator a warp) ran any table with 4 (P + (rows | 1) + 160) bytes
    <= a block's shared memory (G = 1, one warp); k3_plan plans each of
    them, its blocks and its second kernel within a block's shared
    memory."""
    prm = _sphere(lmax=lmax, interp=interp, nc=nc)
    P = (lmax + 1) ** 2
    for sms, optin, per_sm_bytes in (H100, SMALL):
        if 4 * (P + (prm.rows | 1) + 160) > optin:
            continue
        p = sk.k3_plan(1_048_576, prm, sms, optin, per_sm_bytes)
        assert p.smem <= optin
        assert 4 * (prm.rows * (1 + (prm.nmax if p.finish_staged else 0))
                    + p.finish_threads + 4 * prm.nmax) <= optin
        assert p.finish_threads % 128 == 0 and p.finish_threads >= 4 * prm.nmax


@pytest.mark.parametrize("device", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("lmax,interp,nc", [(4, "spline", 256),
                                            (4, "hat", 512),
                                            (10, "spline", 256),
                                            (10, "hat", 512), (0, "hat", 64)])
def test_k3_row_to_block_assignment_is_independent_of_n(device, lmax, interp,
                                                        nc):
    """Tile t (rows 32 t .. 32 t + 31) runs on block (t // nw) mod nblocks
    of each group (csrc/sphere_coef_rec.cu); the plan's nblocks makes that
    (t // nw) mod V for every tile of every n, V the blocks a SM the shared
    memory allows (at most 2) times the SMs; the groups, the warps and the
    shared memory do not depend on n, and the grid grows with n up to V."""
    sms, optin, per_sm_bytes = device
    prm = _sphere(lmax=lmax, interp=interp, nc=nc)
    big = sk.k3_plan(1 << 30, prm, sms, optin, per_sm_bytes)
    V = big.nblocks
    assert V in (sms, 2 * sms)
    assert (V == 2 * sms) == (2 * (big.smem + 1024) <= per_sm_bytes)
    prev = 0
    for n in SIZES:
        p = sk.k3_plan(n, prm, sms, optin, per_sm_bytes)
        assert (p.qstart, p.nw, p.smem) == (big.qstart, big.nw, big.smem)
        tiles = np.arange(-(-n // 32))
        assert np.array_equal((tiles // p.nw) % p.nblocks,
                              (tiles // p.nw) % V)
        assert 1 <= p.nblocks <= V and p.nblocks >= prev
        assert p.nblocks == min(-(-len(tiles) // p.nw), V)
        prev = p.nblocks


@pytest.mark.parametrize("lmax", list(sk.REC_LMAX))
@pytest.mark.parametrize("interp", ["spline", "hat"])
@pytest.mark.parametrize("nc", [64, 128, 256, 512])
def test_k3_layout_fits_and_matches_the_kernel(lmax, interp, nc):
    """The plan's shared memory is what csrc/sphere_coef_rec.cu allocates
    for its largest group of R rows: each warp's 32 weight records
    (float4) and its stage of 32 particles x (min(32, R) | 1) words, the
    group's (R, rows | 1) i32 accumulator and a word a group row (its
    packed row and scale exponent); it fits; the warps an SM are the most
    that fit (the larger block of a tie); the second kernel stages its
    table slice, 1024 threads."""
    prm = _sphere(lmax=lmax, interp=interp, nc=nc)
    p = sk.k3_plan(1_048_576, prm, *H100)
    R = max(b - a for a, b in zip(p.qstart, p.qstart[1:]))

    def smem(nw):
        return 4 * (nw * 32 * (4 + (min(32, R) | 1)) + R * (prm.rows | 1)
                    + R)

    def per_sm(nw):
        return max(1, min(2, H100[2] // (smem(nw) + 1024)))

    assert p.smem == sk.k3_smem(prm, p.nw, R) == smem(p.nw)
    assert p.smem <= H100[1] and 1 <= p.nw <= sk.K3_WARPS
    for w in range(1, sk.K3_WARPS + 1):
        if smem(w) <= H100[1]:
            assert (per_sm(w) * w, w) <= (per_sm(p.nw) * p.nw, p.nw)
    assert (p.finish_threads, p.finish_staged) == (sk.K1_FINISH_THREADS,
                                                   True)


def test_k3_plan_at_the_benches_shapes():
    """lmax 4 'spline' on 258 rows: one group, 16 warps, two blocks an SM,
    264 blocks at 2^20 rows and one for a 224-row bucket; lmax 10 'spline'
    one group of 121 rows, one block an SM; lmax 10 'hat' on 512 nodes two
    groups of 60 and 61 rows."""
    p = sk.k3_plan(1_048_576, SPHERE, *H100)
    assert (p.qstart, p.nw, p.nblocks) == ((0, 25), 16, 264)
    assert sk.k3_plan(224, SPHERE, *H100).nblocks == 1
    p10 = sk.k3_plan(1_048_576, _sphere(lmax=10), *H100)
    assert (p10.qstart, p10.nblocks) == ((0, 121), 132)
    ph = sk.k3_plan(1_048_576, _sphere(lmax=10, interp="hat", nc=512), *H100)
    assert ph.qstart == (0, 60, 121)


@pytest.mark.parametrize("lmax", list(sk.REC_LMAX))
@pytest.mark.parametrize("custom", [False, True], ids=["fac", "custom_fac"])
def test_k3_row_bounds_hold_every_row_on_the_sphere(lmax, custom):
    """K3's fixed-point scales rest on bound_p >= |Y_p| / w = |fac[l,m]
    P_lm(cos th) {cos, sin}(m phi)|: held against the plain version's rows
    (f32 recurrences, sphere_coef_rec_plain's) at 20,000 random directions
    and at the poles and the equator, for the benches' fac and a custom
    one; each bound is the addition theorem's times |fac| and 1.01."""
    import math

    import torch

    from exp_tpu_torch.ops.special import _legendre_lists, real_ylm_norm
    from exp_tpu_torch.ops.sphere_kernels import _trig_lists

    fac = real_ylm_norm(lmax).numpy()
    if custom:
        fac = np.random.default_rng(lmax).uniform(0.1, 5.0, fac.shape)
    u = np.random.default_rng(7).normal(size=(20_000, 3))
    u = np.concatenate([u, [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0],
                            [1, 1, 0], [1e-7, 0, 1]]])
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    x = torch.tensor(u, dtype=torch.float32)
    r = torch.sqrt((x * x).sum(dim=1)) + 1e-10
    R = torch.sqrt(x[:, 0] ** 2 + x[:, 1] ** 2) + 1e-10
    Pl = _legendre_lists(lmax, x[:, 2] / r)
    cm, sm = _trig_lists(lmax, x[:, 0] / R, x[:, 1] / R)
    bound = sk.k3_row_bounds(fac, lmax)
    f32 = torch.tensor(fac, dtype=torch.float32)
    for p, (cs, l, m) in enumerate(sk.packed_rows(lmax)):
        y = (f32[l, m] * Pl[l][m] * (cm[m] if cs == 0 else sm[m])).abs()
        assert float(y.max()) <= bound[p], (l, m, cs)
        theorem = math.sqrt(math.factorial(l + m) / math.factorial(l - m)
                            / (2.0 if m else 1.0))
        assert bound[p] == np.float32(1.01 * abs(fac[l, m]) * theorem)


# --------------------------------------------------------------------- P1

@pytest.mark.parametrize("device", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("nmax", range(0, 6))
@pytest.mark.parametrize("split", [False, True], ids=["stream1", "stream2"])
@pytest.mark.parametrize("interp,nzc", [("spline", 126), ("linear", 128),
                                        ("spline", 20)])
def test_p1_plan_fits(device, nmax, split, interp, nzc):
    """P1's plan: its shared memory is csrc/slab_phasestream.cu's layout
    for the tile and fits a block and, with its blocks, an SM; the threads
    cover the 2C output rows and the tile's particles, a multiple of 32,
    at most P1_MAX_THREADS; the tile is the largest that fits two blocks
    an SM where one does; no more blocks than tiles."""
    from exp_tpu_torch.ops import slab_kernels as lk

    sms, optin, per_sm_bytes = device
    props = type("P", (), {"shared_memory_per_block_optin": optin,
                           "shared_memory_per_multiprocessor": per_sm_bytes,
                           "multi_processor_count": sms})
    prm = lk.SlabKernelParams(nmaxx=nmax, nmaxy=nmax, nzc=nzc, zmax=0.1,
                              interp=interp)
    assert prm.zrows <= lk.KERNEL_ZROWS_MAX
    A = 2 * prm.C
    nst = 2 * A if split else A
    if lk.stream_smem_bytes(prm, split, min(lk.P1_TILES)) > optin:
        with pytest.raises(ValueError, match="shared memory"):
            lk.stream_plan(prm, split, props, 1000)
        return
    for n in (1, 1000, 2 ** 20):
        p = lk.stream_plan(prm, split, props, n)
        assert p.tile in lk.P1_TILES
        assert p.smem == lk.stream_smem_bytes(prm, split, p.tile) == (
            16 * p.tile + 4 * (2 * (p.tile // 32) * 128 + 132) + 16
            + 8 * nst + 8 * nst * (p.tile // 2 + 1))
        assert p.smem <= optin
        per_sm = -(-p.nblocks // sms) if n == 2 ** 20 else 1
        assert per_sm * (p.smem + 1024) <= per_sm_bytes
        assert p.threads % 32 == 0 and p.threads <= lk.P1_MAX_THREADS
        assert p.threads >= max(A, p.tile)
        assert 1 <= p.nblocks <= -(-n // p.tile)
        two = [t for t in lk.P1_TILES
               if 2 * (lk.stream_smem_bytes(prm, split, t) + 1024)
               <= per_sm_bytes]
        if two:
            assert p.tile == two[0]


def test_p1_plan_refuses_nmax_6():
    from exp_tpu_torch.ops import slab_kernels as lk

    props = type("P", (), {"shared_memory_per_block_optin": H100[1],
                           "shared_memory_per_multiprocessor": H100[2],
                           "multi_processor_count": H100[0]})
    prm = lk.SlabKernelParams(nmaxx=6, nmaxy=6, nzc=126, zmax=0.1,
                              interp="spline")
    with pytest.raises(ValueError, match="threads"):
        lk.stream_plan(prm, False, props, 100)


def test_rec_split_probe_patches_the_kernels(tmp_path):
    """probe_rec_split's variants: each patch matches its source once (so
    the probe times the kernels as they are), every variant's patched
    sources differ from the kernels', and a patch that no longer matches
    raises."""
    from exp_tpu_torch import probe_rec_split as pr
    from exp_tpu_torch.probe_accel_split import make_variants, patched_sources

    roots = make_variants(tmp_path, pr.VARIANTS)
    assert set(roots) == set(pr.VARIANTS)
    for name, root in roots.items():
        srcs = {s for s, _, _ in pr.VARIANTS[name][1]}
        assert bool(srcs) == (name != "full")
        for src in srcs:
            path = src if "/" in src else f"csrc/{src}"
            text = (root / "exp_tpu_torch" / path).read_text()
            assert text != (pr.PORT / path).read_text()
    src, old, new = pr.VARIANTS["no_rows"][1][0]
    with pytest.raises(ValueError):
        patched_sources([(src, new + "x", old)])


# --------------------------------------------------------------------- K6

def _header_patterns(text):
    """{lmax: (start, col)} parsed from csrc/sphere_poly_support.cuh."""
    import re

    out = {}
    for L, body in re.findall(r"struct PolySupport<(\d+)> \{(.*?)\n\};", text,
                              re.S):
        arrays = dict(re.findall(r"int (\w+)\[\d+\] = \{([^}]*)\}", body))
        out[int(L)] = tuple(np.array([int(v) for v in arrays[k].split(",")])
                            for k in ("start", "col"))
    return out


def test_k6_header_is_the_generators():
    """The checked-in csrc/sphere_poly_support.cuh is what k6_header
    writes (`python -m exp_tpu_torch.gen_k6_support`)."""
    from exp_tpu_torch.gen_k6_support import HEADER

    assert HEADER.read_text() == sk.k6_header()


@pytest.mark.parametrize("lmax", list(sk.POLY_LMAX))
def test_k6_header_holds_every_nonzero(lmax):
    """The header's pattern at each lmax is k6_support: the nonzeros of
    poly_matrix_stack (215 at lmax 4, 941 at 6, 7,494 at 10: 30.0 KB of
    launch parameters), and it holds every nonzero of the stack of a
    random custom fac (fac only rescales whole rows)."""
    from exp_tpu_torch.gen_k6_support import HEADER

    start, col = _header_patterns(HEADER.read_text())[lmax]
    sup = sk.k6_support(lmax)
    assert np.array_equal(start, np.concatenate(
        [[0], np.cumsum(sup.sum(axis=1))]))
    assert np.array_equal(col, np.nonzero(sup)[1])
    assert {4: 215, 6: 941, 10: 7494}.get(lmax, len(col)) == len(col)
    rng = np.random.default_rng(lmax)
    fac = rng.uniform(-2.0, 2.0, (lmax + 1, lmax + 1)).astype(np.float32)
    Ms = sk.poly_matrix_stack(lmax, fac)
    assert not Ms[~sup].any()
    assert np.count_nonzero(Ms) == len(col)


def test_k6_refuses_ms_outside_its_support():
    """The wrapper reads Ms's nonzeros (k6_support, row-major) for its
    launch parameters and raises on a nonzero entry outside the
    pattern."""
    import torch

    Ms = torch.tensor(sk.poly_matrix_stack(4))
    nz = sk._ms_on_host(Ms, 4)
    assert np.array_equal(nz, Ms.numpy()[sk.k6_support(4)])
    bad = Ms.clone()
    bad[0, 1] = 0.25                     # x in the l = 0 row
    with pytest.raises(ValueError, match="outside the support K6"):
        sk._ms_on_host(bad, 4)


@pytest.mark.parametrize("sms", [132, 46])
def test_k6_plan_covers_the_rows(sms):
    """k6_plan: a thread a row, blocks of 32..256 threads (a multiple of
    32), every block holding rows; 256 threads once the rows give every
    SM a block of them, fewer (but at least 32) so that more SMs get one
    below that; the same at lmax 10; lmax above 10 refused."""
    for n in [0] + SIZES:
        p = sk.k6_plan(n, SPHERE, sms)
        assert p.threads % 32 == 0 and 32 <= p.threads <= sk.K6_THREADS
        assert p.blocks * p.threads >= n
        assert p.blocks == -(-n // p.threads)
        if n >= sk.K6_THREADS * sms:
            assert p.threads == sk.K6_THREADS
        elif p.threads > 32:
            assert -(-n // p.threads) >= sms
    assert sk.k6_plan(1000, _sphere(lmax=10), sms) == sk.k6_plan(
        1000, SPHERE, sms)
    with pytest.raises(ValueError, match="lmax 0..10"):
        sk.k6_plan(1000, _sphere(lmax=11), 132)


# --------------------------------------------------------------------- K9

def _props(device):
    import types

    sms, optin, per_sm = device
    return types.SimpleNamespace(multi_processor_count=sms,
                                 shared_memory_per_block_optin=optin,
                                 shared_memory_per_multiprocessor=per_sm)


def _slab(nx, ny, nzc, interp):
    from exp_tpu_torch.ops import slab_kernels as lk

    return lk.SlabKernelParams(nx, ny, nzc, 0.1, interp)


@pytest.mark.parametrize("device", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("interp,nzc", [("spline", 2), ("spline", 60),
                                        ("spline", 126), ("linear", 2),
                                        ("linear", 128)])
def test_k9_plan_fits(device, interp, nzc):
    """K9's coef_plan at every nmax 0..8 on each axis: groups of H packed
    threads (ng H rounded up to 32, at most K9_MAX_THREADS), a tile a
    multiple of 32, shared memory
    (k9_smem) within a block's and, for two blocks an SM, within half the
    SM's; blocks no more than the tiles and, at 2^20 rows, all the SMs'
    blocks."""
    from exp_tpu_torch.ops import slab_kernels as lk

    props = _props(device)
    for nx in lk.KERNEL_NMAX:
        for ny in lk.KERNEL_NMAX:
            prm = _slab(nx, ny, nzc, interp)
            try:
                p = lk.coef_plan(prm, props, 1 << 20)
            except ValueError:
                assert lk.k9_smem(prm, 1, 32) > min(device[1],
                                                    device[2] - 1024)
                continue
            assert p.threads == -(-p.ng * prm.H // 32) * 32
            assert p.threads <= lk.K9_MAX_THREADS
            assert p.tile % 32 == 0 and 32 <= p.tile <= lk.K9_MAX_TILE
            assert p.smem == lk.k9_smem(prm, p.ng, p.tile) <= device[1]
            per_sm = -(-p.nblocks // device[0])
            assert per_sm * (p.smem + 1024) <= device[2]
            assert p.nblocks == min(per_sm * device[0], -(-(1 << 20) // p.tile))
            assert lk.coef_plan(prm, props, 100).nblocks == -(-100 // p.tile)


@pytest.mark.parametrize("device", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("interp", ["spline", "linear"])
def test_k9_accepts_every_shape_the_first_kernel_did(device, interp):
    """The first K9 (groups of H threads rounded up to 32, each with its
    own (zrows, H) accumulator and a staged tile of 64 particles) ran any
    shape whose group, 16 x 64 + 8 x 64 (nmaxx + 2 nmaxy + 2) + 8 H zrows
    bytes, fit a block; coef_plan plans each of them."""
    from exp_tpu_torch.ops import slab_kernels as lk

    props = _props(device)
    for nx in lk.KERNEL_NMAX:
        for ny in lk.KERNEL_NMAX:
            for nzc in range(2, 129 if interp == "linear" else 127, 9):
                prm = _slab(nx, ny, nzc, interp)
                row = nx + 1 + 2 * ny + 1
                first = 16 * 64 + 8 * 64 * row + 8 * prm.H * prm.zrows
                if first <= min(device[1], device[2] - 1024):
                    assert lk.coef_plan(prm, props, 1 << 20).smem <= device[1]


def test_k9_plan_at_the_benches_shapes():
    """The slab bench (nmax 4 x 4, nzc 126, 'spline', 2^20 rows) on an
    H100: 14 groups of 41 threads in 576 (2 idle), two blocks an SM."""
    from exp_tpu_torch.ops import slab_kernels as lk

    p = lk.coef_plan(_slab(4, 4, 126, "spline"), _props(H100), 1 << 20)
    assert (p.ng, p.threads, p.nblocks) == (14, 576, 264)
    assert 2 * (p.smem + 1024) <= H100[2]


def test_poly_slab_split_probe_patches_the_kernels(tmp_path):
    """probe_poly_slab_split's variants: each patch matches its source
    once (so the probe times the kernels as they are), every variant's
    patched sources differ from the kernels', and a patch that no longer
    matches raises."""
    from exp_tpu_torch import probe_poly_slab_split as pp
    from exp_tpu_torch.probe_accel_split import make_variants, patched_sources

    roots = make_variants(tmp_path, pp.VARIANTS)
    assert set(roots) == set(pp.VARIANTS)
    for name, root in roots.items():
        srcs = {s for s, _, _ in pp.VARIANTS[name][1]}
        assert bool(srcs) == (name != "full")
        for src in srcs:
            text = (root / "exp_tpu_torch" / "csrc" / src).read_text()
            assert text != (pp.PORT / "csrc" / src).read_text()
    src, old, new = pp.VARIANTS["no_walk"][1][0]
    with pytest.raises(ValueError):
        patched_sources([(src, new + "x", old)])


# --------------------------------------------------------------------- K10

def _k10_constants():
    """kThreads, kBlocksPerSm and kMaxTile of csrc/slab_accel.cu."""
    import re
    from pathlib import Path

    from exp_tpu_torch.ops import slab_kernels as lk

    src = (Path(lk.__file__).resolve().parent.parent / "csrc"
           / "slab_accel.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("kThreads", "kBlocksPerSm", "kMaxTile"))


def test_k10_plan_constants_are_the_kernels():
    from exp_tpu_torch.ops import slab_kernels as lk

    assert _k10_constants() == (lk.K10_THREADS, lk.K10_BLOCKS_PER_SM,
                                lk.K10_MAX_TILE)


@pytest.mark.parametrize("device", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("interp,nzc", [("spline", 2), ("spline", 60),
                                        ("spline", 126), ("linear", 2),
                                        ("linear", 128)])
def test_k10_plan_fits(device, interp, nzc):
    """K10's accel_plan at every nmax 0..8 on each axis and n from 0 to
    2^22: a tile a power of two, 32..K10_MAX_TILE, the largest that still
    gives every SM a tile where n allows; K10_THREADS threads, no more
    than the tile; no more blocks than tiles or than K10_BLOCKS_PER_SM an
    SM; nzc + 2 bins; shared memory k10_smem (the tile's records with a
    padding record a bin, its x, outputs and keys, the bins' counts and
    first places, with the bins rounded up to 32, and the tile's count),
    within the device's a block and, on an H100, for K10_BLOCKS_PER_SM
    blocks an SM's."""
    from exp_tpu_torch.ops import slab_kernels as lk

    sms, optin, per_sm = device
    tiles = [1 << k for k in range(5, 11)]
    for nx in lk.KERNEL_NMAX:
        for ny in lk.KERNEL_NMAX:
            prm = _slab(nx, ny, nzc, interp)
            assert prm.zrows <= lk.KERNEL_ZROWS_MAX
            for n in [0] + SIZES:
                p = lk.accel_plan(n, prm, sms, optin)
                assert p.tile in tiles and p.tile <= lk.K10_MAX_TILE
                assert p.tile == 32 or -(-n // p.tile) >= sms
                assert p.tile == lk.K10_MAX_TILE or -(-n // (2 * p.tile)) < sms
                assert p.threads == min(lk.K10_THREADS, p.tile)
                assert p.threads % 32 == 0 and p.tile % p.threads == 0
                assert p.nblocks == max(1, min(-(-n // p.tile),
                                               lk.K10_BLOCKS_PER_SM * sms))
                assert p.nbins == nzc + 2
                nbp = -(-(nzc + 2) // 32) * 32
                assert p.smem == lk.k10_smem(prm, p.tile) == (
                    16 * (p.tile + nbp) + 32 * p.tile + 8 * nbp + 4)
                assert p.smem <= optin
                if device == H100:
                    assert lk.K10_BLOCKS_PER_SM * (p.smem + 1024) <= per_sm


def test_k10_plan_at_the_benches_shapes():
    """The slab bench (nmax 4 x 4, nzc 126, 'spline') on an H100: tiles of
    1,024 at 2^20 rows, two blocks an SM; 256 at 49,152 rows, so that
    every SM has a tile; 32 at 224."""
    from exp_tpu_torch.ops import slab_kernels as lk

    prm = _slab(4, 4, 126, "spline")
    p = lk.accel_plan(1 << 20, prm, *H100[:2])
    assert (p.tile, p.threads, p.nblocks, p.nbins) == (1024, 256, 264, 128)
    assert lk.accel_plan(49_152, prm, *H100[:2]).tile == 256
    assert (lk.accel_plan(224, prm, *H100[:2]).tile,
            lk.accel_plan(224, prm, *H100[:2]).nblocks) == (32, 7)


def _k10_sort(z, prm):
    """csrc/slab_accel.cu's sort of one tile in NumPy: each particle's bin
    (its first z node, slab_kernels.z_frac; nzc below -zmax, nzc + 1
    above +zmax, by the kernel's test max(|z| - zmax, 0) > 0 in f32) and
    its sorted place start[bin] + rank, the bins' first places by an
    exclusive scan of their counts rounded up to even, and a padding
    record after the last particle of a bin of odd count; the rank within
    a bin in the input's order (the kernel's atomics give any order: the
    places of a bin are the same set).  Returns (bins, places, the
    records' bins, their particles or -1)."""
    import torch

    from exp_tpu_torch.ops import slab_kernels as lk

    zt = torch.tensor(z, dtype=torch.float32)
    out = torch.clamp(torch.abs(zt) - prm.zmax, min=0.0) > 0.0
    j0, _ = lk.z_frac(lk.z_grid(zt, prm), prm)
    bins = torch.where(out, torch.where(zt >= 0, prm.nzc + 1, prm.nzc),
                       j0).numpy()
    cnt = np.bincount(bins, minlength=prm.nzc + 2)
    padded = cnt + (cnt & 1)
    start = np.cumsum(padded) - padded
    rank = np.zeros(len(z), np.int64)
    seen = np.zeros(prm.nzc + 2, np.int64)
    for i, b in enumerate(bins):
        rank[i] = seen[b]
        seen[b] += 1
    place = start[bins] + rank
    rbin = np.full(padded.sum(), -1)
    who = np.full(padded.sum(), -1)
    rbin[place], who[place] = bins, np.arange(len(z))
    last = (cnt[bins] & 1).astype(bool) & (rank == cnt[bins] - 1)
    rbin[place[last] + 1] = bins[last]
    return bins, place, rbin, who


@pytest.mark.parametrize("interp", ["spline", "linear"])
def test_k10_sort_places_and_warp_windows(interp):
    """The NumPy model of K10's tile sort on the bench's sheet with
    particles beyond both faces and the slab's edge rows, in the plan's
    tiles of 1,024 and a ragged last tile: the records are the tile's
    particles, each once, and a padding record for each bin of odd count
    (at most one a bin, within the shared memory's nzc + 2 rounded up to
    32 spare records); each thread's pair of records 2s, 2s + 1 lies in
    one bin, so shares its rows; the bins rise along the records, the
    particles below -zmax and then above +zmax last; every inside
    particle's first node is a row of K10's table.  The window: a warp's
    32 pairs read about 3 first nodes on the sheet, against 16.5 for 32
    particles in the input's order, and 99% of them span at most 20
    nodes."""
    from exp_tpu_torch.bench_slab import slab_sample
    from exp_tpu_torch.ops import slab_kernels as lk

    prm = _slab(4, 4, 126 if interp == "spline" else 128, interp)
    x, _, _ = slab_sample(1 << 15, seed=3)
    rng = np.random.default_rng(4)
    z = np.concatenate([x[:, 2], rng.uniform(0.1, 0.3, 301)
                        * rng.choice([-1, 1], 301),
                        [0.1, -0.1, 0.0999, 0.1001, -0.0999, -0.1001, 1.0,
                         -1.0]])
    tile = lk.accel_plan(1 << 20, prm, *H100[:2]).tile
    assert tile == 1024 and len(z) % tile
    nbp = -(-(prm.nzc + 2) // 32) * 32
    distinct, spans, plain = [], [], []
    for s in range(0, len(z), tile):
        bins, place, rbin, who = _k10_sort(z[s:s + tile], prm)
        assert np.array_equal(np.sort(who[who >= 0]), np.arange(len(bins)))
        assert len(rbin) - len(bins) <= min(prm.nzc + 2, nbp)
        assert len(rbin) % 2 == 0 and np.all(rbin >= 0)
        assert np.array_equal(rbin[0::2], rbin[1::2])
        assert np.all(np.diff(rbin) >= 0)
        inside = rbin < prm.nzc
        assert rbin[inside].max() < prm.force_rows
        assert np.all(rbin[~inside][:-1] <= rbin[~inside][1:])
        for w in range(0, len(rbin), 64):
            win = rbin[w:w + 64]
            win = win[win < prm.nzc]
            if len(win):
                distinct.append(len(np.unique(win)))
                spans.append(win.max() - win.min() + 1)
            plain.append(len(np.unique(bins[w // 2:w // 2 + 32])))
    assert np.mean(distinct) < 3.5 and np.mean(plain) > 10
    assert np.percentile(spans, 99) <= 20


def test_slab_accel_split_probe_patches_the_kernel(tmp_path):
    """probe_slab_accel_split's variants, of this kernel and of the first
    one: each patch matches its source once (so the probe times the kernel
    as it is), every patched variant's source differs from the kernel's,
    the sorted variants time the sorted samples, and a patch that no
    longer matches raises."""
    from exp_tpu_torch import bench_kernels as bk
    from exp_tpu_torch import probe_slab_accel_split as ps
    from exp_tpu_torch.probe_accel_split import make_variants, patched_sources

    roots = make_variants(tmp_path, ps.VARIANTS)
    assert set(roots) == set(ps.VARIANTS)
    for name, root in roots.items():
        srcs = {s for s, _, _ in ps.VARIANTS[name][1]}
        assert bool(srcs) == (name not in ("full", "sorted", "tiles"))
        for src in srcs:
            text = (root / "exp_tpu_torch" / "csrc" / src).read_text()
            assert text != (ps.PORT / "csrc" / src).read_text()
    for variants in (ps.VARIANTS, ps.FIRST_VARIANTS):
        assert {k for k, _ in variants.values()} <= set(bk.EXTRA)
        assert variants["sorted"][0] == "K10sort"
    src, old, new = ps.VARIANTS["no_table"][1][0]
    with pytest.raises(ValueError):
        patched_sources([(src, new + "x", old)])
