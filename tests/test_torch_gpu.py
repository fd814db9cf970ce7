"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of jax or exp_tpu, so it also runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Every test skips without a CUDA device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from exp_tpu_torch.basis.model import hernquist_model
from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
from exp_tpu_torch.bench_sphere import hernquist_sample_np
from exp_tpu_torch.forces.spherical import SphereSL
from exp_tpu_torch.ops import sphere_kernels as sk

N = 20_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(device):
    x, _, m = hernquist_sample_np(N, seed=1)
    x = np.concatenate([x, [[0.0, 0.0, 0.0], [0.0, 0.0, 0.7],
                            [0.0, 0.0, -1.3], [30.0, 0.0, 0.0],
                            [3e-4, 0.0, 1e-4], [0.3, 0.2, 0.1]]])
    m = np.concatenate([m, [1e-4] * 5 + [0.0]])
    return (torch.tensor(x, dtype=torch.float32, device=device),
            torch.tensor(m, dtype=torch.float32, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("lmax", [0, 2, 4, 6])
def test_kernels_match_plain_versions(cuda, lmax):
    """K1: max|dc|/max|c| < 1e-5 (f32 sums in another order); K2: acc
    rtol 1e-4 / atol 1e-6, pot rtol 1e-5 / atol 1e-7 (FMA contraction);
    each wrapper call on the card counts one launch."""
    t = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=lmax,
                            nmax=6, numr=800, cmap=1, rmap=1.0)
    f = SphereSL.from_tables(t, backend="pallas", device=cuda)
    prm = f._kernel_params()
    x, m = _inputs(cuda)
    before = dict(sk.launch_counts)
    c = sk.sphere_coef(x, m, f.tabc_s, f.Mp, prm)
    c0 = sk.sphere_coef_plain(x, m, f.tabc_s, f.Mp, prm)
    torch.cuda.synchronize()
    assert float((c - c0).abs().max() / c0.abs().max()) < 1e-5
    twT = sk.contract_coef_table2(c0, f.tabc_s, f.tabd_s, f.prows)
    a, p = sk.sphere_accel(x, twT, f.fac32, prm)
    a0, p0 = sk.sphere_accel_plain(x, twT, f.fac32, prm)
    torch.cuda.synchronize()
    torch.testing.assert_close(a, a0, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(p, p0, rtol=1e-5, atol=1e-7)
    assert sk.launch_counts["sphere_coef"] == before["sphere_coef"] + 1
    assert sk.launch_counts["sphere_accel"] == before["sphere_accel"] + 1


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(cuda):
    t = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=2,
                            nmax=4, numr=400, cmap=1, rmap=1.0)
    f = SphereSL.from_tables(t, backend="pallas", device=cuda)
    prm = f._kernel_params()
    x, m = _inputs(cuda)
    with pytest.raises(TypeError, match="float32"):
        sk.sphere_coef(x.double(), m, f.tabc_s, f.Mp, prm)
    with pytest.raises(ValueError, match="contiguous"):
        sk.sphere_coef(x.t().contiguous().t(), m, f.tabc_s, f.Mp, prm)
    with pytest.raises(ValueError, match="shape"):
        sk.sphere_coef(x, m[:-1], f.tabc_s, f.Mp, prm)
    with pytest.raises(ValueError, match="is on"):
        sk.sphere_accel(x, f.tabc_s.cpu(), f.fac32, prm)


@pytest.mark.gpu
def test_step_on_card_matches_cpu(cuda):
    """One KDK step through the kernels against the same step through the
    plain versions on the CPU: positions and velocities to f32 roundoff."""
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    t = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=4,
                            nmax=10, numr=2000, cmap=1, rmap=1.0)
    x, v, m = hernquist_sample_np(N, seed=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        f = SphereSL.from_tables(t, backend="pallas", device=dev)
        ps = ParticleSystem.from_arrays(x, v, m, device=dev)
        ps, _, _ = init_force_state(f, ps)
        ps, _, _ = make_kdk_step(f, 1e-3)(ps)
        out[dev.type] = (ps.x.cpu(), ps.v.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the EOF cylinder kernels K4 (cyl_coef) and K5 (cyl_accel)
# ---------------------------------------------------------------------------

# rmax_grid = 0.2 and the inner x edge R = 1e-5 for acyl = 0.01
CYL_EDGE_X = [[0.0, 0.0, 0.0], [0.0, 0.0, 0.05], [0.3, 0.0, 0.0],
              [0.15, 0.1, 0.12], [0.0, 0.0, 0.25], [0.001, 0.0, 0.1999],
              [0.002, 0.001, -0.1995], [1e-5, 0.0, 0.0], [0.0, -3e-6, 1e-6],
              [0.1999, 0.0, 0.0], [0.01, 0.01, 0.0]]


@pytest.fixture(scope="module")
def cyl_tables():
    from exp_tpu_torch.basis.empcyl import build_empcyl_tables

    if not torch.cuda.is_available():       # before the build, not after
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return build_empcyl_tables(mmax=6, nmax=8, lmaxfid=16, nmaxfid=12,
                               acyl=0.01, hcyl=0.002, numx=256, numy=128,
                               rnum=100, tnum=40)


def _cyl_inputs(device):
    from exp_tpu_torch.bench_disk import disk_sample

    x, _, m = disk_sample(N, seed=1)
    x = np.concatenate([x, CYL_EDGE_X])
    m = np.concatenate([m, [1e-4] * (len(CYL_EDGE_X) - 1) + [0.0]])
    return (torch.tensor(x, dtype=torch.float32, device=device),
            torch.tensor(m, dtype=torch.float32, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "linear"])
@pytest.mark.parametrize("ncx", [32, 64])
def test_cyl_kernels_match_plain_versions(cuda, cyl_tables, interp, ncx):
    """K4: max|dG|/max|G| and max|dc|/max|c| < 1e-5 (shared-memory
    atomics sum in a varying order); zero mass gives exactly 0.  K5: acc
    rtol 1e-4 / atol 1e-6 of max|a|, pot rtol 1e-5 / atol 1e-7 of max|pot|
    (FMA contraction); each wrapper call on the card counts one launch."""
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.ops import cyl_kernels as ck

    f = CylinderForce.from_tables(cyl_tables, backend="pallas", ncx=ncx,
                                  pallas_interp=interp, device=cuda)
    prm = f._kernel_params()
    x, m = _cyl_inputs(cuda)
    before = dict(ck.launch_counts)
    G = ck.cyl_coef(x, m, prm)
    G0 = ck.cyl_coef_plain(x, m, prm)
    torch.cuda.synchronize()
    assert float((G - G0).abs().max() / G0.abs().max()) < 1e-5
    c = ck.contract_coef_output(G, f.tab3)
    c0 = ck.contract_coef_output(G0, f.tab3)
    assert float((c - c0).abs().max() / c0.abs().max()) < 1e-5
    assert float(ck.cyl_coef(x, torch.zeros_like(m), prm).abs().max()) == 0.0
    Ct = ck.contract_coef_tables(c0, f.tab3, prm.xrows, prm.ncy)
    a, p = ck.cyl_accel(x, Ct, prm)
    a0, p0 = ck.cyl_accel_plain(x, Ct, prm)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    torch.testing.assert_close(a, a0, rtol=1e-4,
                               atol=1e-6 * float(a0.abs().max()))
    torch.testing.assert_close(p, p0, rtol=1e-5,
                               atol=1e-7 * float(p0.abs().max()))
    assert ck.launch_counts["cyl_coef"] == before["cyl_coef"] + 2
    assert ck.launch_counts["cyl_accel"] == before["cyl_accel"] + 1


@pytest.mark.gpu
def test_cyl_wrappers_reject_bad_inputs(cuda, cyl_tables):
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.ops import cyl_kernels as ck

    f = CylinderForce.from_tables(cyl_tables, backend="pallas", device=cuda)
    prm = f._kernel_params()
    x, m = _cyl_inputs(cuda)
    with pytest.raises(TypeError, match="float32"):
        ck.cyl_coef(x.double(), m, prm)
    with pytest.raises(ValueError, match="contiguous"):
        ck.cyl_coef(x.t().contiguous().t(), m, prm)
    with pytest.raises(ValueError, match="shape"):
        ck.cyl_coef(x, m[:-1], prm)
    Ct = ck.contract_coef_tables(f.coefficients(x, m), f.tab3, prm.xrows,
                                 prm.ncy)
    with pytest.raises(ValueError, match="is on"):
        ck.cyl_accel(x, Ct.cpu(), prm)
    with pytest.raises(ValueError, match="shape"):
        ck.cyl_accel(x, Ct[:, :-1].contiguous(), prm)


@pytest.mark.gpu
def test_cyl_step_on_card_matches_cpu(cuda, cyl_tables):
    """One KDK step of the disk through K4/K5 against the same step through
    the plain versions on the CPU: positions and velocities to f32
    roundoff."""
    from exp_tpu_torch.bench_disk import DT, disk_sample
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    x, v, m = disk_sample(N, seed=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        f = CylinderForce.from_tables(cyl_tables, backend="pallas",
                                      device=dev)
        ps = ParticleSystem.from_arrays(x, v, m, device=dev)
        ps, _, _ = init_force_state(f, ps)
        ps, _, _ = make_kdk_step(f, DT)(ps)
        out[dev.type] = (ps.x.cpu(), ps.v.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the periodic-cube kernels K7 (cube_coef; K11a) and K8 (cube_accel; K11b)
# ---------------------------------------------------------------------------

# the wrap's edges (x = 1.0, -1e-7, -2.75, 3.25, 1000.3) and a zero-mass row
CUBE_EDGE_X = [[1.0, -1e-7, -2.75], [3.25, 1000.3, 0.5],
               [-1e-7, 1.0, 1000.3], [-2.75, 3.25, 1.0], [0.3, 0.2, 0.1]]
CUBE_NMAX = [(3, 3, 3), (6, 6, 6), (4, 3, 2), (0, 8, 1), (8, 8, 8)]


def _cube_inputs(device, perturbed):
    from exp_tpu_torch.bench_cube import cube_sample

    x, _, m = cube_sample(N, perturbed=perturbed, seed=1)
    x = np.concatenate([x, CUBE_EDGE_X])
    m = np.concatenate([m, [1.0 / N] * (len(CUBE_EDGE_X) - 1) + [0.0]])
    return (torch.tensor(x, dtype=torch.float32, device=device),
            torch.tensor(m, dtype=torch.float32, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("nmax", CUBE_NMAX, ids=lambda p: "nmax%d%d%d" % p)
def test_cube_kernels_match_plain_versions(cuda, nmax, perturbed):
    """K7: the coefficients c = -norm S (k = 0 folds to 0, so the total
    mass cannot hide errors), max|dc|/max|c| < 1e-4 on the uniform sample
    (its entries are shot noise, ~1/sqrt(N)) and < 5e-6 on the perturbed
    one; S(-k) = conj S(k) exactly (the kernel mirrors kx < 0); two
    launches agree bit for bit; a zero mass gives exactly 0.  K8 on b =
    c norm: acc and pot within 2e-5 of their largest values; the v1 entry
    (pack_force_matrix) gives the same bits.  Each wrapper call on the card
    counts one launch."""
    from exp_tpu_torch.forces.cube import Cube
    from exp_tpu_torch.ops import cube_kernels as ck

    f = Cube.create(*nmax, backend="pallas", device=cuda)
    prm = f._kernel_params()
    x, m = _cube_inputs(cuda, perturbed)
    before = dict(ck.launch_counts)
    S = ck.cube_coef(x, m, prm)
    S0 = ck.cube_coef_plain(x, m, prm)
    torch.cuda.synchronize()
    c, c0 = -S * f.norm, -S0 * f.norm
    tol = 5e-6 if perturbed else 1e-4
    assert float((c - c0).abs().max() / c0.abs().max()) < tol
    assert torch.equal(S, S.flip(0, 1, 2).conj())
    assert torch.equal(S, ck.cube_coef(x, m, prm))
    assert float(ck.cube_coef(x[-1:], m[-1:], prm).abs().max()) == 0.0
    b = c0 * f.norm
    tab = ck.cube_force_table(b, prm)
    a, p = ck.cube_accel(x, tab, prm)
    a0, p0 = ck.cube_accel_plain(x, tab, prm)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    assert float((a - a0).abs().max()) <= 2e-5 * float(a0.abs().max())
    assert float((p - p0).abs().max()) <= 2e-5 * float(p0.abs().max())
    a1, p1 = ck.cube_accel_v1(x, *ck.pack_force_matrix(b, *nmax), prm)
    assert torch.equal(a1, a) and torch.equal(p1, p)
    assert ck.launch_counts["cube_coef"] == before["cube_coef"] + 3
    assert ck.launch_counts["cube_accel"] == before["cube_accel"] + 2


# ragged particle counts around K7's 64-particle tiles and K8's 32-particle
# warp tiles (the bulk sample is 20,005 rows)
CUBE_RAGGED_N = [1, 31, 33, 63, 65, 127, 4_097]


@pytest.mark.gpu
@pytest.mark.parametrize("n", CUBE_RAGGED_N)
@pytest.mark.parametrize("nmax", [(6, 6, 6), (8, 8, 8)],
                         ids=lambda p: "nmax%d%d%d" % p)
def test_cube_kernels_at_ragged_sizes(cuda, nmax, n):
    """K7 on the first n rows of the perturbed sample and K8 there in the
    whole sample's field: the tiles' ragged tails are zero-filled, so the
    sums hold the C2 tolerances (K7's of the uniform sample, 1e-4 of
    max|c|: a few particles have no dominant mode; K8's 2e-5 of the
    field's largest values over the sample, as C2 takes them), S stays
    Hermitian bit for bit, and K8 writes its n rows.  (The field of a few
    particles is no test of K8: its self-terms cancel to rounding, below
    the plain version's own phase error.)"""
    from exp_tpu_torch.forces.cube import Cube
    from exp_tpu_torch.ops import cube_kernels as ck

    f = Cube.create(*nmax, backend="pallas", device=cuda)
    prm = f._kernel_params()
    xb, mb = _cube_inputs(cuda, True)
    x, m = xb[:n].contiguous(), mb[:n].contiguous()
    S = ck.cube_coef(x, m, prm)
    S0 = ck.cube_coef_plain(x, m, prm)
    torch.cuda.synchronize()
    c, c0 = -S * f.norm, -S0 * f.norm
    assert float((c - c0).abs().max() / c0.abs().max()) < 1e-4
    assert torch.equal(S, S.flip(0, 1, 2).conj())
    b = -ck.cube_coef_plain(xb, mb, prm) * f.norm * f.norm
    tab = ck.cube_force_table(b, prm)
    a, p = ck.cube_accel(x, tab, prm)
    a0, p0 = ck.cube_accel_plain(xb, tab, prm)      # the plain rows are
    torch.cuda.synchronize()                         # independent
    assert a.shape == (n, 3) and p.shape == (n,)
    assert float((a - a0[:n]).abs().max()) <= 2e-5 * float(a0.abs().max())
    assert float((p - p0[:n]).abs().max()) <= 2e-5 * float(p0.abs().max())


@pytest.mark.gpu
def test_cube_wrappers_reject_bad_inputs(cuda):
    from exp_tpu_torch.ops import cube_kernels as ck

    prm = ck.CubeKernelParams(3, 3, 3)
    x, m = _cube_inputs(cuda, False)
    with pytest.raises(TypeError, match="float32"):
        ck.cube_coef(x.double(), m, prm)
    with pytest.raises(ValueError, match="contiguous"):
        ck.cube_coef(x.t().contiguous().t(), m, prm)
    with pytest.raises(ValueError, match="shape"):
        ck.cube_coef(x, m[:-1], prm)
    tab = ck.cube_force_table(ck.cube_coef(x, m, prm), prm)
    with pytest.raises(ValueError, match="is on"):
        ck.cube_accel(x, tab.cpu(), prm)
    with pytest.raises(ValueError, match="shape"):
        ck.cube_accel(x, tab[:, :-1].contiguous(), prm)
    with pytest.raises(NotImplementedError, match="nmax"):
        ck.cube_coef(x, m, ck.CubeKernelParams(9, 3, 3))


@pytest.mark.gpu
@pytest.mark.parametrize("version", [2, 1])
def test_cube_step_on_card_matches_cpu(cuda, version):
    """One KDK step of the perturbed cube through K7/K8 against the same
    step through the plain versions on the CPU: positions and velocities
    to f32 roundoff."""
    from exp_tpu_torch.bench_cube import DT, cube_sample
    from exp_tpu_torch.forces.cube import Cube
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    x, v, m = cube_sample(N, perturbed=True, seed=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        f = Cube.create(6, 6, 6, backend="pallas", pallas_version=version,
                        device=dev)
        ps = ParticleSystem.from_arrays(x, v, m, device=dev)
        ps, _, _ = init_force_state(f, ps)
        ps, _, _ = make_kdk_step(f, DT)(ps)
        out[dev.type] = (ps.x.cpu(), ps.v.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the periodic-slab kernels K9 (slab_coef) and K10 (slab_accel)
# ---------------------------------------------------------------------------

# the wrap's edges (x, y = 1.0, -1e-7, -2.75, 1000.3) with z at and near the
# faces (zmax = 0.1) and beyond them, and a zero-mass row
SLAB_EDGE_X = [[1.0, -1e-7, 0.1], [-1e-7, -2.75, -0.1],
               [-2.75, 1000.3, 0.0999], [1000.3, 1.0, 0.1001],
               [1.0, -1e-7, -0.0999], [-1e-7, -2.75, -0.1001],
               [-2.75, 1000.3, 0.3], [1000.3, 1.0, -0.3],
               [1.0, -1e-7, 1.0], [-1e-7, -2.75, -1.0], [0.3, 0.2, 0.01]]
SLAB_NMAX = [(2, 2), (4, 4), (3, 1)]


def _slab_inputs(device):
    """The bench's sheet, particles at zmax < |z| <= 3 zmax of both signs,
    and the edge rows."""
    from exp_tpu_torch.bench_slab import slab_sample

    x, _, m = slab_sample(N, seed=1)
    rng = np.random.default_rng(3)
    xo = np.stack([rng.uniform(0, 1, 2000), rng.uniform(0, 1, 2000),
                   rng.uniform(0.1, 0.3, 2000) * rng.choice([-1, 1], 2000)],
                  -1)
    x = np.concatenate([x, xo, SLAB_EDGE_X])
    m = np.concatenate([m, np.full(2000, 1.0 / N),
                        [1.0 / N] * (len(SLAB_EDGE_X) - 1) + [0.0]])
    return (torch.tensor(x, dtype=torch.float32, device=device),
            torch.tensor(m, dtype=torch.float32, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "linear"])
@pytest.mark.parametrize("nmax", SLAB_NMAX, ids=lambda p: "nmax%d%d" % p)
def test_slab_kernels_match_plain_versions(cuda, nmax, interp):
    """K9: G over k != 0 within 1e-4 of its largest |G| (shot noise of the
    uniform (x, y)) and the k = 0 row within 1e-5 of its own; G(-k) =
    conj G(k) exactly (the kernel mirrors the half lattice); two launches
    agree bit for bit; zero-mass and |z| > zmax rows give exactly 0; the
    same on a sheet with every particle on one z node and on one spread
    over every node (K9's sort and the ends of its groups' parts).  K10:
    acc and pot within 2e-5 of their largest values.  Each wrapper call on
    the card counts one launch."""
    from exp_tpu_torch.basis.slab import build_slab_tables
    from exp_tpu_torch.forces.slab import SlabForce
    from exp_tpu_torch.ops import slab_kernels as sk

    t = build_slab_tables(nmaxx=nmax[0], nmaxy=nmax[1], nmax=4, zmax=0.1,
                          h=0.01, numz=201)
    f = SlabForce.from_tables(t, backend="pallas", pallas_interp=interp,
                              device=cuda)
    prm = f._kernel_params()
    x, m = _slab_inputs(cuda)
    before = dict(sk.launch_counts)
    G = sk.slab_coef(x, m, prm)
    G0 = sk.slab_coef_plain(x, m, prm)
    torch.cuda.synchronize()
    ctr = (prm.C - 1) // 2
    kn = torch.arange(prm.C, device=cuda) != ctr
    dG = (G - G0).abs()
    assert float(dG[kn].max() / G0[kn].abs().max()) < 1e-4
    assert float(dG[ctr].max() / G0[ctr].abs().max()) < 1e-5
    assert torch.equal(G, G.flip(0).conj())
    assert torch.equal(G, sk.slab_coef(x, m, prm))
    dead = (m == 0) | (x[:, 2].abs() > prm.zmax)
    assert float(sk.slab_coef(x[dead].contiguous(), m[dead].contiguous(),
                              prm).abs().max()) == 0.0
    c0 = sk.contract_coef_output(G0, f.phi_s, f.sgn)
    tab = sk.slab_force_table(c0, f.zq_s, prm)
    aux = sk.slab_force_aux(c0, f.bnd_s, prm)
    a0, p0 = sk.slab_accel_plain(x, tab, aux, prm)
    a, p = sk.slab_accel(x, tab, aux, prm)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    assert float((a - a0).abs().max()) <= 2e-5 * float(a0.abs().max())
    assert float((p - p0).abs().max()) <= 2e-5 * float(p0.abs().max())
    assert sk.launch_counts["slab_coef"] == before["slab_coef"] + 3
    assert sk.launch_counts["slab_accel"] == before["slab_accel"] + 1
    # K9's sort and its window's edges: every particle on one z node, and
    # particles spread over every node
    rng = np.random.default_rng(5)
    for z in (np.full(N, 0.0123), rng.uniform(-prm.zmax, prm.zmax, N)):
        xs = torch.tensor(np.stack([rng.uniform(-1, 2, N), rng.uniform(-1, 2, N),
                                    z], -1), dtype=torch.float32, device=cuda)
        ms = torch.full((N,), 1.0 / N, device=cuda)
        G, G0 = sk.slab_coef(xs, ms, prm), sk.slab_coef_plain(xs, ms, prm)
        torch.cuda.synchronize()
        dG = (G - G0).abs()
        assert float(dG[kn].max() / G0[kn].abs().max()) < 1e-4
        assert float(dG[ctr].max() / G0[ctr].abs().max()) < 1e-5
        assert torch.equal(G, G.flip(0).conj())
        assert torch.equal(G, sk.slab_coef(xs, ms, prm))


@pytest.mark.gpu
def test_slab_wrappers_reject_bad_inputs(cuda):
    from exp_tpu_torch.ops import slab_kernels as sk

    prm = sk.SlabKernelParams(2, 2, 126, 0.1)
    x, m = _slab_inputs(cuda)
    with pytest.raises(TypeError, match="float32"):
        sk.slab_coef(x.double(), m, prm)
    with pytest.raises(ValueError, match="contiguous"):
        sk.slab_coef(x.t().contiguous().t(), m, prm)
    with pytest.raises(ValueError, match="shape"):
        sk.slab_coef(x, m[:-1], prm)
    tab = torch.zeros((prm.force_rows, prm.H, prm.kz, 4), device=cuda)
    aux = torch.zeros((prm.H, 8), device=cuda)
    with pytest.raises(ValueError, match="is on"):
        sk.slab_accel(x, tab.cpu(), aux, prm)
    with pytest.raises(ValueError, match="shape"):
        sk.slab_accel(x, tab[:-1].contiguous(), aux, prm)
    with pytest.raises(NotImplementedError, match="rows in z"):
        sk.slab_coef(x, m, sk.SlabKernelParams(2, 2, 127, 0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("interp,nzc", [("spline", 126), ("linear", 128),
                                        ("spline", 2), ("linear", 2)])
@pytest.mark.parametrize("nmax", [(0, 0), (0, 8), (8, 0), (3, 1), (4, 4),
                                  (8, 8)], ids=lambda p: "nmax%d%d" % p)
def test_slab_accel_sorts_any_sample(cuda, nmax, interp, nzc):
    """K10 on the polynomials of random folded profiles and random
    boundary rows at nmax 0..8 on each axis and the extremes of nzc: acc
    and pot within 2e-5 of their largest values of the plain version's,
    every value finite, and the same bits twice, on the bench's sheet with
    the outside particles and the edge rows (a ragged N), every particle on
    one z node, particles spread over every node and beyond both faces; on
    the first 1, 31, 33 and 1025 rows of the last (the plan's smallest
    tiles, and one past a tile), the full sample's rows bit for bit (a
    particle's arithmetic does not depend on its tile or its place in
    it)."""
    from exp_tpu_torch.ops import slab_kernels as sk

    prm = sk.SlabKernelParams(nmax[0], nmax[1], nzc, 0.1, interp)
    rng = np.random.default_rng(nzc + 10 * nmax[0] + nmax[1])
    rows = torch.tensor(rng.standard_normal((prm.zrows, prm.H, 4)))
    tab = sk.force_poly(rows, interp).transpose(1, 2).to(
        device=cuda, dtype=torch.float32).contiguous()
    aux = torch.tensor(rng.standard_normal((prm.H, 8)), dtype=torch.float32,
                       device=cuda)
    x, _ = _slab_inputs(cuda)
    n = x.shape[0]
    xy = rng.uniform(-1, 2, (n, 2))
    samples = [x] + [torch.tensor(np.concatenate([xy, z[:, None]], -1),
                                  dtype=torch.float32, device=cuda)
                     for z in (np.full(n, 0.0123),
                               rng.uniform(-1.3 * prm.zmax, 1.3 * prm.zmax,
                                           n))]
    for xs in samples:
        a0, p0 = sk.slab_accel_plain(xs, tab, aux, prm)
        a, p = sk.slab_accel(xs, tab, aux, prm)
        a1, p1 = sk.slab_accel(xs, tab, aux, prm)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
        assert float((a - a0).abs().max()) <= 2e-5 * float(a0.abs().max())
        assert float((p - p0).abs().max()) <= 2e-5 * float(p0.abs().max())
        assert torch.equal(a, a1) and torch.equal(p, p1)
    for k in (1, 31, 33, 1025):
        ak, pk = sk.slab_accel(xs[:k].contiguous(), tab, aux, prm)
        assert torch.equal(ak, a[:k]) and torch.equal(pk, p[:k])


@pytest.mark.gpu
def test_slab_step_on_card_matches_cpu(cuda):
    """One KDK step of the bench's sheet through K9/K10 against the same
    step through the plain versions on the CPU: positions and velocities
    to f32 roundoff."""
    from exp_tpu_torch.bench_slab import DT, slab_force, slab_sample, slab_tables
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    t = slab_tables()
    x, v, m = slab_sample(N, seed=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        f = slab_force(t, dev)
        ps = ParticleSystem.from_arrays(x, v, m, device=dev)
        ps, _, _ = init_force_state(f, ps)
        ps, _, _ = make_kdk_step(f, DT)(ps)
        out[dev.type] = (ps.x.cpu(), ps.v.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the sphere's other settings: K3 (sphere_coef_rec), K6 (sphere_accel_poly),
# the 'hat' branches of K1 and K2, and K2 above lmax 6
# ---------------------------------------------------------------------------

_SPHERE_TABLES = {}


def _sphere_tables(lmax):
    if lmax not in _SPHERE_TABLES:
        _SPHERE_TABLES[lmax] = build_sph_sl_tables(
            hernquist_model(rmin=1e-3, rmax=20.0), lmax=lmax, nmax=6,
            numr=800, cmap=1, rmap=1.0)
    return _SPHERE_TABLES[lmax]


def _variant(cuda, lmax, interp, harmonics="auto"):
    """The pallas force of that setting and the inputs: _inputs plus rows
    exactly on hat nodes (where the cell, and the hat derivative, change)."""
    f = SphereSL.from_tables(_sphere_tables(lmax), backend="pallas",
                             pallas_interp=interp, pallas_harmonics=harmonics,
                             device=cuda)
    prm = f._kernel_params()
    x, m = _inputs(cuda)
    if interp == "hat":
        nx = sk.hat_node_points(prm, [3, 60, 200, prm.nc - 2])
        x = torch.cat([x, torch.tensor(nx, device=cuda)])
        m = torch.cat([m, torch.full((len(nx),), 1e-4, device=cuda)])
    return f, prm, x.contiguous(), m.contiguous()


def _twt(f, c):
    return f.accel_table(c)


def _check_coef(fn, plain, x, m, key):
    before = sk.launch_counts[key]
    c, c0 = fn(x, m), plain(x, m)
    torch.cuda.synchronize()
    assert float((c - c0).abs().max() / c0.abs().max()) < 1e-5
    assert sk.launch_counts[key] == before + 1
    # zero-mass and masked rows (beyond rmax, inside rmin) add exactly 0
    dead = torch.tensor([N + 3, N + 4, N + 5], device=x.device)
    assert float(fn(x[dead], m[dead]).abs().max()) == 0.0
    return c0


def _check_accel(a, p, a0, p0):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    torch.testing.assert_close(a, a0, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(p, p0, rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "hat"])
@pytest.mark.parametrize("lmax", [0, 2, 4, 6, 8, 10])
def test_k3_matches_plain_version(cuda, lmax, interp):
    """K3 against sphere_coef_rec_plain: max|dc|/max|c| < 1e-5 (f32 sums in
    another order), masked rows 0, one launch a call; two launches agree
    bit for bit, and zero-mass rows after the live ones change no bit (one
    block, several, more rows than the SMs' blocks take at once), on a
    few hundred live rows and on all of them.  lmax 10 'hat' (numr_c 512)
    is the table whose rows K3 splits into two groups."""
    f, prm, x, m = _variant(cuda, lmax, interp, "recurrence")
    tab = f._radial_table()

    def fn(a, b):
        return sk.sphere_coef_rec(a, b, tab, f.fac32, prm)

    _check_coef(fn, lambda a, b: sk.sphere_coef_rec_plain(a, b, tab,
                                                          f.fac32, prm),
                x, m, "sphere_coef_rec")
    props = torch.cuda.get_device_properties(0)
    plan = sk.k3_plan(x.shape[0], prm, props.multi_processor_count,
                      props.shared_memory_per_block_optin,
                      props.shared_memory_per_multiprocessor)
    assert len(plan.qstart) == (3 if (lmax, interp) == (10, "hat") else 2)
    for live in (200, x.shape[0]):
        ref = fn(x[:live].contiguous(), m[:live].contiguous())
        assert torch.equal(ref, fn(x[:live].contiguous(),
                                   m[:live].contiguous()))
        for cap in (live + 1, 2 * live + 64,
                    32 * sk.K3_WARPS * 2 * props.multi_processor_count * 3):
            assert torch.equal(fn(*_padded(x, m, live, cap)), ref), \
                (live, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("lmax,nc", [(4, 5000), (10, 5000), (4, 9000)])
def test_k3_long_hat_tables(cuda, lmax, nc):
    """K3 on 'hat' tables of many nodes (random values; the kernel does not
    care where a table comes from): the rows split into several groups,
    and at 9,000 nodes the second kernel reads its table slice from device
    memory; against the plain version at 1e-5 of max|c|, bit for bit
    under a second launch and under zero-mass padding."""
    f, prm, x, m = _variant(cuda, lmax, "hat", "recurrence")
    prm = dataclasses.replace(prm, nc=nc)
    rng = np.random.default_rng(nc + lmax)
    tab = torch.tensor(rng.normal(size=(prm.rows, (lmax + 1) * prm.nmax)),
                       dtype=torch.float32, device=cuda)
    x, m = x[:3000].contiguous(), m[:3000].contiguous()
    props = torch.cuda.get_device_properties(0)
    plan = sk.k3_plan(x.shape[0], prm, props.multi_processor_count,
                      props.shared_memory_per_block_optin,
                      props.shared_memory_per_multiprocessor)
    assert len(plan.qstart) > 2
    assert plan.finish_staged == (nc < 9000)
    c = sk.sphere_coef_rec(x, m, tab, f.fac32, prm)
    c0 = sk.sphere_coef_rec_plain(x, m, tab, f.fac32, prm)
    torch.cuda.synchronize()
    assert float((c - c0).abs().max()) <= 1e-5 * float(c0.abs().max())
    assert torch.equal(c, sk.sphere_coef_rec(x, m, tab, f.fac32, prm))
    xp, mp = _padded(x, m, x.shape[0], 4 * x.shape[0])
    assert torch.equal(c, sk.sphere_coef_rec(xp, mp, tab, f.fac32, prm))


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "hat"])
@pytest.mark.parametrize("lmax", [0, 2, 4, 6])
def test_k6_matches_plain_version(cuda, lmax, interp):
    """K6 against sphere_accel_poly_plain: acc rtol 1e-4 / atol 1e-6, pot
    rtol 1e-5 / atol 1e-7 (K2's gates), one launch a call, on _inputs'
    edge rows (the origin, rows beyond rmax, a zero-mass row), with the
    force's Ms and with the Ms of a custom fac; two launches agree bit
    for bit."""
    f, prm, x, m = _variant(cuda, lmax, interp, "poly")
    c0 = sk.sphere_coef_plain(x, m, f._radial_table(), f.Mp, prm)
    twT = _twt(f, c0)
    before = sk.launch_counts["sphere_accel_poly"]
    a, p = sk.sphere_accel_poly(x, twT, f.Ms, prm)
    _check_accel(a, p, *sk.sphere_accel_poly_plain(x, twT, f.Ms, prm))
    assert sk.launch_counts["sphere_accel_poly"] == before + 1
    from exp_tpu_torch.ops.solidharm import standard_fac

    # each harmonic rescaled by a factor in [0.5, 2]
    fac = np.random.default_rng(lmax).uniform(0.5, 2.0, (lmax + 1, lmax + 1))
    fac *= [[standard_fac(l, mm) if mm <= l else 0.0 for mm in range(lmax + 1)]
            for l in range(lmax + 1)]
    Ms = torch.tensor(sk.poly_matrix_stack(lmax, fac.astype(np.float32)),
                      device=cuda)
    a, p = sk.sphere_accel_poly(x, twT, Ms, prm)
    _check_accel(a, p, *sk.sphere_accel_poly_plain(x, twT, Ms, prm))
    a2, p2 = sk.sphere_accel_poly(x, twT, Ms, prm)
    assert torch.equal(a, a2) and torch.equal(p, p2)


@pytest.mark.gpu
@pytest.mark.parametrize("lmax", [0, 2, 4, 6])
def test_k1_hat_matches_plain_version(cuda, lmax):
    """K1's hat branch against sphere_coef_plain, as K1's spline test."""
    f, prm, x, m = _variant(cuda, lmax, "hat")
    _check_coef(lambda a, b: sk.sphere_coef(a, b, f.tabc32, f.Mp, prm),
                lambda a, b: sk.sphere_coef_plain(a, b, f.tabc32, f.Mp, prm),
                x, m, "sphere_coef")


@pytest.mark.gpu
@pytest.mark.parametrize("lmax,interp", [(0, "hat"), (4, "hat"), (8, "hat"),
                                         (10, "hat"), (7, "spline"),
                                         (8, "spline"), (10, "spline")])
def test_k2_hat_and_high_lmax_match_plain_version(cuda, lmax, interp):
    """K2 on 'hat' and on 'spline' above lmax 6 against
    sphere_accel_plain, at K2's gates."""
    f, prm, x, m = _variant(cuda, lmax, interp, "recurrence")
    c0 = sk.sphere_coef_rec_plain(x, m, f._radial_table(), f.fac32, prm)
    twT = _twt(f, c0)
    before = sk.launch_counts["sphere_accel"]
    a, p = sk.sphere_accel(x, twT, f.fac32, prm)
    _check_accel(a, p, *sk.sphere_accel_plain(x, twT, f.fac32, prm))
    assert sk.launch_counts["sphere_accel"] == before + 1


@pytest.mark.gpu
def test_variant_wrappers_reject_bad_inputs(cuda):
    f, prm, x, m = _variant(cuda, 4, "hat", "poly")
    tab = f._radial_table()
    with pytest.raises(TypeError, match="float32"):
        sk.sphere_coef_rec(x, m, tab, f.fac32.double(), prm)
    with pytest.raises(ValueError, match="shape"):
        sk.sphere_coef_rec(x, m, f.tabc_s, f.fac32, prm)
    twT = _twt(f, sk.sphere_coef_plain(x, m, tab, f.Mp, prm))
    with pytest.raises(ValueError, match="shape"):
        sk.sphere_accel_poly(x, twT, f.Ms[:-1].contiguous(), prm)
    with pytest.raises(ValueError, match="is on"):
        sk.sphere_accel_poly(x, twT.cpu(), f.Ms, prm)
    with pytest.raises(ValueError, match="lmax 0..6"):
        sk.sphere_accel_poly(x, twT, f.Ms, dataclasses.replace(prm, lmax=7))
    Ms = f.Ms.clone()
    Ms[~torch.as_tensor(sk.k6_support(prm.lmax), device=cuda)] = 0.5
    with pytest.raises(ValueError, match="outside the support K6"):
        sk.sphere_accel_poly(x, twT, Ms, prm)
    with pytest.raises(ValueError, match="lmax 0..10"):
        sk.sphere_coef_rec(x, m, tab, f.fac32, dataclasses.replace(prm, lmax=11))


@pytest.mark.gpu
@pytest.mark.parametrize("lmax,interp,harmonics", [(4, "hat", "poly"),
                                                   (8, "spline", "auto")])
def test_variant_step_on_card_matches_cpu(cuda, lmax, interp, harmonics):
    """One KDK step under hat + poly (K1-hat, K6-hat) and lmax 8 (K3, K2
    above 6) through the kernels against the plain versions on the CPU:
    positions and velocities to f32 roundoff, as the default setting."""
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    t = _sphere_tables(lmax)
    x, v, m = hernquist_sample_np(N, seed=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        f = SphereSL.from_tables(t, backend="pallas", pallas_interp=interp,
                                 pallas_harmonics=harmonics, device=dev)
        ps = ParticleSystem.from_arrays(x, v, m, device=dev)
        ps, _, _ = init_force_state(f, ps)
        ps, _, _ = make_kdk_step(f, 1e-3)(ps)
        out[dev.type] = (ps.x.cpu(), ps.v.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the composite's multistep buckets: K1, K2, K4 and K5 on tiny and ragged N,
# and the all-finest == flat exactness gate through the kernels
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 3, 1025])
def test_bucket_sizes_match_plain_versions(cuda, cyl_tables, n):
    """A multistep bucket of n rows, the last a padding row (the origin, zero
    mass) where n > 1: K1 and K4 against their plain versions (the
    coefficients within 1e-5 of their largest value), K2 and K5 on the
    field of the full sample (K2's and K5's gates); one launch a call."""
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.ops import cyl_kernels as ck

    def bucket(x, m):
        x, m = x[:n].clone(), m[:n].clone()
        if n > 1:
            x[-1], m[-1] = 0.0, 0.0
        return x, m

    f = SphereSL.from_tables(_sphere_tables(4), backend="pallas", device=cuda)
    prm = f._kernel_params()
    xf, mf = _inputs(cuda)
    x, m = bucket(xf, mf)
    before = dict(sk.launch_counts)
    c = sk.sphere_coef(x, m, f.tabc_s, f.Mp, prm)
    c0 = sk.sphere_coef_plain(x, m, f.tabc_s, f.Mp, prm)
    torch.cuda.synchronize()
    assert float((c - c0).abs().max()) <= 1e-5 * float(c0.abs().max())
    twT = _twt(f, sk.sphere_coef_plain(xf, mf, f.tabc_s, f.Mp, prm))
    a, p = sk.sphere_accel(x, twT, f.fac32, prm)
    _check_accel(a, p, *sk.sphere_accel_plain(x, twT, f.fac32, prm))
    assert sk.launch_counts["sphere_coef"] == before["sphere_coef"] + 1
    assert sk.launch_counts["sphere_accel"] == before["sphere_accel"] + 1

    g = CylinderForce.from_tables(cyl_tables, backend="pallas", device=cuda)
    gp = g._kernel_params()
    xf, mf = _cyl_inputs(cuda)
    x, m = bucket(xf, mf)
    before = dict(ck.launch_counts)
    G = ck.cyl_coef(x, m, gp)
    G0 = ck.cyl_coef_plain(x, m, gp)
    torch.cuda.synchronize()
    assert float((G - G0).abs().max()) <= 1e-5 * float(G0.abs().max())
    Ct = ck.contract_coef_tables(
        ck.contract_coef_output(ck.cyl_coef_plain(xf, mf, gp), g.tab3), g.tab3,
        gp.xrows, gp.ncy)
    a, p = ck.cyl_accel(x, Ct, gp)
    a0, p0 = ck.cyl_accel_plain(x, Ct, gp)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    torch.testing.assert_close(a, a0, rtol=1e-4,
                               atol=1e-6 * float(a0.abs().max()))
    torch.testing.assert_close(p, p0, rtol=1e-5,
                               atol=1e-7 * float(p0.abs().max()))
    assert ck.launch_counts["cyl_coef"] == before["cyl_coef"] + 1
    assert ck.launch_counts["cyl_accel"] == before["cyl_accel"] + 1


@pytest.mark.gpu
def test_multistep_all_finest_equals_flat_on_card(cuda):
    """Every particle at level M == flat KDK stepping at dtime/2^M
    (tests/test_multistep.py:80-99) through K1 and K2 in f32: the finest
    bucket holds the flat order with zero rows after it, which K1 skips
    without moving any live particle to another warp or block, the other
    buckets project to exactly 0 and the weights are exactly 1, so the
    arithmetic is the flat step's: positions and velocities bit for bit,
    Etot within the rounding of its f32 sums (the bucket sums over more
    rows, in another order).  (The plain versions on the CPU are not bit
    exact: the padded chunk's matmul blocks its sums otherwise.)"""
    from dataclasses import replace

    from exp_tpu_torch.nbody.multistep import (MultistepRunner, bucketize,
                                               flatten_buckets)
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import energies, init_force_state, \
        make_kdk_step

    M, dtime, nbig = 2, 0.08, 3
    f = SphereSL.from_tables(_sphere_tables(4), backend="pallas", device=cuda)
    x, v, m = hernquist_sample_np(N, seed=4)
    ps = ParticleSystem.from_arrays(x, v, m, device=cuda)
    ps = replace(ps, level=torch.full((N,), M, dtype=torch.int32,
                                      device=cuda))
    runner = MultistepRunner({"c": f}, {"c": ["c"]}, dtime, M)
    lb = bucketize(ps, M)
    runner.caps = {"c": lb.caps}
    before = dict(sk.launch_counts)
    st, regs, _, _ = runner._init({"c": lb.buckets})
    for _ in range(nbig):
        st, regs, _, diag = runner.bigstep(st, regs)
    # the prime projects every bucket; a big step projects level l 2^l times
    assert sk.launch_counts["sphere_coef"] - before["sphere_coef"] == \
        (M + 1) + nbig * (2 ** (M + 1) - 1)
    fl = flatten_buckets(st["c"])
    live = fl.mass > 0
    ref = ParticleSystem.from_arrays(x, v, m, device=cuda)
    ref, _, d = init_force_state(f, ref)
    step = make_kdk_step(f, dtime / 2 ** M)
    for _ in range(nbig * 2 ** M):
        ref, _, d = step(ref)
    dx = float((fl.x[live] - ref.x).abs().max())
    dv = float((fl.v[live] - ref.v).abs().max())
    assert torch.equal(fl.x[live], ref.x) and torch.equal(fl.v[live], ref.v), \
        (dx, dv)
    assert energies(diag["c"])["Etot"] == pytest.approx(
        energies(d)["Etot"], rel=1e-6)


# ---------------------------------------------------------------------------
# the slab phase-stream probe P1 (stream_coef)
# ---------------------------------------------------------------------------

def _p1_inputs(device, n):
    """The probe's sample, its last rows replaced by edge rows: zero mass,
    |z| > zmax of both signs, z exactly +-zmax (f32)."""
    from exp_tpu_torch import probe_slab_phasestream as probe

    x, m = probe.probe_sample(n, seed=2)
    zmax = np.float32(probe.ZMAX)
    x[-5:, 2] = [0.01, 0.3, -0.25, zmax, -zmax]
    m[-5] = 0.0
    return (torch.tensor(x, device=device), torch.tensor(m, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [20_000, 20_003, 2 ** 20 - 3])
@pytest.mark.parametrize("interp", ["spline", "linear"])
@pytest.mark.parametrize("split", [False, True], ids=["stream1", "stream2"])
def test_p1_matches_plain_version(cuda, split, interp, n):
    """P1 against stream_coef_plain on the same bf16 table: G within 1e-5 of
    max|G| and its k != 0 rows within 1e-4 of their own largest value (f32
    sums in another order; the k != 0 rows are shot noise); two launches
    agree bit for bit; the zero-mass and |z| > zmax rows add exactly 0 and
    the rows at +-zmax count; one launch a call.  n = 20,003 and
    2^20 - 3 (odd) take the synchronous loads."""
    from exp_tpu_torch import probe_slab_phasestream as probe
    from exp_tpu_torch.ops import slab_kernels as lk

    prm = probe.probe_params(interp=interp)
    x, m = _p1_inputs(cuda, n)
    ph = lk.phase_table(x, prm, split)
    before = lk.launch_counts["slab_phasestream"]
    G = lk.stream_coef(ph, x, m, prm)
    G0 = lk.stream_coef_plain(ph, x, m, prm)
    torch.cuda.synchronize()
    dG = (G - G0).abs()
    assert float(dG.max()) <= 1e-5 * float(G0.abs().max())
    kn = torch.arange(prm.C, device=cuda) != (prm.C - 1) // 2
    assert float(dG[kn].max()) <= 1e-4 * float(G0[kn].abs().max())
    assert torch.equal(G, lk.stream_coef(ph, x, m, prm))
    assert lk.launch_counts["slab_phasestream"] == before + 2
    for rows, nonzero in ((slice(-5, -2), False), (slice(-2, None), True)):
        xs, ms = x[rows].contiguous(), m[rows].contiguous()
        g = lk.stream_coef(lk.phase_table(xs, prm, split), xs, ms, prm)
        assert (float(g.abs().max()) > 0.0) == nonzero


@pytest.mark.gpu
def test_p1_wrapper_rejects_bad_inputs(cuda):
    from exp_tpu_torch import probe_slab_phasestream as probe
    from exp_tpu_torch.ops import slab_kernels as lk

    prm = probe.probe_params()
    x, m = _p1_inputs(cuda, 4096)
    ph = lk.phase_table(x, prm)
    with pytest.raises(ValueError, match="phase table"):
        lk.stream_coef(ph[:-1], x, m, prm)
    with pytest.raises(ValueError, match="bf16"):
        lk.stream_coef(ph.float(), x, m, prm)
    with pytest.raises(ValueError, match="bf16"):
        lk.stream_coef(ph[:, :-1], x, m, prm)
    with pytest.raises(TypeError, match="float32"):
        lk.stream_coef(ph, x.double(), m, prm)
    with pytest.raises(ValueError, match="threads"):
        lk.stream_coef(lk.phase_table(x, probe.probe_params(nmax=6)), x, m,
                       probe.probe_params(nmax=6))


# ---------------------------------------------------------------------------
# K1 and K4 under their launch plans (ops/sphere_kernels.k1_plan,
# ops/cyl_kernels.coef_plan): the grid follows the rows
# ---------------------------------------------------------------------------

def _k1_rows_a_block(prm):
    props = torch.cuda.get_device_properties(0)
    return 32 * sk.k1_plan(1, prm, props.multi_processor_count,
                           props.shared_memory_per_block_optin,
                           props.shared_memory_per_multiprocessor).nw


def _padded(x, m, n, cap):
    """Rows [0, n) of (x, m), then zero rows (the origin, zero mass) up to
    cap, as a multistep bucket pads its live rows."""
    return (torch.cat([x[:n], x.new_zeros((cap - n, 3))]).contiguous(),
            torch.cat([m[:n], m.new_zeros((cap - n,))]).contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "hat"])
def test_k1_bitwise_under_trailing_zero_rows(cuda, interp):
    """K1's row-to-block assignment depends on the row index alone: the
    same live rows padded with zero-mass rows to several capacities (one
    block, several, the SM count) give identical coefficients, for live
    counts on both sides of a block's rows and of a warp's; and they agree
    with the plain version at K1's tolerance."""
    f, prm, x, m = _variant(cuda, 4, interp)
    tab = f.tabc_s if interp == "spline" else f.tabc32
    rb = _k1_rows_a_block(prm)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for live in (31, rb - 1, rb, rb + 1, 3 * rb + 33, N):
        ref = None
        for cap in (live, live + 1, rb * ((live + rb - 1) // rb) + 7,
                    2 * live + 64, rb * sms + 5, rb * sms * 3):
            xb, mb = _padded(x, m, live, max(cap, live))
            c = sk.sphere_coef(xb, mb, tab, f.Mp, prm)
            if ref is None:
                ref = c
                c0 = sk.sphere_coef_plain(xb, mb, tab, f.Mp, prm)
                assert float((c - c0).abs().max()) <= \
                    1e-5 * float(c0.abs().max())
            assert torch.equal(c, ref), (live, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "hat"])
@pytest.mark.parametrize("n", [200, 20_000, 300_000])
def test_k1_repeatable_bit_for_bit(cuda, interp, n):
    """Two K1 calls on the same rows give the same bits (the sums run in a
    fixed order: no atomics), on one block and on many."""
    f, prm, _, _ = _variant(cuda, 4, interp)
    tab = f.tabc_s if interp == "spline" else f.tabc32
    xs, _, ms = hernquist_sample_np(n, seed=5)
    x = torch.tensor(xs, dtype=torch.float32, device=cuda)
    m = torch.tensor(ms, dtype=torch.float32, device=cuda)
    a = sk.sphere_coef(x, m, tab, f.Mp, prm)
    assert torch.equal(a, sk.sphere_coef(x, m, tab, f.Mp, prm))


@pytest.mark.gpu
def test_k1_rejects_m_outside_its_support(cuda):
    """K1 multiplies only the entries of M that k1_support allows; an M
    with others is refused, not silently cut."""
    f, prm, x, m = _variant(cuda, 2, "spline")
    bad = f.Mp.clone()
    bad[~torch.as_tensor(sk.k1_support(2), device=cuda)] = 1.0
    with pytest.raises(ValueError, match="outside the support"):
        sk.sphere_coef(x, m, f.tabc_s, bad, prm)


def _k4_check(G, G0):
    assert float((G - G0).abs().max()) <= 1e-5 * float(G0.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "linear"])
def test_k4_matches_plain_on_every_plan_path(cuda, cyl_tables, interp):
    """K4 against its plain version (max|dG| within 1e-5 of max|G|: the
    kernel rounds each update to a fixed point and sums exactly, the plain
    version sums in f32) at sizes that take the one-chunk path (G written
    directly), the boundary to two chunks, and several chunks up to the SM
    count (a second pass sums them); one launch a call; a second call gives
    the same bits (integer sums, chunks in order); zero-mass rows give
    exactly 0."""
    from exp_tpu_torch.bench_disk import disk_sample
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.ops import cyl_kernels as ck

    f = CylinderForce.from_tables(cyl_tables, backend="pallas",
                                  pallas_interp=interp, device=cuda)
    prm = f._kernel_params()
    xs, _, ms = disk_sample(400_000, seed=3)
    x = torch.tensor(xs, dtype=torch.float32, device=cuda)
    m = torch.tensor(ms, dtype=torch.float32, device=cuda)
    props = torch.cuda.get_device_properties(0)
    one = ck.K4_MIN_CHUNK
    chunks = set()
    for n in (1, 33, one, 2 * one - 1, 2 * one, 2 * one + 1, 100_000,
              400_000):
        plan = ck.coef_plan(n, prm, props.multi_processor_count,
                            props.shared_memory_per_block_optin)
        chunks.add(plan.chunks)
        before = ck.launch_counts["cyl_coef"]
        G = ck.cyl_coef(x[:n], m[:n], prm)
        _k4_check(G, ck.cyl_coef_plain(x[:n], m[:n], prm))
        assert ck.launch_counts["cyl_coef"] == before + 1
        assert torch.equal(G, ck.cyl_coef(x[:n], m[:n], prm))
        assert float(ck.cyl_coef(x[:n], torch.zeros_like(m[:n]),
                                 prm).abs().max()) == 0.0
    assert 1 in chunks and 2 in chunks and max(chunks) > 2


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "linear"])
@pytest.mark.parametrize("n", [500, 50_000])
def test_k4_all_rows_on_one_node(cuda, cyl_tables, interp, n):
    """The atomic worst case: every particle at one position, so every warp
    adds into the same (jx, jy) nodes at once.  One particle's G is held
    against the plain version; n particles' G against n times it (f64).
    The kernel rounds each of a chunk's updates once to its fixed point,
    a quantum of at most 2^-29 of the chunk's sum |mass| W_c, so the n_c
    equal updates of an entry are off by at most n_c W_c 2^-30 (and the one
    particle's by mass 2^-30 an entry, n times); converting a chunk's sum to
    f32 and summing the chunks in f32 round by 2^-24 of |G| each.  That
    bound lies below max|G|/n, so one lost update fails it."""
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.ops import cyl_kernels as ck

    f = CylinderForce.from_tables(cyl_tables, backend="pallas",
                                  pallas_interp=interp, device=cuda)
    prm = f._kernel_params()
    x = torch.tensor([[0.011, 0.004, 0.0007]], dtype=torch.float32,
                     device=cuda).repeat(n, 1).contiguous()
    m = torch.full((n,), 0.05 / n, dtype=torch.float32, device=cuda)
    props = torch.cuda.get_device_properties(0)
    plan = ck.coef_plan(n, prm, props.multi_processor_count,
                        props.shared_memory_per_block_optin)
    one = ck.cyl_coef(x[:1], m[:1], prm)
    _k4_check(one, ck.cyl_coef_plain(x[:1], m[:1], prm))
    G = ck.cyl_coef(x, m, prm).double()
    want = n * one.double()
    gmax, msum = float(want.abs().max()), float(m.double().sum())
    per = -(-n // plan.chunks)                  # rows of the largest chunk
    bound = ((per + 1) * msum * 2.0 ** -30
             + (2 * plan.chunks + 2) * 2.0 ** -24 * gmax)
    assert bound < gmax / n
    assert float((G - want).abs().max()) <= bound


# ---------------------------------------------------------------------------
# K2 and K5 under their launch plans (ops/sphere_kernels.k2_plan,
# ops/cyl_kernels.accel_plan): a particle across a group of lanes on a
# small bucket, on one thread on a large one
# ---------------------------------------------------------------------------

def _props():
    props = torch.cuda.get_device_properties(0)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def _check_cyl_accel(a, p, a0, p0):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    torch.testing.assert_close(a, a0, rtol=1e-4,
                               atol=1e-6 * float(a0.abs().max()))
    torch.testing.assert_close(p, p0, rtol=1e-5,
                               atol=1e-7 * float(p0.abs().max()))


def _same_rows(out, padded, n):
    return (torch.equal(out[0], padded[0][:n])
            and torch.equal(out[1], padded[1][:n]))


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "hat"])
def test_k2_sweep_sizes_padding_and_repeat(cuda, interp):
    """K2 on the sweep's buckets (224 ... 1,048,576 rows of a Hernquist
    sample, the last a padding row at the origin): against its plain
    version at K2's gates, bit for bit the same on the same rows padded to
    2n + 64 (a particle's output depends on its row alone, whatever the
    plan the rows give), and on a second call."""
    from exp_tpu_torch.bench_kernels import SWEEP_SIZES, bucket

    f, prm, _, _ = _variant(cuda, 4, interp)
    xs, _, ms = hernquist_sample_np(SWEEP_SIZES[-1], seed=6)
    x = torch.tensor(xs, dtype=torch.float32, device=cuda)
    m = torch.tensor(ms, dtype=torch.float32, device=cuda)
    twT = _twt(f, sk.sphere_coef(x, m, f._radial_table(), f.Mp, prm))
    for n in SWEEP_SIZES:
        xb, mb = bucket(x, m, n)
        out = sk.sphere_accel(xb, twT, f.fac32, prm)
        _check_accel(*out, *sk.sphere_accel_plain(xb, twT, f.fac32, prm))
        xp, _ = bucket(x, m, n, cap=2 * n + 64)
        assert _same_rows(out, sk.sphere_accel(xp, twT, f.fac32, prm), n), n
        assert _same_rows(out, sk.sphere_accel(xb, twT, f.fac32, prm), n), n


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "hat"])
@pytest.mark.parametrize("lmax", [0, 4, 6, 8, 10])
def test_k2_every_plan_gives_the_same_bits(cuda, lmax, interp):
    """K2 at lmax 0 ... 10 with a particle on its lanes and on one thread,
    on the sample with edge rows and rows on hat nodes: each at K2's gates
    against the plain version, one launch a call, both bit for bit the
    same (the columns' sums add in the order of m either way)."""
    f, prm, x, m = _variant(cuda, lmax, interp, "recurrence")
    c0 = sk.sphere_coef_rec_plain(x, m, f._radial_table(), f.fac32, prm)
    twT = _twt(f, c0)
    a0, p0 = sk.sphere_accel_plain(x, twT, f.fac32, prm)
    outs = []
    for threads in sorted({1, sk.k2_lanes(lmax)}):
        plan = sk.k2_plan(x.shape[0], prm, *_props(), threads=threads)
        before = sk.launch_counts["sphere_accel"]
        out = sk.sphere_accel(x, twT, f.fac32, prm, plan=plan)
        assert sk.launch_counts["sphere_accel"] == before + 1
        _check_accel(*out, a0, p0)
        outs.append(out)
    for out in outs[1:]:
        assert _same_rows(out, outs[0], x.shape[0])


_CYL_TABLES = {}


def _cyl_tables_mmax(mmax):
    from exp_tpu_torch.basis.empcyl import build_empcyl_tables

    if mmax not in _CYL_TABLES:
        _CYL_TABLES[mmax] = build_empcyl_tables(
            mmax=mmax, nmax=8, lmaxfid=16, nmaxfid=12, acyl=0.01, hcyl=0.002,
            numx=128, numy=64, rnum=100, tnum=40)
    return _CYL_TABLES[mmax]


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "linear"])
def test_k5_sweep_sizes_padding_and_repeat(cuda, cyl_tables, interp):
    """K5 on the sweep's buckets of a disk sample (the last row a padding
    row at the origin): against its plain version at K5's gates, bit for
    bit the same on the same rows padded to 2n + 64 and on a second
    call."""
    from exp_tpu_torch.bench_disk import disk_sample
    from exp_tpu_torch.bench_kernels import SWEEP_SIZES, bucket
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.ops import cyl_kernels as ck

    f = CylinderForce.from_tables(cyl_tables, backend="pallas",
                                  pallas_interp=interp, device=cuda)
    prm = f._kernel_params()
    xs, _, ms = disk_sample(SWEEP_SIZES[-1], seed=6)
    x = torch.tensor(xs, dtype=torch.float32, device=cuda)
    m = torch.tensor(ms, dtype=torch.float32, device=cuda)
    Ct = ck.contract_coef_tables(f.coefficients(x, m), f.tab3, prm.xrows,
                                 prm.ncy)
    for n in SWEEP_SIZES:
        xb, _ = bucket(x, m, n)
        out = ck.cyl_accel(xb, Ct, prm)
        _check_cyl_accel(*out, *ck.cyl_accel_plain(xb, Ct, prm))
        xp, _ = bucket(x, m, n, cap=2 * n + 64)
        assert _same_rows(out, ck.cyl_accel(xp, Ct, prm), n), n
        assert _same_rows(out, ck.cyl_accel(xb, Ct, prm), n), n


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["spline", "linear"])
@pytest.mark.parametrize("mmax", [0, 6, 7])
def test_k5_mmax_and_plans_match_plain_version(cuda, mmax, interp):
    """K5 at mmax 0, 6 and 7 on the disk sample with edge rows, with each
    lane setting its particle up and with the set-up broadcast: each at
    K5's gates against the plain version, one launch a call, both bit for
    bit the same, and a second call too."""
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.ops import cyl_kernels as ck

    f = CylinderForce.from_tables(_cyl_tables_mmax(mmax), backend="pallas",
                                  pallas_interp=interp, device=cuda)
    prm = f._kernel_params()
    x, m = _cyl_inputs(cuda)
    Ct = ck.contract_coef_tables(f.coefficients(x, m), f.tab3, prm.xrows,
                                 prm.ncy)
    a0, p0 = ck.cyl_accel_plain(x, Ct, prm)
    outs = []
    for broadcast in (False, True):
        plan = ck.accel_plan(x.shape[0], prm, *_props(), broadcast=broadcast)
        before = ck.launch_counts["cyl_accel"]
        out = ck.cyl_accel(x, Ct, prm, plan=plan)
        assert ck.launch_counts["cyl_accel"] == before + 1
        _check_cyl_accel(*out, a0, p0)
        assert _same_rows(out, ck.cyl_accel(x, Ct, prm, plan=plan),
                          x.shape[0])
        outs.append(out)
    assert _same_rows(outs[0], outs[1], x.shape[0])


# ---------------------------------------------------------------------------
# the YAML driver (nbody/simulation.py, run.py) on the card
# ---------------------------------------------------------------------------

DRIVER_CONFIG = """\
Global:
  dtime: {dtime}
  nsteps: {nsteps}
  runtag: g
  outdir: {outdir}
{extra}Components:
  - name: halo
    bodyfile: halo.bods
    force:
      id: sphereSL
      parameters: {{Lmax: 4, nmax: 10, numr: 2000, rmapping: 1.0,
                   modelname: 'hernquist:a=1,M=1', backend: pallas}}
  - name: disk
    bodyfile: disk.bods
    force:
      id: cylinder
      parameters: {{mmax: 4, nmax: 6, lmaxfid: 8, nmaxfid: 8, ncylnx: 128,
                   ncylny: 64, rnum: 50, tnum: 20, backend: pallas}}
Output:
  - id: outlog
    parameters: {{nint: 1}}
"""


def _outlog(path):
    rows = [r for r in open(path).read().splitlines()
            if not r.startswith("#") and "Time" not in r]
    a = np.array([[float(v) for v in r.split("|")] for r in rows])
    return np.delete(a, 17, 1)              # the wall clock


@pytest.mark.gpu
@pytest.mark.parametrize("multistep", [0, 2])
def test_driver_on_card_matches_cpu(cuda, tmp_path, multistep):
    """A halo (16,384) + disk (4,096) run config with backend: pallas,
    single-rate (3 steps) and multistep (M=2, 2 big steps), through
    `python -m exp_tpu_torch.run` on the card and with --device cpu: the
    same OUTLOG to the kernels' force tolerance (K2/K5 acc rtol 1e-4;
    atol 1e-6 for the columns that are sums cancelling to ~0), the same
    level populations, and the card's run through K1, K2, K4 and K5."""
    from exp_tpu_torch.bench_disk import disk_sample
    from exp_tpu_torch.nbody.particles import write_ascii_bodies
    from exp_tpu_torch.ops import cyl_kernels as ck
    from exp_tpu_torch.run import main

    xh, vh, mh = hernquist_sample_np(16_384, seed=5)
    write_ascii_bodies(tmp_path / "halo.bods", (xh, vh, 0.95 * mh))
    write_ascii_bodies(tmp_path / "disk.bods", disk_sample(4_096, seed=5))
    # the disk's finest orbits overrun M=2 at this dtime; maxMindt 1 keeps
    # the sanity stop (which would write an HDF5 checkpoint) out of it
    extra = ("  multistep: 2\n  dynfracV: 0.01\n  dynfracA: 0.03\n"
             "  maxMindt: 1.0\n" if multistep else "")
    dtime, nsteps = (2e-3, 2) if multistep else (1e-3, 3)
    sims = {}
    for dev in ("cuda", "cpu"):
        p = tmp_path / f"{dev}.yml"
        p.write_text(DRIVER_CONFIG.format(dtime=dtime, nsteps=nsteps,
                                          outdir=dev, extra=extra))
        before = {**sk.launch_counts, **ck.launch_counts}
        sims[dev] = main([str(p), "--device", dev])
        after = {**sk.launch_counts, **ck.launch_counts}
        ran = {k: after[k] - before[k] for k in
               ("sphere_coef", "sphere_accel", "cyl_coef", "cyl_accel")}
        if dev == "cuda":
            assert all(n > 0 for n in ran.values()), ran
        else:
            assert not any(ran.values()), ran
    a, b = _outlog(tmp_path / "cuda" / "OUTLOG.g"), \
        _outlog(tmp_path / "cpu" / "OUTLOG.g")
    assert a.shape == b.shape == (nsteps + 1, 17 + 2 * 15)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    if multistep:
        counts = [s._ms_runner.level_counts(s._ms_state)
                  for s in sims.values()]
        assert counts[0] == counts[1]


# ---------------------------------------------------------------------------
# the remaining forces: the analytic bases and twocenter on K1 / K2, and
# the direct sum in f32 against f64
# ---------------------------------------------------------------------------

def _analytic(cuda, kind):
    from exp_tpu_torch.basis.analytic import make_analytic_force

    return make_analytic_force(kind, 4, 10, rmin=1e-3, rmax=50.0, numr=2000,
                               backend="pallas", device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hernq", "CBsphere"])
def test_analytic_bases_on_k1_k2(cuda, kind):
    """hernq and CBsphere on the pallas backend (cmap 1 tables): K1 and K2
    against their plain versions at test_kernels_match_plain_versions'
    tolerances, and the force's own passes launch them."""
    f = _analytic(cuda, kind)
    prm = f._kernel_params()
    assert prm.cmap == 1 and f._harmonics_eff("coef") == "poly"
    x, m = _inputs(cuda)
    c0 = sk.sphere_coef_plain(x, m, f.tabc_s, f.Mp, prm)
    before = dict(sk.launch_counts)
    c = f.coefficients(x, m)
    torch.cuda.synchronize()
    assert float((c - c0).abs().max() / c0.abs().max()) < 1e-5
    a, p = f.acceleration(c0, x)
    a0, p0 = sk.sphere_accel_plain(x, f.accel_table(c0), f.fac32, prm)
    torch.cuda.synchronize()
    torch.testing.assert_close(a, a0, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(p, p0, rtol=1e-5, atol=1e-7)
    assert sk.launch_counts["sphere_coef"] == before["sphere_coef"] + 1
    assert sk.launch_counts["sphere_accel"] == before["sphere_accel"] + 1


@pytest.mark.gpu
def test_twocenter_pair_on_k1_k2(cuda):
    """TwoCenterForce over two pallas hernq expansions: each of the pair of
    coefficient sets and the summed field against the plain versions on
    the reweighted, recentered inputs; two launches of each kernel."""
    from exp_tpu_torch.forces.twocenter import TwoCenterForce

    x, m = _inputs(cuda)
    c1 = torch.tensor([1.5, 0.0, 0.0], device=cuda)
    c2 = torch.tensor([0.2, 0.1, 0.0], device=cuda)
    tc = TwoCenterForce(inner=_analytic(cuda, "hernq"),
                        outer=_analytic(cuda, "hernq"), c1=c1, c2=c2,
                        alpha=2.0)
    before = dict(sk.launch_counts)
    pair = tc.coefficients(x, m)
    a, p = tc.acceleration(pair, x)
    torch.cuda.synchronize()
    assert sk.launch_counts["sphere_coef"] == before["sphere_coef"] + 2
    assert sk.launch_counts["sphere_accel"] == before["sphere_accel"] + 2
    mix = tc.mixture(x)
    a_sum = p_sum = 0.0
    for f, c, cen, w in ((tc.inner, pair[0], c1, 1 - mix),
                         (tc.outer, pair[1], c2, mix)):
        prm = f._kernel_params()
        xc = (x - cen).contiguous()
        c0 = sk.sphere_coef_plain(xc, (m * w).contiguous(), f.tabc_s, f.Mp,
                                  prm)
        assert float((c - c0).abs().max() / c0.abs().max()) < 1e-5
        a0, p0 = sk.sphere_accel_plain(xc, f.accel_table(c), f.fac32, prm)
        a_sum, p_sum = a_sum + a0, p_sum + p0
    torch.testing.assert_close(a, a_sum, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(p, p_sum, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["plummer", "spline", "mn", "pm"])
def test_direct_f32_matches_f64(cuda, kind):
    """DirectForce at 65,536 bodies on the card, f32 against f64: max|da| /
    max|a| < 1e-4 and max|dpot| / max|pot| < 1e-5 (chip_smoke.py's
    DIRECT_* tolerances), with the default 1 GiB temporary cap."""
    from exp_tpu_torch.basis.model import plummer_model
    from exp_tpu_torch.forces.direct import DirectForce

    kw = {"plummer": dict(eps=0.01, kernel="plummer"),
          "spline": dict(eps=0.05, kernel="spline"),
          "mn": dict(mn_model=True, a=0.8, b=0.2),
          "pm": dict(eps=1e-3, kernel="plummer")}[kind]
    x, _, m = hernquist_sample_np(65_536, seed=3)
    out = {}
    for dt in (torch.float32, torch.float64):
        f = (DirectForce.with_pm_model(
            plummer_model(a=0.5, M=1.0, rmin=1e-3, rmax=5.0), device=cuda,
            **kw) if kind == "pm" else DirectForce(**kw).to(cuda))
        xs = torch.tensor(x, dtype=dt, device=cuda)
        ms = torch.tensor(m, dtype=dt, device=cuda)
        out[dt] = f.acceleration(f.coefficients(xs, ms), xs)
    (a32, p32), (a64, p64) = out[torch.float32], out[torch.float64]
    assert float((a32.double() - a64).abs().max() / a64.abs().max()) < 1e-4
    assert float((p32.double() - p64).abs().max() / p64.abs().max()) < 1e-5


@pytest.mark.gpu
def test_analysis_basis_on_card_matches_cpu(cuda, tmp_path):
    """The analysis library on a `backend: pallas` sphereSL stanza (Lmax 4,
    nmax 10) on the card against the same Basis on the CPU (the kernels'
    plain versions): create_from_snapshots launches K1 once a snapshot,
    agreeing to max|dc|/max|c| < 1e-5; get_fields launches K2 once,
    acc rtol 1e-4 / atol 1e-6 and pot rtol 1e-5 / atol 1e-7 as the
    kernels' own tests, the f64 density (plain torch) to 1e-10;
    FieldBasis launches K1 once a field."""
    from exp_tpu_torch.analysis.basis import Basis
    from exp_tpu_torch.analysis.field_basis import FieldBasis

    hernquist_model(rmin=1e-4, rmax=20.0, numr=1000).to_file(
        tmp_path / "halo.model")
    conf = {"id": "sphereSL", "parameters": {
        "modelname": "halo.model", "Lmax": 4, "nmax": 10, "numr": 800,
        "rmapping": 1.0, "backend": "pallas"}}
    bc = Basis.factory(conf, workdir=str(tmp_path), device=cuda)
    bh = Basis.factory(conf, workdir=str(tmp_path), device="cpu")
    x, v, m = hernquist_sample_np(N, seed=2)
    snaps = [(x * (1.0 + 0.01 * t), m) for t in range(3)]
    before = dict(sk.launch_counts)
    cc = bc.create_from_snapshots(snaps).as_array()
    assert sk.launch_counts["sphere_coef"] == before["sphere_coef"] + 3
    ch = bh.create_from_snapshots(snaps).as_array()
    assert np.abs(cc - ch).max() / np.abs(ch).max() < 1e-5
    pts = x[:4096]
    dc, pc, ac = bc.get_fields(ch[0], pts)
    assert sk.launch_counts["sphere_accel"] == before["sphere_accel"] + 1
    dh, ph, ah = bh.get_fields(ch[0], pts)
    np.testing.assert_allclose(ac, ah, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pc, ph, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dc, dh, rtol=1e-10, atol=1e-13)
    FieldBasis(bc.force).coefficients(x, v, m)
    assert sk.launch_counts["sphere_coef"] == before["sphere_coef"] + 7


@pytest.mark.gpu
def test_analysis_tableless_force_stays_on_card(cuda):
    """A shells stanza (a force without tables) through Basis.factory with
    no device runs on the card: the Basis, its uploads, the force's
    coefficients and FieldBasis's stay on CUDA (cumulative masses to 1e-12
    of the CPU Basis's: f64 sums in another order)."""
    from exp_tpu_torch.analysis.basis import Basis, upload
    from exp_tpu_torch.analysis.field_basis import FieldBasis

    stanza = {"id": "shells", "parameters": {"rmax": 20.0, "nbins": 64}}
    b = Basis.factory(stanza)
    assert b.device.type == "cuda"
    x, v, m = hernquist_sample_np(N, seed=3)
    xd, md = upload(b.device, x, m)
    assert xd.device.type == md.device.type == "cuda"
    assert b.force.coefficients(xd, md).device.type == "cuda"
    fc = FieldBasis(b.force).coefficients(x, v, m)
    assert all(c.device.type == "cuda" for c in fc.values())
    ch = Basis.factory(stanza, device="cpu").create_coefficients(x, m)
    cc = b.create_coefficients(x, m)
    np.testing.assert_allclose(cc, ch, rtol=1e-12, atol=1e-12 * ch.max())


@pytest.mark.gpu
def test_vr1_hat_step_against_f64_comparator(cuda):
    """chip_smoke.py's VR1 (b): the comparator's problem through K1 'hat'
    and K2 'hat' (pallas_precision 'highest', the hats on the table's own
    nodes), 26 launches each over 25 KDK steps, the coefficients of every
    step within three times the plain versions' CPU drift (4.51e-7,
    python -m exp_tpu_torch.bench_validate b --device cpu --threads 1) of
    the f64 comparator's trajectory."""
    from exp_tpu_torch.bench_validate import B_STEPS, case_b

    sk.reset_launch_counts()
    rep, force = case_b(cuda)
    assert force._interp_eff == "hat" and force.numr_c == force.grid.numr
    assert sk.launch_counts["sphere_coef"] == B_STEPS + 1
    assert sk.launch_counts["sphere_accel"] == B_STEPS + 1
    assert rep["drift_max"] <= 3 * 4.5102455053879105e-07, rep
