"""The port's remaining initial conditions (exp_tpu_torch/ic: qpdistf.py,
zang.py, ellip.py, diskhalo2d.py, and EllipsoidForce's mass_inertia and
monopole_quadrupole in ellipsoid.py) against exp_tpu's, at the sizes of
exp_tpu's own tests, on the CPU.

Tolerances:
  * QPDistF at tests/test_qpdistf.py's grid (egrid 14, kgrid 6, mgrid 56,
    nint 28): X, Egrid, Kgrid and resid to 1e-12 (the fit is host NumPy
    in both); f_EK, Jmax(E) and the density to 1e-12 of their largest
    value (the port evaluates them as f64 tensors, in the separable form
    of the kernel sum); sample_qp_model at 4,096 particles: positions and
    masses equal, velocities within 1e-12 (the acceptance tests see the
    same draws, and no trial flips);
  * sample_zang_disk at 20,000 particles, with and without the azimuthal
    replicas: equal bit for bit (NumPy in both);
  * EllipForce, ellip_monopole_mass, add_ellip_to_model (with and without
    `smooth`), mass_inertia and monopole_quadrupole: 1e-10 of each
    largest value;
  * diskhalo2d at tests/test_diskhalo2d.py's sizes (8,192 + 4,096, lmax 2
    nmax 6, flatdisk mmax 2 nmax 8) on tables built by exp_tpu and carried
    across: positions, masses and halo velocities equal; disk velocities
    within FIELD_TOL 1e-5 of their largest value (drawn from Jeans tables
    of f32 fields summed in another order), for the port's pallas forces
    (the kernels' plain versions here) against exp_tpu's pallas forces (its
    kernels in interpret mode), and its matmul/xla forces against exp_tpu's
    defaults (the same backends); the composite's
    virial ratio within 0.05 of 1 (tests/test_diskhalo2d.py:77)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.model import hernquist_model as j_hernquist
from exp_tpu_torch.basis.model import hernquist_model


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


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------------
# QPDistF
# ---------------------------------------------------------------------------

QP_GRID = dict(egrid=14, kgrid=6, mgrid=56, nint=28)


@pytest.fixture(scope="module")
def qp():
    from exp_tpu.ic.qpdistf import QPDistF as JQ
    from exp_tpu_torch.ic.qpdistf import QPDistF

    return (JQ(j_hernquist(rmin=1e-3, rmax=20.0), **QP_GRID),
            QPDistF(hernquist_model(rmin=1e-3, rmax=20.0), device="cpu",
                    **QP_GRID))


def test_qpdistf_fit_matches_exp_tpu(qp):
    dj, dt = qp
    for k in ("X", "Egrid", "Kgrid", "sigma_E", "sigma_K"):
        assert _rel(getattr(dt, k), getattr(dj, k)) <= 1e-12, k
    assert dt.resid == pytest.approx(dj.resid, rel=1e-12)
    E = np.linspace(dj.Egrid[0], dj.Egrid[-1], 40)
    K = np.linspace(0.0, 1.0, 17)
    EE, KK = np.meshgrid(E, K, indexing="ij")
    assert _rel(dt.f_EK(EE, KK), dj.f_EK(EE, KK)) <= 1e-12
    assert (dt.f_EK(EE, KK) >= 0).all()
    assert _rel(dt.jmax(E), dj.jmax(E)) <= 1e-12
    J = 0.3 * dj.jmax(E)
    assert _rel(dt.distf(E, J), dj.distf(E, J)) <= 1e-12
    R = dj._Rgrid[::8]
    assert _rel(dt.density(R), dj.density(R)) <= 1e-12
    # a tensor in, a tensor out on the DF's device
    ft = dt.f_EK(torch.tensor(EE), torch.tensor(KK))
    assert isinstance(ft, torch.Tensor) and ft.dtype == torch.float64


def test_qpdistf_penalty_matches_exp_tpu():
    """The anisotropy penalty (tests/test_qpdistf.py:72's fit)."""
    from exp_tpu.ic.qpdistf import QPDistF as JQ
    from exp_tpu_torch.ic.qpdistf import QPDistF

    kw = dict(egrid=10, kgrid=6, mgrid=40, nint=24, lam=1e4, alpha=2.0)
    dj = JQ(j_hernquist(rmin=1e-3, rmax=20.0), **kw)
    dt = QPDistF(hernquist_model(rmin=1e-3, rmax=20.0), device="cpu", **kw)
    assert _rel(dt.X, dj.X) <= 1e-12


def test_sample_qp_model_matches_exp_tpu(qp):
    """The same draws in the same order: positions and masses equal,
    velocities within 1e-12; the sample starts in virial equilibrium
    (tests/test_qpdistf.py:66) and below the escape speed."""
    from exp_tpu.ic.qpdistf import sample_qp_model as j_sample
    from exp_tpu_torch.ic.qpdistf import sample_qp_model

    dj, dt = qp
    for zero_com in (True, False):
        xj, vj, mj = j_sample(dj.model, 4096, seed=3, df=dj,
                              zero_com=zero_com)
        x, v, mass = sample_qp_model(dt.model, 4096, seed=3, df=dt,
                                     zero_com=zero_com)
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(mass, mj)
        assert np.abs(v - vj).max() <= 1e-12
    # the last sample (no COM shift) in the model's own potential
    hern = dt.model
    r = np.linalg.norm(x, axis=1)
    T = 0.5 * np.sum(mass * np.sum(v * v, 1))
    VC = np.sum(mass * r * hern.get_dpot(r))
    assert abs(2 * T / VC - 1.0) < 0.06
    vesc2 = 2.0 * (dt._Emax - hern.get_pot(r))
    assert (np.sum(v * v, 1) <= vesc2 * (1 + 1e-10)).all()


def test_qpdistf_refuses_without_a_device():
    """No card and no device named: the DF refuses (never a silent CPU
    run)."""
    from exp_tpu_torch.ic.qpdistf import QPDistF

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QPDistF(hernquist_model(rmin=1e-3, rmax=20.0), egrid=6, kgrid=4,
                mgrid=12, nint=8)


# ---------------------------------------------------------------------------
# Zang disk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(nrepl=4, zero_com=False,
                                             zero_cov=False, sigma=0.4)],
                         ids=["defaults", "nrepl4"])
def test_sample_zang_disk_equal(kw):
    from exp_tpu.ic.zang import TaperedMestelDF as JDF
    from exp_tpu.ic.zang import sample_zang_disk as j_sample
    from exp_tpu_torch.ic.zang import TaperedMestelDF, sample_zang_disk

    a = sample_zang_disk(20_000, seed=7, **kw)
    b = j_sample(20_000, seed=7, **kw)
    for u, w in zip(a, b):
        np.testing.assert_array_equal(u, w)
    assert np.all(a[0][:, 2] == 0.0) and np.all(a[1][:, 2] == 0.0)
    r = np.geomspace(1e-2, 40.0, 30)
    np.testing.assert_array_equal(TaperedMestelDF().surface_density(r),
                                  JDF().surface_density(r))
    np.testing.assert_array_equal(TaperedMestelDF().log_f(-1.0, r),
                                  JDF().log_f(-1.0, r))


# ---------------------------------------------------------------------------
# ellipsoids
# ---------------------------------------------------------------------------

def test_ellip_force_and_model_match_exp_tpu():
    """EllipForce's tables, the bar's monopole mass (raw and smoothed) and
    the composite halo + bar model (tests/test_cli.py:849's settings)."""
    from exp_tpu.ic import ellip as je
    from exp_tpu_torch.ic import ellip as te

    bj = je.EllipForce(0.5, 0.25, 0.125, 0.1, num=48, numr=120)
    bt = te.EllipForce(0.5, 0.25, 0.125, 0.1, num=48, numr=120)
    for k in ("r", "m", "p"):
        assert _rel(getattr(bt, k), getattr(bj, k)) <= 1e-10, k
    rg = np.geomspace(1e-3, 5.0, 300)
    assert _rel(bt.get_pot(rg), bj.get_pot(rg)) <= 1e-10
    for smooth in (0.0, 0.02):
        assert _rel(te.ellip_monopole_mass(bt, rg, 0.5, smooth=smooth),
                    je.ellip_monopole_mass(bj, rg, 0.5, smooth=smooth)) \
            <= 1e-10
        mj = je.add_ellip_to_model(j_hernquist(rmin=1e-3, rmax=20.0), bj,
                                   rbar=0.5, smooth=smooth)
        mt = te.add_ellip_to_model(hernquist_model(rmin=1e-3, rmax=20.0),
                                   bt, rbar=0.5, smooth=smooth)
        for k in ("r", "rho", "mass", "pot"):
            assert _rel(getattr(mt, k), getattr(mj, k)) <= 1e-10, (k, smooth)
        assert mt.comment == mj.comment


@pytest.mark.parametrize("bartype,param", [("ferrers", 1.0),
                                           ("powerlaw", -0.5),
                                           ("expon", 0.2)])
def test_ellipsoid_mass_inertia_and_tables(bartype, param):
    from exp_tpu.ic.ellipsoid import EllipsoidForce as JE
    from exp_tpu_torch.ic.ellipsoid import EllipsoidForce

    kw = dict(a=(1.0, 0.5, 0.25), mass=0.3, bartype=bartype, param=param,
              num=24)
    ej, et = JE(**kw), EllipsoidForce(**kw)
    Mj, Ij = ej.mass_inertia()
    Mt, It = et.mass_inertia(device="cpu")
    assert Mt == pytest.approx(Mj, rel=1e-10)
    assert _rel(It, Ij) <= 1e-10
    for u, w in zip(et.monopole_quadrupole(numr=24, device="cpu"),
                    ej.monopole_quadrupole(numr=24)):
        assert _rel(u, w) <= 1e-10


# ---------------------------------------------------------------------------
# razor-thin disk + halo
# ---------------------------------------------------------------------------

ACYL, MDISK = 0.01, 0.05
N_HALO, N_DISK = 8192, 4096
# the port's and exp_tpu's f32 fields differ by the order of their f32
# sums (tests/test_torch_diskhalo.py's FIELD_TOL): 1e-5 of the largest
# disk velocity
FIELD_TOL = 1e-5


@pytest.fixture(scope="module")
def bases2d():
    """exp_tpu's tests/test_diskhalo2d.py bases, their tables carried to
    the port, and exp_tpu's ICs through its pallas forces (its Pallas
    kernels in interpret mode) and through its default ones."""
    from exp_tpu.basis.flatdisk import build_flatdisk_tables
    from exp_tpu.basis.slgrid import build_sph_sl_tables
    from exp_tpu.forces.cylinder import CylinderForce
    from exp_tpu.forces.spherical import SphereSL
    from exp_tpu.ic.diskhalo2d import diskhalo2d_ics
    from exp_tpu_torch.convert import (cyl_tables_from_numpy,
                                       sph_tables_from_numpy)

    m = j_hernquist(rmin=1e-3, rmax=20.0)
    ts = build_sph_sl_tables(m, lmax=2, nmax=6, numr=800, cmap=1, rmap=1.0)
    td = build_flatdisk_tables(mmax=2, nmax=8, model="expon", acyl=ACYL,
                               Mtot=MDISK)
    ics = {}
    for hb, db in (("pallas", "pallas"), ("matmul", "xla")):
        halo = SphereSL.from_tables(ts, dtype=jnp.float32, backend=hb)
        disk = CylinderForce.from_tables(td, dtype=jnp.float32, backend=db)
        ics[hb] = diskhalo2d_ics(m, n_halo=N_HALO, n_disk=N_DISK,
                                 Mdisk=MDISK, acyl=ACYL, halo_force=halo,
                                 disk_force=disk, model="expon", Q=0.0,
                                 sig0=0.1, seed=5)
    return (sph_tables_from_numpy(dataclasses.asdict(ts)),
            cyl_tables_from_numpy(dataclasses.asdict(td)), ics)


def test_disk2d_model_and_surface_sample_match_exp_tpu():
    from exp_tpu.basis.flatdisk import surface_density_model as j_sigma
    from exp_tpu.ic import diskhalo2d as jd
    from exp_tpu_torch.basis.flatdisk import surface_density_model
    from exp_tpu_torch.ic import diskhalo2d as td

    mj = jd.add_disk2d_to_model(j_hernquist(rmin=1e-3, rmax=20.0),
                                j_sigma("expon", a=ACYL, M=MDISK), 10 * ACYL)
    mt = td.add_disk2d_to_model(hernquist_model(rmin=1e-3, rmax=20.0),
                                surface_density_model("expon", a=ACYL,
                                                      M=MDISK), 10 * ACYL)
    for k in ("r", "rho", "mass", "pot"):
        np.testing.assert_array_equal(getattr(mt, k), getattr(mj, k))
    for u, w in zip(td.sample_surface_density(
            surface_density_model("zang", a=1.0), 5000, 40.0, seed=2),
            jd.sample_surface_density(j_sigma("zang", a=1.0), 5000, 40.0,
                                      seed=2)):
        np.testing.assert_array_equal(u, w)


@pytest.mark.parametrize("backends", [("pallas", "pallas"),
                                      ("matmul", "xla")],
                         ids=["pallas", "matmul-xla"])
def test_diskhalo2d_ics_match_exp_tpu(bases2d, backends):
    """The whole initial2d pipeline with the same seed through the port's
    forces on the carried tables, against exp_tpu's through the same
    backends."""
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.forces.spherical import SphereSL
    from exp_tpu_torch.ic.diskhalo import virial_ratio
    from exp_tpu_torch.ic.diskhalo2d import diskhalo2d_ics

    ts, td, ics = bases2d
    ij = ics[backends[0]]
    halo = SphereSL.from_tables(ts, backend=backends[0], device="cpu")
    disk = CylinderForce.from_tables(td, backend=backends[1], device="cpu")
    it = diskhalo2d_ics(hernquist_model(rmin=1e-3, rmax=20.0),
                        n_halo=N_HALO, n_disk=N_DISK, Mdisk=MDISK, acyl=ACYL,
                        halo_force=halo, disk_force=disk, model="expon",
                        Q=0.0, sig0=0.1, seed=5)
    for k in ("x_halo", "v_halo", "m_halo", "x_disk", "m_disk"):
        np.testing.assert_array_equal(getattr(it, k), getattr(ij, k))
    assert _rel(it.v_disk, ij.v_disk) <= FIELD_TOL
    assert np.all(it.x_disk[:, 2] == 0.0) and np.all(it.v_disk[:, 2] == 0.0)
    assert it.diag["n_oob"] == ij.diag["n_oob"]
    assert it.diag["sigma0"] == pytest.approx(ij.diag["sigma0"],
                                              rel=FIELD_TOL)
    mh = np.maximum(it.m_halo, 0)
    ch = halo.coefficients(torch.tensor(it.x_halo, dtype=torch.float32),
                           torch.tensor(mh, dtype=torch.float32))
    cd = disk.coefficients(torch.tensor(it.x_disk, dtype=torch.float32),
                           torch.tensor(it.m_disk, dtype=torch.float32))
    vr = virial_ratio([(it.x_halo, it.v_halo, it.m_halo),
                       (it.x_disk, it.v_disk, it.m_disk)],
                      [(halo, ch), (disk, cd)])
    assert abs(vr - 1.0) < 0.05, vr


def test_ic_exports():
    """exp_tpu_torch.ic exports exp_tpu.ic's names."""
    import exp_tpu.ic as J
    import exp_tpu_torch.ic as T

    names = [n for n in dir(J) if not n.startswith("_")
             and not isinstance(getattr(J, n), type(J))]
    assert names and all(hasattr(T, n) for n in names), names
