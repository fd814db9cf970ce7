"""The port's DiskHalo initial conditions (exp_tpu_torch/ic/diskhalo.py) and
`add_disk_to_model` against exp_tpu's, on tests/test_diskhalo.py's bases
(Hernquist lmax 2, nmax 6; EOF mmax 2, nmax 6, lmaxfid 16, nmaxfid 12),
built once by the JAX package and carried across; then the virial and
level-stability gates of the composite through the port's multistep
runner, with the pallas backends (plain versions on the CPU) and with the
gather/xla backends."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.empcyl import build_empcyl_tables
from exp_tpu.basis.model import add_disk_to_model as j_add_disk
from exp_tpu.basis.model import hernquist_model as j_hernquist
from exp_tpu.basis.slgrid import build_sph_sl_tables
from exp_tpu.forces.cylinder import CylinderForce as JCylinderForce
from exp_tpu.forces.spherical import SphereSL as JSphereSL
from exp_tpu.ic import diskhalo as jd
from exp_tpu.ic.disk import sample_exponential_disk

from exp_tpu_torch.basis.model import add_disk_to_model, hernquist_model
from exp_tpu_torch.convert import cyl_tables_from_numpy, sph_tables_from_numpy
from exp_tpu_torch.forces.cylinder import CylinderForce
from exp_tpu_torch.forces.spherical import SphereSL
from exp_tpu_torch.ic import diskhalo as pd
from exp_tpu_torch.nbody.multistep import MultistepRunner
from exp_tpu_torch.nbody.particles import ParticleSystem


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


ACYL, HCYL, MDISK = 0.01, 0.002, 0.05
N_HALO, N_DISK = 8192, 4096
# The port's and the JAX package's f32 fields differ by the order of their
# f32 sums: measured max|d|/max|value| 1.8e-6 over the Jeans tables and
# 8.6e-7 of max|v| over the disk velocities drawn from them (the same
# random draws); gated at 1e-5 of each largest value.
FIELD_TOL = 1e-5


@pytest.fixture(scope="module")
def bases():
    m = j_hernquist(rmin=1e-3, rmax=20.0)
    ts = build_sph_sl_tables(m, lmax=2, nmax=6, numr=800, cmap=1, rmap=1.0)
    tc = build_empcyl_tables(mmax=2, nmax=6, lmaxfid=16, nmaxfid=12,
                             acyl=ACYL, hcyl=HCYL)
    return (m, JSphereSL.from_tables(ts, dtype=jnp.float32),
            JCylinderForce.from_tables(tc, dtype=jnp.float32),
            sph_tables_from_numpy(dataclasses.asdict(ts)),
            cyl_tables_from_numpy(dataclasses.asdict(tc)))


def _port_forces(bases, halo_backend="matmul", disk_backend="xla"):
    """The port's forces on the carried tables; 'matmul' and 'xla' are the
    JAX forces' defaults."""
    _, _, _, ts, tc = bases
    return (SphereSL.from_tables(ts, backend=halo_backend, device="cpu"),
            CylinderForce.from_tables(tc, backend=disk_backend, device="cpu"))


@pytest.fixture(scope="module")
def jax_ics(bases):
    m, hj, dj, _, _ = bases
    return jd.diskhalo_ics(m, n_halo=N_HALO, n_disk=N_DISK, Mdisk=MDISK,
                           acyl=ACYL, hcyl=HCYL, halo_force=hj,
                           disk_force=dj, seed=5)


def test_add_disk_to_model_matches_jax():
    mj = j_add_disk(j_hernquist(rmin=1e-3, rmax=20.0), MDISK, ACYL)
    mp = add_disk_to_model(hernquist_model(rmin=1e-3, rmax=20.0), MDISK, ACYL)
    for k in ("r", "rho", "mass", "pot"):
        a, b = getattr(mp, k), getattr(mj, k)
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), k
    r = np.geomspace(1e-3, 30.0, 50)
    np.testing.assert_allclose(mp.get_dpot(r), mj.get_dpot(r), rtol=1e-12)
    assert mp.comment == mj.comment


def _close(a, b, what, tol=FIELD_TOL):
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= tol, f"{what}: {err:.3e}"


def test_disk_tables_and_velocities_match_jax(bases):
    """build_disk_tables and set_vel_disk on the same positions and the same
    (JAX) coefficients, Q > 0 and the monopole floor as in
    tests/test_diskhalo.py:173-200."""
    m, hj, dj, _, _ = bases
    hp, dp = _port_forces(bases)
    comp = j_add_disk(m, MDISK, ACYL)
    xh, _, mh = jd.sample_spherical_model(comp, 4096, seed=8,
                                          tracer_only=True, zero_com=False)
    xd, md = sample_exponential_disk(2048, acyl=ACYL, hcyl=HCYL, mass=MDISK,
                                     seed=9)
    ch = hj.coefficients(jnp.asarray(xh, jnp.float32),
                         jnp.asarray(mh, jnp.float32))
    cd = dj.coefficients(jnp.asarray(xd, jnp.float32),
                         jnp.asarray(md, jnp.float32))
    kw = dict(Mdisk=MDISK, acyl=ACYL, hcyl=HCYL, ndp=4, ndr=24, ndz=32)
    for extra in ({"Q": 1.2, "dphidr_floor": comp.get_dpot}, {}):
        tj = jd.build_disk_tables(hj, ch, dj, cd, **kw, **extra)
        tp = pd.build_disk_tables(hp, torch.tensor(np.asarray(ch)), dp,
                                  torch.tensor(np.asarray(cd)), **kw, **extra)
        for f in ("sigz2P", "sigz2N", "kappa2", "omega2", "vc", "sigR2"):
            _close(getattr(tp, f), getattr(tj, f), f)
        assert tp.sigma0 == pytest.approx(tj.sigma0, rel=FIELD_TOL)
        vj, dgj = jd.set_vel_disk(xd, tj, acyl=ACYL, seed=3)
        vp, dgp = pd.set_vel_disk(xd, tp, acyl=ACYL, seed=3)
        _close(vp, vj, "disk velocities")
        assert dgp["n_oob"] == dgj["n_oob"]


def test_diskhalo_ics_match_jax(bases, jax_ics):
    """The whole pipeline with the same seed: positions, masses and halo
    velocities equal (NumPy on both sides), disk velocities within
    FIELD_TOL (drawn from Jeans tables of f32 fields)."""
    hp, dp = _port_forces(bases)
    ip = pd.diskhalo_ics(hernquist_model(rmin=1e-3, rmax=20.0), n_halo=N_HALO,
                         n_disk=N_DISK, Mdisk=MDISK, acyl=ACYL, hcyl=HCYL,
                         halo_force=hp, disk_force=dp, seed=5)
    for k in ("x_halo", "v_halo", "m_halo", "x_disk", "m_disk"):
        np.testing.assert_array_equal(getattr(ip, k), getattr(jax_ics, k))
    _close(ip.v_disk, jax_ics.v_disk, "disk velocities")
    assert ip.diag["n_oob"] == jax_ics.diag["n_oob"]
    assert ip.diag["sigma0"] == pytest.approx(jax_ics.diag["sigma0"],
                                              rel=FIELD_TOL)


@pytest.mark.parametrize("backends", [("pallas", "pallas"), ("gather", "xla")],
                         ids=["pallas", "gather-xla"])
def test_virial_and_level_stability(bases, backends):
    """tests/test_diskhalo.py:44-59 and :132-170 through the port: the
    composite within 5% of virial equilibrium (the disk alone within 10%);
    over 4 big steps at M=2 no level's population moves by more than 2% of
    its component, the capacity signature is unchanged, indx stays int32
    and nobody is lost."""
    hp, dp = _port_forces(bases, *backends)
    ics = pd.diskhalo_ics(hernquist_model(rmin=1e-3, rmax=20.0),
                          n_halo=N_HALO, n_disk=N_DISK, Mdisk=MDISK,
                          acyl=ACYL, hcyl=HCYL, halo_force=hp, disk_force=dp,
                          seed=5)
    mh = np.maximum(ics.m_halo, 0)
    ch = hp.coefficients(torch.tensor(ics.x_halo, dtype=torch.float32),
                         torch.tensor(mh, dtype=torch.float32))
    cd = dp.coefficients(torch.tensor(ics.x_disk, dtype=torch.float32),
                         torch.tensor(ics.m_disk, dtype=torch.float32))
    fc = [(hp, ch), (dp, cd)]
    vr = pd.virial_ratio([(ics.x_halo, ics.v_halo, mh),
                          (ics.x_disk, ics.v_disk, ics.m_disk)], fc)
    assert abs(vr - 1.0) < 0.05, vr
    vrd = pd.virial_ratio([(ics.x_disk, ics.v_disk, ics.m_disk)], fc)
    assert abs(vrd - 1.0) < 0.10, vrd

    runner = MultistepRunner({"halo": hp, "disk": dp},
                             {"halo": ["halo", "disk"],
                              "disk": ["halo", "disk"]}, 2e-3, 2,
                             dynparams={"dynfracV": 0.01, "dynfracA": 0.03},
                             cap_headroom=2)
    flat = {"halo": ParticleSystem.from_arrays(ics.x_halo, ics.v_halo, mh,
                                               device="cpu"),
            "disk": ParticleSystem.from_arrays(ics.x_disk, ics.v_disk,
                                               ics.m_disk, device="cpu")}
    st, regs, _, _ = runner.init_state(flat)
    first = runner.level_counts(st)
    sig = runner._caps_sig(st)
    for _ in range(4):
        st, regs, _, _ = runner.bigstep(st, regs)
        st, regs = runner.relevel(st, regs)
    assert runner._caps_sig(st) == sig
    assert all(b.indx.dtype == torch.int32 for bs in st.values() for b in bs)
    last = runner.level_counts(st)
    for comp, n in (("halo", N_HALO), ("disk", N_DISK)):
        a, b = np.array(first[comp], float), np.array(last[comp], float)
        assert b.sum() == a.sum() == int((flat[comp].mass > 0).sum())
        assert np.abs(b - a).max() < 0.02 * n, (comp, first, last)
