"""The port's disk host builders against exp_tpu's on the same inputs: the EOF
and flatdisk tables, SphericalModelTable.from_density, the disk sampler and
velocities, the particle-conditioned density, the tables carried across,
the HDF5 cache read by the other package, and the coarse-table helpers of
the cylinder kernels (resampling, contractions)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.empcyl import EmpCylTables as JEmpCylTables
from exp_tpu.basis.empcyl import build_empcyl_tables as j_build
from exp_tpu.basis.empcyl import disk_density_from_particles as j_rho_parts
from exp_tpu.basis.flatdisk import build_flatdisk_tables as j_flat
from exp_tpu.basis.flatdisk import surface_density_model as j_sigma
from exp_tpu.basis.model import SphericalModelTable as JModel
from exp_tpu.ic.disk import disk_velocities as j_vel
from exp_tpu.ic.disk import sample_exponential_disk as j_disk
from exp_tpu.ops import pallas_cylinder as pk

from exp_tpu_torch.basis.empcyl import EmpCylTables, build_empcyl_tables
from exp_tpu_torch.basis.empcyl import disk_density_from_particles
from exp_tpu_torch.basis.flatdisk import (build_flatdisk_tables,
                                          surface_density_model)
from exp_tpu_torch.basis.model import SphericalModelTable
from exp_tpu_torch.convert import cyl_tables_from_numpy
from exp_tpu_torch.ic.disk import disk_velocities, sample_exponential_disk
from exp_tpu_torch.ops import cyl_kernels as ck
from exp_tpu_torch.ops.spline import prefilter_x


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


EOF_KW = dict(mmax=4, nmax=8, lmaxfid=24, nmaxfid=16, acyl=0.01, hcyl=0.002,
              numx=128, numy=64, rnum=100, tnum=40, cachename=None)
FLAT_KW = dict(mmax=2, nmax=6, model="kuzmin", acyl=1.0, numx=96, numy=48,
               knots=200, numk=128, cachename=None)
_TABLES = ("pot", "rforce", "zforce", "dens")
_META = ("mmax", "nmax", "numx", "numy", "acyl", "hcyl", "rcylmin",
         "rcylmax", "xmin", "xmax", "dx", "ymin", "ymax", "dy")


@pytest.fixture(scope="module")
def eof():
    return j_build(**EOF_KW), build_empcyl_tables(**EOF_KW)


def _assert_tables_close(jt, pt, tol):
    assert pt.key == jt.key
    for k in _META:
        assert getattr(pt, k) == pytest.approx(getattr(jt, k), rel=1e-15), k
    np.testing.assert_array_equal(pt.even_count, jt.even_count)
    for k in _TABLES:
        a, b = getattr(jt, k), getattr(pt, k)
        assert np.abs(a - b).max() / np.abs(a).max() <= tol, k


def test_eof_tables_equal_to_roundoff(eof):
    """The same f64 build (the port's own fiducial SL basis): measured max
    relative difference 3.5e-13 (rforce; the eigensolvers' rounding);
    gated at 1e-11."""
    jt, pt = eof
    _assert_tables_close(jt, pt, 1e-11)


def test_flatdisk_tables_equal_to_roundoff():
    """Measured bit-identical on this machine; gated at 1e-12."""
    _assert_tables_close(j_flat(**FLAT_KW), build_flatdisk_tables(**FLAT_KW),
                         1e-12)


@pytest.mark.parametrize("name", ["kuzmin", "expon", "mestel", "zang"])
def test_surface_density_models(name):
    R = np.geomspace(1e-3, 30.0, 50)
    np.testing.assert_array_equal(surface_density_model(name, a=0.7)(R),
                                  j_sigma(name, a=0.7)(R))


def test_from_density_matches():
    def rho(r):
        return 3.0 / (4.0 * np.pi) * (1.0 + r * r) ** -2.5      # Plummer

    a = SphericalModelTable.from_density(rho, 1e-3, 30.0, numr=500)
    b = JModel.from_density(rho, 1e-3, 30.0, numr=500)
    for k in ("r", "rho", "mass", "pot"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    r = np.geomspace(2e-3, 40.0, 37)
    np.testing.assert_array_equal(a.get_pot(r), b.get_pot(r))


def test_disk_sample_same_seed():
    """Host NumPy on both sides from one seed: identical samples, for the
    bench's velocities (0.3 max vc rule) and the Toomre-Q branch."""
    x, m = sample_exponential_disk(3000, mass=0.05, seed=2)
    xj, mj = j_disk(3000, mass=0.05, seed=2)
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(m, mj)

    def vc(R):
        return np.sqrt(0.05 * R * R / (R * R + 0.01 ** 2) ** 1.5)

    np.testing.assert_array_equal(disk_velocities(x, vc, acyl=0.01),
                                  j_vel(xj, vc, acyl=0.01))
    np.testing.assert_array_equal(
        disk_velocities(x, vc, acyl=0.01, Mdisk=0.05, hcyl=0.002, seed=4),
        j_vel(xj, vc, acyl=0.01, Mdisk=0.05, hcyl=0.002, seed=4))


def test_density_from_particles_same_callable():
    x, m = j_disk(4000, seed=5)
    R = np.geomspace(1e-4, 0.1, 20)[:, None]
    z = np.linspace(-0.01, 0.01, 9)[None, :]
    np.testing.assert_array_equal(
        disk_density_from_particles(x, m, smooth=3)(R, z),
        j_rho_parts(x, m, smooth=3)(R, z))


def test_tables_carried_across_and_cache_interop(eof, tmp_path):
    """cyl_tables_from_numpy copies the JAX tables exactly; each package
    reads the other's HDF5 cache."""
    jt, pt = eof
    ct = cyl_tables_from_numpy(dataclasses.asdict(jt))
    _assert_tables_close(jt, ct, 0.0)
    with pytest.raises(ValueError, match="unknown"):
        cyl_tables_from_numpy({**dataclasses.asdict(jt), "bogus": 1})
    pt.write_cache(tmp_path / "port.h5")
    jt.write_cache(str(tmp_path / "jax.h5"))
    _assert_tables_close(pt, JEmpCylTables.read_cache(tmp_path / "port.h5"),
                         0.0)
    _assert_tables_close(jt, EmpCylTables.read_cache(tmp_path / "jax.h5"),
                         0.0)


def test_coarse_helpers_and_contractions(eof):
    """resample/prefilter/dxc are exact copies; the two contractions (the
    port's layouts, reordered to the JAX ones) agree to f32 rounding:
    measured max relative 1e-7; gated at 1e-6."""
    jt, _ = eof
    for interp in ("spline", "linear"):
        cs = []
        for tab in (jt.pot, jt.rforce, jt.zforce):
            c = ck.resample_coarse_x(tab, jt.numx, 32)
            np.testing.assert_array_equal(c, pk.resample_coarse_x(tab,
                                                                  jt.numx, 32))
            if interp == "spline":
                np.testing.assert_array_equal(prefilter_x(c),
                                              pk.prefilter_x(c))
                c = prefilter_x(c)
            cs.append(c)
        assert ck.coarse_dxc(jt.numx, 32, jt.dx) == pk.coarse_dxc(jt.numx, 32,
                                                                  jt.dx)
        xrows, ncy, M1 = cs[0].shape[0], jt.numy, jt.mmax + 1
        rng = np.random.default_rng(1)
        coef = rng.normal(size=(2, M1, jt.nmax)).astype(np.float32)
        tab3 = ck.coarse_table_stack(*cs, device="cpu")
        Ct = ck.contract_coef_tables(torch.from_numpy(coef), tab3, xrows, ncy)
        Cj = np.asarray(pk.contract_coef_tables(jnp.asarray(coef), *cs))
        Sp = Cj.shape[0] // xrows
        Cj = Cj.reshape(xrows, Sp, -1)[:, :6 * M1, :ncy].transpose(0, 2, 1)
        assert Ct.shape == (xrows, ncy, ck.table_row_width(jt.mmax))
        cols = ck.table_columns(jt.mmax)
        assert np.abs(Ct[..., cols].numpy() - Cj).max() \
            <= 1e-6 * np.abs(Cj).max()
        pad = np.setdiff1d(np.arange(Ct.shape[-1]), cols)
        assert len(pad) == Ct.shape[-1] - 6 * M1
        assert Ct[..., pad].abs().max().item() == 0.0
        G = rng.normal(size=(xrows, 2 * M1, ncy)).astype(np.float32)
        Gj = np.zeros((xrows, 16, ncy), np.float32)
        Gj[:, :2 * M1] = G
        bj = np.asarray(pk.contract_coef_output(jnp.asarray(Gj), cs[0]))
        bp = ck.contract_coef_output(torch.from_numpy(G), tab3).numpy()
        assert np.abs(bp - bj).max() <= 1e-6 * np.abs(bj).max()
