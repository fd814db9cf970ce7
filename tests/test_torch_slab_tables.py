"""The port's slab host code against exp_tpu's: build_slab_tables for both
methods ('greens', 'sl') and the three background models, the HDF5 cache
read by either package, convert.slab_tables_from_numpy, and sample_slab
against the file genslab writes for the same seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis import slab as jslab
from exp_tpu.cli.genslab import main as genslab
from exp_tpu.forces.slab import SlabForce as JSlabForce
from exp_tpu.nbody.particles import read_ascii_arrays

from exp_tpu_torch.basis import slab as pslab
from exp_tpu_torch.convert import slab_tables_from_numpy
from exp_tpu_torch.forces.slab import SlabForce
from exp_tpu_torch.ic.slab import sample_slab


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


SMALL = dict(nmaxx=2, nmaxy=3, nmax=4, zmax=0.1, h=0.01, numz=201)
FIELDS = ("phi", "dphi", "dens", "zgrid", "sgn")


@pytest.mark.parametrize("method,type", [("greens", "iso"),
                                         ("greens", "const"),
                                         ("sl", "iso"), ("sl", "para")])
def test_tables_equal_the_jax_tables(method, type):
    """The same arithmetic in the same order: equal bit for bit (measured
    0.0 difference for both methods), with the same cache key."""
    # the 'sl' solve is a dense 1601-point eigenproblem a distinct |k|:
    # nmax 1 x 1 keeps it to three
    kw = SMALL if method == "greens" else {**SMALL, "nmaxx": 1, "nmaxy": 1}
    jt = jslab.build_slab_tables(method=method, type=type, **kw)
    pt = pslab.build_slab_tables(method=method, type=type, **kw)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(pt, k), getattr(jt, k), k)
    assert pt.key == jt.key
    assert (pt.nmaxx, pt.nmaxy, pt.nmax, pt.numz, pt.zmax, pt.h) == \
        (jt.nmaxx, jt.nmaxy, jt.nmax, jt.numz, jt.zmax, jt.h)


def test_slab_density_models():
    z = np.linspace(-0.05, 0.05, 401)
    for ty in ("iso", "const", "para"):
        np.testing.assert_array_equal(pslab.slab_density(ty, 0.01)(z),
                                      jslab.slab_density(ty, 0.01)(z))


def test_cache_is_read_by_either_package(tmp_path):
    """A cache written by one package is read by the other, field for
    field, and a cache with the right key is returned as it is."""
    pytest.importorskip("h5py")
    pt = pslab.build_slab_tables(**SMALL)
    pt.write_cache(str(tmp_path / "p.h5"))
    jr = jslab.SlabTables.read_cache(str(tmp_path / "p.h5"))
    jt = jslab.build_slab_tables(**SMALL)
    jt.write_cache(str(tmp_path / "j.h5"))
    pr = pslab.SlabTables.read_cache(str(tmp_path / "j.h5"))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(jr, k), getattr(pt, k))
        np.testing.assert_array_equal(getattr(pr, k), getattr(jt, k))
    assert pr.key == jt.key and jr.key == pt.key
    again = pslab.build_slab_tables(cachename=str(tmp_path / "j.h5"), **SMALL)
    np.testing.assert_array_equal(again.phi, jt.phi)


def test_carried_tables_build_the_same_force():
    """slab_tables_from_numpy on dataclasses.asdict of the JAX tables gives
    the port's own tables, and SlabForce.from_tables on either gives equal
    buffers, which equal the JAX SlabForce's arrays."""
    jt = jslab.build_slab_tables(**SMALL)
    ct = slab_tables_from_numpy(dataclasses.asdict(jt))
    pt = pslab.build_slab_tables(**SMALL)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ct, k), getattr(pt, k))
    assert ct.key == pt.key
    fc = SlabForce.from_tables(ct, backend="pallas", device="cpu")
    fp = SlabForce.from_tables(pt, backend="pallas", device="cpu")
    for (name, a), (_, b) in zip(fc.named_buffers(), fp.named_buffers()):
        assert torch.equal(a, b), name
    jf = JSlabForce.from_tables(jt, dtype=jnp.float32, backend="pallas")
    for name in ("phi_t", "dphi_t", "dens_t", "sgn", "phi_s", "dphi_s"):
        np.testing.assert_array_equal(getattr(fp, name).numpy(),
                                      np.asarray(getattr(jf, name)), name)
    assert fp.nzc == jf.nzc == 126
    with pytest.raises(ValueError, match="unknown"):
        slab_tables_from_numpy({**dataclasses.asdict(jt), "bogus": 1})
    with pytest.raises(ValueError, match="missing"):
        slab_tables_from_numpy({k: v for k, v in dataclasses.asdict(jt).items()
                                if k != "dphi"})


@pytest.mark.parametrize("kw,args", [
    ({}, []),
    (dict(L=2.0, z0=0.01, mass=3.0, sigmaxy=0.05, seed=4),
     ["--L", "2.0", "--z0", "0.01", "--mass", "3.0", "--sigmaxy", "0.05",
      "-s", "4"])])
def test_sample_slab_is_genslabs_file(tmp_path, kw, args):
    """The same seed gives genslab's arrays, drawn in its order: its
    %.16e file round-trips f64 exactly, so the arrays are equal bit for
    bit (with genslab's defaults and with every argument set)."""
    path = str(tmp_path / "s.bods")
    genslab(["-N", "1501", "-o", path] + args)
    xj, vj, mj = read_ascii_arrays(path)
    x, v, m = sample_slab(1501, **kw)
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(m, mj)
