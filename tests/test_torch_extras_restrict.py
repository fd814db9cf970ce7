"""The port's harmonic restrictions (SphericalBasis.cc:33-39, 1568-1600,
1689-1694; PolarBasis.cc:36-45) against exp_tpu's: the flows of
tests/test_restrict.py, both drivers on the same YAML and body files in
f64, the coefficient files to F64 = 1e-10 relative (floor 1e-10 of the
largest value), the restricted channels exactly 0 and the FIX_L0 monopole
constant bit for bit, as exp_tpu's own test holds them.
"""


import jax
import numpy as np
import pytest
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.model import hernquist_model
from exp_tpu.ic.eddington import sample_spherical_model
from exp_tpu.nbody.particles import write_ascii_bodies
from exp_tpu.nbody.simulation import Simulation as JSim
from exp_tpu_torch.analysis.coefs import Coefs
from exp_tpu_torch.nbody.simulation import Simulation as TSim
from test_torch_simulation import F64, close, configs
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


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    d = tmp_path_factory.mktemp("restrict")
    m = hernquist_model(rmin=1e-3, rmax=20.0)
    x, v, mass = sample_spherical_model(m, 600, seed=9)
    write_ascii_bodies(d / "h.bods", (x, v, mass))
    return d


def _run(rundir, tag, force_extra, nsteps=4, multistep=0):
    """Both drivers; the port's coefficient series (T, 2, 3, 3, 4) after
    holding it to exp_tpu's, and the port's Simulation."""
    extra = "".join(f", {k}: {v}" for k, v in force_extra.items())
    txt = f"""\
Global:
  dtime: 0.01
  nsteps: {nsteps}
  runtag: rtest
  compute_dtype: float64
  multistep: {multistep}
Components:
  - name: halo
    bodyfile: h.bods
    force:
      id: sphereSL
      parameters: {{lmax: 2, nmax: 4, modelname: hernquist{extra}}}
Output:
  - id: outcoef
    parameters: {{nint: 1}}
"""
    pj, pt = configs(rundir, tag, txt)
    sj, st = JSim.from_file(pj), TSim.from_file(pt, device="cpu")
    for s in (sj, st):
        s.run()
    name = "outcoef.halo.rtest.h5"
    A = Coefs.from_file(str(rundir / f"t_{tag}" / name)).as_array()
    close(A, Coefs.from_file(str(rundir / f"j_{tag}" / name)).as_array(),
          F64)
    return np.asarray(A, np.float64), st


def test_m0_only(rundir):
    A, _ = _run(rundir, "m0", {"M0_ONLY": "true"})
    assert np.isfinite(A).all()
    assert np.abs(A[..., :, 1:, :]).max() == 0.0
    assert np.abs(A[..., 0, 0, 0, :]).max() > 0.0


def test_even_l_and_no_l1(rundir):
    A, _ = _run(rundir, "evl", {"EVEN_L": "true"})
    assert np.abs(A[:, :, 1, :, :]).max() == 0.0
    assert np.abs(A[:, :, 2, :, :]).max() > 0.0
    B, _ = _run(rundir, "nol1", {"NO_L1": "true"})
    assert np.abs(B[:, :, 1, :, :]).max() == 0.0
    assert np.abs(B[:, :, 0, :, :]).max() > 0.0
    assert np.abs(B[:, :, 2, :, :]).max() > 0.0


def test_no_l0_matches_unrestricted_above_monopole(rundir):
    A, _ = _run(rundir, "nol0", {"NO_L0": "true"}, nsteps=1)
    B, _ = _run(rundir, "free", {}, nsteps=1)
    assert np.abs(A[0, :, 0, :, :]).max() == 0.0
    np.testing.assert_allclose(A[0, :, 1:, :, :], B[0, :, 1:, :, :],
                               rtol=1e-6, atol=1e-9)


def test_fix_l0_freezes_monopole(rundir):
    A, sim = _run(rundir, "fix", {"FIX_L0": "true"}, nsteps=5)
    mono = A[:, 0, 0, 0, :]
    np.testing.assert_array_equal(mono, np.broadcast_to(mono[0], mono.shape))
    assert np.abs(A[-1, :, 2, :, :] - A[0, :, 2, :, :]).max() > 0.0
    assert sim._restrict["halo"]["c0"] is not None


def test_m0_only_multistep(rundir):
    A, _ = _run(rundir, "m0ms", {"M0_ONLY": "true"}, nsteps=2, multistep=1)
    assert np.isfinite(A).all()
    assert np.abs(A[..., :, 1:, :]).max() == 0.0
    assert np.abs(A[..., 0, 0, 0, :]).max() > 0.0


def test_flatdisk_mlim_even_m(rundir):
    """The polar knobs on a flatdisk run: mlim truncates m, EVEN_M
    suppresses odd m; the series equals exp_tpu's (F64)."""
    rng = np.random.default_rng(1)
    n = 1500
    R = -0.5 * (np.log(rng.uniform(size=n)) + np.log(rng.uniform(size=n)))
    ph = rng.uniform(0, 2 * np.pi, n)
    x = np.stack([R * np.cos(ph), R * np.sin(ph), np.zeros(n)], -1)
    vc = np.sqrt(np.clip(R, 0.05, None)) * 0.5
    v = np.stack([-vc * np.sin(ph), vc * np.cos(ph), np.zeros(n)], -1)
    write_ascii_bodies(rundir / "d.bods", (x, v, np.full(n, 1.0 / n)))
    txt = """\
Global:
  dtime: 0.01
  nsteps: 2
  runtag: fdr
  compute_dtype: float64
Components:
  - name: disk
    bodyfile: d.bods
    force:
      id: flatdisk
      parameters: {mmax: 3, nmax: 4, acyl: 0.5, rcylmax: 20.0,
                   numx: 128, numy: 64, knots: 200, numk: 128,
                   EVEN_M: true, mlim: 2}
Output:
  - id: outcoef
    parameters: {nint: 1}
"""
    pj, pt = configs(rundir, "fd", txt)
    sj, st = JSim.from_file(pj), TSim.from_file(pt, device="cpu")
    for s in (sj, st):
        s.prime()
        s.run()
    name = "outcoef.disk.fdr.h5"
    A = np.asarray(Coefs.from_file(str(rundir / "t_fd" / name)).as_array())
    close(A, Coefs.from_file(str(rundir / "j_fd" / name)).as_array(), F64)
    assert np.isfinite(A).all()
    assert np.abs(A[..., 1, :]).max() == 0.0
    assert np.abs(A[..., 3, :]).max() == 0.0
    assert np.abs(A[..., 0, :]).max() > 0.0
    assert np.abs(A[..., 2, :]).max() > 0.0
