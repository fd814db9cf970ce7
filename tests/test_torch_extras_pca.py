"""The port's Hall/PCA smoothing (nbody/pca.py), coefficient playback
(analysis/coefs.py) and NOISE (nbody/noise.py) against exp_tpu's: the
flows of tests/test_pca_playback.py and tests/test_noise.py on the same
inputs, made from a seed with NumPy, and in both drivers on the same YAML.

Tolerances: subsample coefficients and Hall weights of an f64 projection
to F64 = 1e-10 relative (floor 1e-10 of the largest value); the pcaeof
matrix, an eigendecomposition in NumPy f64 of the same covariance, to
1e-8; the moment tables and draws of NOISE bit for bit (the same NumPy
code and generator); driver runs in f64 to F64, OUTLOG to TEXT8.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

import jax.numpy as jnp
from exp_tpu.basis.model import hernquist_model
from exp_tpu.basis.slgrid import build_sph_sl_tables
from exp_tpu.forces.spherical import SphereSL as JSphereSL
from exp_tpu.ic.eddington import sample_spherical_model
from exp_tpu.nbody import pca as JP
from exp_tpu.nbody.particles import write_ascii_bodies
from exp_tpu.nbody.simulation import Simulation as JSim
from exp_tpu_torch.convert import sph_tables_from_numpy
from exp_tpu_torch.forces.spherical import SphereSL
from exp_tpu_torch.nbody import pca as TP
from exp_tpu_torch.nbody.simulation import Simulation as TSim
from test_torch_simulation import F64, TEXT8, close, configs, table


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


F64T = torch.float64


@pytest.fixture(scope="module")
def setup():
    m = hernquist_model(rmin=1e-4, rmax=20.0, numr=800)
    t = build_sph_sl_tables(m, lmax=2, nmax=8, numr=800, cmap=1, rmap=1.0)
    jf = JSphereSL.from_tables(t, dtype=jnp.float64)
    tf = SphereSL.from_tables(sph_tables_from_numpy(dataclasses.asdict(t)),
                              dtype=F64T, device="cpu")
    x, v, mass = sample_spherical_model(m, 5000, seed=21)
    cj = np.asarray(JP.subsample_coefficients(
        jf, jnp.asarray(x), jnp.asarray(mass), nsamples=8,
        accum_dtype=jnp.float64))
    ct = TP.subsample_coefficients(tf, torch.as_tensor(x),
                                   torch.as_tensor(mass), nsamples=8,
                                   accum_dtype=F64T)
    return m, tf, x, v, mass, ct, cj


def test_hall_smoothing(setup):
    """test_pca_playback.py:24 — subsamples, Hall factors and the legacy
    smoothing equal exp_tpu's (F64); the monopole keeps b ~ 1, noise
    channels are suppressed."""
    m, force, x, v, mass, ct, cj = setup
    assert ct.shape[0] == 8
    close(ct.numpy(), cj, F64)
    full = force.coefficients(torch.as_tensor(x), torch.as_tensor(mass),
                              accum_dtype=F64T)
    np.testing.assert_allclose(ct.mean(dim=0).numpy(), full.numpy(),
                               rtol=1e-10, atol=1e-12)
    b, mean, var = TP.hall_factors(ct)
    bj, mj, vj = JP.hall_factors(jnp.asarray(cj))
    for u, w in ((b, bj), (mean, mj), (var, vj)):
        close(u.numpy(), np.asarray(w), F64)
    b = b.numpy()
    assert b[0, 0, 0, 0] > 0.99
    assert b[0, 2, 1, 5] < 0.9
    assert np.median(b[:, 1:, :, :][b[:, 1:, :, :] > 0]) < 0.9
    sm = TP.smooth_coefficients(full, torch.as_tensor(b), "Hall")
    assert float(sm[0, 0, 0, 0].abs()) > 0.99 * float(full[0, 0, 0, 0].abs())
    cut = TP.smooth_coefficients(full, torch.as_tensor(b), "VarianceCut")
    assert float(cut.abs().sum()) < float(full.abs().sum())
    np.testing.assert_array_equal(cut.numpy(), np.asarray(
        JP.smooth_coefficients(jnp.asarray(full.numpy()), jnp.asarray(b),
                               "VarianceCut")))


def test_smoothing_weight_variants():
    """test_pca_playback.py:153 — every tk_type policy, equal to
    exp_tpu's."""
    mean = np.asarray([[10.0, 1.0, 0.01, 0.001]])
    var = np.asarray([[0.01, 0.01, 0.01, 0.01]])
    out = {}
    for kind in ("Hall", "VarianceCut", "CumulativeCut", "VarianceWeighted",
                 "None"):
        w = TP.smoothing_weights(torch.as_tensor(mean), torch.as_tensor(var),
                                 kind, tksmooth=3.0, tkcum=0.95).numpy()
        np.testing.assert_array_equal(w, np.asarray(JP.smoothing_weights(
            jnp.asarray(mean), jnp.asarray(var), kind, tksmooth=3.0,
            tkcum=0.95)))
        out[kind] = w
    assert out["Hall"][0, 0] > 0.999 and out["Hall"][0, 2] < 0.01
    np.testing.assert_array_equal(out["VarianceCut"][0], [1, 1, 0, 0])
    assert out["CumulativeCut"][0, 0] == 1 and out["CumulativeCut"][0, 3] == 0
    assert out["VarianceWeighted"][0, 2] < 0.01
    np.testing.assert_array_equal(out["None"], np.ones_like(mean))


def test_pcaeof_matrix(setup):
    """test_pca_playback.py:214 — the eigenbasis smoothing matrix equals
    exp_tpu's (1e-8), shrinks the noisy l = 2 power, reduces to Hall for a
    diagonal covariance; apply_hall dispatches on shape."""
    m, force, x, v, mass, ct, cj = setup
    S = TP.eof_smoothing_matrix(ct)
    np.testing.assert_allclose(S, JP.eof_smoothing_matrix(cj), rtol=1e-8,
                               atol=1e-12)
    mean = cj.mean(axis=0)
    sm = np.einsum("...nm,...m->...n", S, mean)
    assert abs(sm[0, 0, 0, 0] / mean[0, 0, 0, 0] - 1) < 0.05
    assert np.sum(sm[:, 2] ** 2) < np.sum(mean[:, 2] ** 2)
    rng = np.random.default_rng(0)
    sub = np.array([10.0, 1.0, 0.1, 0.01])[None, :] + rng.normal(0, 0.05,
                                                                 (64, 4))
    Sd = TP.eof_smoothing_matrix(sub)
    md = sub.mean(axis=0)
    wd = TP.smoothing_weights(torch.as_tensor(md), torch.as_tensor(
        sub.var(axis=0, ddof=1) / 64)).numpy()
    np.testing.assert_allclose(Sd @ md, wd * md, rtol=0.3, atol=1e-4)
    np.testing.assert_allclose(
        TP.apply_hall(torch.as_tensor(md), torch.as_tensor(Sd)).numpy(),
        Sd @ md, rtol=1e-12)
    np.testing.assert_allclose(
        TP.apply_hall(torch.as_tensor(md), torch.as_tensor(wd)).numpy(),
        wd * md, rtol=1e-12)


@pytest.fixture(scope="module")
def rundir(tmp_path_factory, setup):
    m, force, x, v, mass, _, _ = setup
    d = tmp_path_factory.mktemp("pcarun")
    m.to_file(d / "h.model")
    write_ascii_bodies(d / "h.bods", (x[:2000], v[:2000], mass[:2000]))
    return d


DRIVER = """\
Global:
  dtime: 0.02
  nsteps: 4
  runtag: pc
  compute_dtype: float64
Components:
  - name: halo
    bodyfile: h.bods
    parameters: {PARAMS}
    force:
      id: sphereSL
      parameters: {numr: 800, Lmax: 2, nmax: 8, rmapping: 1.0,
                   modelname: h.model}
Output:
  - id: outlog
    parameters: {nint: 1}
"""


def _both(rundir, tag, params, multistep=0, prime=True, spb=None):
    txt = DRIVER.replace("{PARAMS}", params)
    if multistep:
        # every particle pinned to level 0: all dt criteria >> dtime
        txt = txt.replace("compute_dtype: float64", "compute_dtype: float64"
                          f"\n  multistep: {multistep}\n  dynfracV: 1.0e30"
                          "\n  dynfracA: 1.0e30\n  dynfracP: 1.0e30")
    pj, pt = configs(rundir, tag, txt)
    sj = JSim.from_file(pj, steps_per_block=spb)
    st = TSim.from_file(pt, device="cpu", steps_per_block=spb)
    for s in (sj, st):
        if prime:
            s.prime()
        s.run()
    return sj, st


def _state(sim):
    ps = sim._state["halo"]
    m = np.asarray(ps.mass)
    o = np.argsort(np.asarray(ps.indx)[m > 0])
    return np.asarray(ps.x)[m > 0][o], np.asarray(ps.v)[m > 0][o]


def _agree(rundir, tag, sj, st):
    for a, b in zip(_state(st), _state(sj)):
        close(a, b, F64)
    close(table(rundir / f"t_{tag}" / "OUTLOG.pc"),
          table(rundir / f"j_{tag}" / "OUTLOG.pc"), TEXT8, atol=1e-14)


@pytest.mark.parametrize("case", [
    "hall", "hall_outsamp", "tk_type", "pcaeof", "hall_multistep"])
def test_hall_in_driver(rundir, case):
    """test_pca_playback.py:116, :182, :253 — npca smoothing in both
    drivers: the weights (F64) and the run (F64, TEXT8) equal exp_tpu's;
    Hall keeps the monopole, VarianceCut cuts to {0, 1}, pcaeof gives
    (n, n) matrices (their eigenbasis weights to 1e-8: eigenvectors of
    near-degenerate covariances).  Under multistep every particle is
    pinned to level 0
    (the round-robin subsamples count rows, and exp_tpu pads its empty
    level buckets to its 8-device mesh, the port to one row)."""
    params = {"hall": "{npca: 2, nsamples: 8}",
              "hall_outsamp": "{npca: 2, nsamples: 8}",
              "tk_type": "{npca: 2, nsamples: 4, tk_type: VarianceCut, "
                         "tksmooth: 3.0}",
              "pcaeof": "{npca: 2, nsamples: 4, pcaeof: true}",
              "hall_multistep": "{npca: 1, nsamples: 8}"}[case]
    ms = 2 if case == "hall_multistep" else 0
    sj, st = _both(rundir, f"h_{case}", params, multistep=ms,
                   prime=not ms, spb=None if ms else 2)
    _agree(rundir, f"h_{case}", sj, st)
    w, wj = st._hall["halo"].numpy(), np.asarray(sj._hall["halo"])
    assert w.shape == wj.shape
    # pcaeof: eigenvectors of near-degenerate covariances, 1e-8
    close(w, wj, 1e-8 if case == "pcaeof" else F64, floor=1e-10)
    if case in ("hall", "hall_multistep"):
        assert w[0, 0, 0, 0] > 0.95
    if case == "tk_type":
        assert set(np.unique(w)).issubset({0.0, 1.0})
        assert w.max() == 1.0 and w.min() == 0.0
    if case == "pcaeof":
        assert w.ndim == 5 and w.shape[-1] == w.shape[-2] == 8
    assert st.timers["Hall"] > 0.0


def test_playback_driver(rundir, setup):
    """test_pca_playback.py:76 — a constant stored series drives the run:
    the coefficients equal the file's, the state exp_tpu's (F64)."""
    from exp_tpu_torch.analysis.coefs import Coefs

    m, force, x, v, mass, _, _ = setup
    full = force.coefficients(torch.as_tensor(x[:2000]),
                              torch.as_tensor(mass[:2000]),
                              accum_dtype=F64T).numpy()
    c = Coefs(geometry="sphere", name="halo", meta={"lmax": 2, "nmax": 8})
    for tt in np.linspace(0, 10, 5):
        c.add(tt, full)
    c.to_file(str(rundir / "pb.h5"))
    from exp_tpu.analysis.coefs import Coefs as JCoefs

    np.testing.assert_array_equal(
        JCoefs.from_file(str(rundir / "pb.h5")).as_array(),
        Coefs.from_file(str(rundir / "pb.h5")).as_array())
    sj, st = _both(rundir, "pb", "{playback: pb.h5}")
    assert st.steps_per_block == 1
    np.testing.assert_allclose(st._coefs["halo"], full, rtol=1e-12)
    _agree(rundir, "pb", sj, st)


def test_multistep_playback_equivalence(rundir):
    """test_simulation.py:600 — a playback-driven multistep run (every
    particle at level 0) equals the playback-driven flat run at the JAX
    test's tolerance, and each equals exp_tpu's (F64); the series is a
    port run's own OutCoef file, one record a step."""
    import os

    src = DRIVER.replace("{PARAMS}", "{}").replace(
        "  - id: outlog\n    parameters: {nint: 1}\n",
        "  - id: outcoef\n    parameters: {nint: 1, name: halo}\n")
    sim0 = TSim.from_file(configs(rundir, "pbsrc", src)[1], device="cpu")
    sim0.run(10)
    os.replace(rundir / "t_pbsrc" / "outcoef.halo.pc.h5", rundir / "pbs.h5")
    pin = ("  dynfracV: 1.0e30\n  dynfracA: 1.0e30\n  dynfracP: 1.0e30\n")
    runs = {}
    for ms in (0, 2):
        txt = DRIVER.replace("{PARAMS}", "{playback: pbs.h5}")
        if ms:
            txt = txt.replace("compute_dtype: float64",
                              f"compute_dtype: float64\n  multistep: {ms}\n"
                              + pin.rstrip("\n"))
        pj, pt = configs(rundir, f"pbe{ms}", txt)
        sj, st = JSim.from_file(pj), TSim.from_file(pt, device="cpu")
        for s in (sj, st):
            if not ms:
                s.prime()
            s.run(5)
        for a, b in zip(_state(st), _state(sj)):
            close(a, b, F64)
        runs[ms] = _state(st)
    np.testing.assert_allclose(runs[2][0], runs[0][0], rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(runs[2][1], runs[0][1], rtol=1e-6, atol=1e-10)


@pytest.fixture(scope="module")
def noise_force():
    from exp_tpu.basis.slgrid import build_sph_sl_tables as jt

    m = hernquist_model(rmin=1e-3, rmax=20.0)
    t = jt(m, lmax=2, nmax=6, numr=400)
    return (JSphereSL.from_tables(t),
            SphereSL.from_tables(sph_tables_from_numpy(dataclasses.asdict(t)),
                                 device="cpu"), m)


def test_noise_moment_tables(noise_force):
    """test_noise.py:18 — the moment tables equal exp_tpu's from the same
    float32 radial tables (1e-12; the quadrature is the same NumPy code)
    and an independent trapezoid integration (2e-3)."""
    from exp_tpu.nbody.noise import SphereNoise as JN
    from exp_tpu_torch.nbody.noise import SphereNoise as TN

    jf, tf, model = noise_force
    nz = TN.build(tf, model, noiseN=1e-4, seedN=3, numg=4000)
    nj = JN.build(jf, model, noiseN=1e-4, seedN=3, numg=4000)
    np.testing.assert_allclose(nz.meanC, nj.meanC, rtol=1e-12)
    np.testing.assert_allclose(nz.rmsC, nj.rmsC, rtol=1e-12)
    np.testing.assert_allclose(nz.std, nj.std, rtol=1e-12)
    r = np.linspace(model.rmin, model.rmax, 20001)
    u = tf.grid.get_pot(torch.as_tensor(r / tf.scale)).numpy()
    rho = np.asarray([model.get_density(ri) for ri in r])
    w = 4.0 * np.pi * r * r * rho
    meanC = np.trapezoid(w * u[:, 0, :].T / tf.scale, r, axis=1)
    np.testing.assert_allclose(nz.meanC, meanC, rtol=2e-3, atol=1e-6)


def test_noise_draw_statistics(noise_force):
    """test_noise.py:42 — structural zeros, the prescribed spread, and the
    same draws as exp_tpu's for the same seed, bit for bit."""
    from exp_tpu.nbody.noise import SphereNoise as JN
    from exp_tpu_torch.nbody.noise import SphereNoise as TN

    jf, tf, model = noise_force
    nz = TN.build(tf, model, noiseN=1e-4, seedN=3)
    nj = JN.build(jf, model, noiseN=1e-4, seedN=3)
    assert nz.std.shape == (2, 3, 3, 6)
    assert np.all(nz.std[1, :, 0, :] == 0) and np.all(nz.std[:, 1, 2, :] == 0)
    draws = np.stack([nz.interpolate(0.0) for _ in range(4000)])
    jdraws = np.stack([nj.interpolate(0.0) for _ in range(4000)])
    np.testing.assert_array_equal(draws, jdraws)
    live = nz.std > 0
    np.testing.assert_allclose(draws.std(axis=0)[live], nz.std[live],
                               rtol=0.12)


def test_noise_run_end_to_end(rundir):
    """test_noise.py:65 — a single-rate NOISE run integrates against one
    draw a step.  exp_tpu's driver discards one draw when it compiles its
    step function (Simulation._make_step_fn builds its specs from a
    _make_extras() call), so its steps from the second on use the stream
    one draw later; the port uses draw k at step k.  The prime and the
    first step equal exp_tpu's (F64); the port's last coefficients are
    the stream's fifth draw, exp_tpu's its sixth."""
    from exp_tpu_torch.nbody.noise import SphereNoise

    txt = DRIVER.replace("{PARAMS}", "{}").replace(
        "modelname: h.model}",
        "modelname: h.model,\n                   NOISE: true, "
        "noiseN: 2000.0, seedN: 7}")
    pj, pt = configs(rundir, "noise", txt)
    sj, st = JSim.from_file(pj), TSim.from_file(pt, device="cpu")
    assert isinstance(st.components["halo"].playback, SphereNoise)
    for s in (sj, st):
        s.prime()
        s.run(1)
    for a, b in zip(_state(st), _state(sj)):
        close(a, b, F64)
    for s in (sj, st):
        s.run(3)
    ref = SphereNoise(st.components["halo"].playback.std,
                      st.components["halo"].playback.mean, seedN=7)
    draws = [ref.interpolate(0.0) for _ in range(6)]
    np.testing.assert_array_equal(st._coefs["halo"],
                                  draws[4].astype(np.float64))
    np.testing.assert_array_equal(np.asarray(sj._coefs["halo"]),
                                  draws[5].astype(np.float64))
    assert np.isfinite(_state(st)[0]).all()
