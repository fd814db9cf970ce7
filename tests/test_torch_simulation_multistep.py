"""The port's YAML driver under `Global.multistep` against exp_tpu's, on the
same YAML and body files: the multistep flows of tests/test_simulation.py
(:135 the run, :210 restart, :246 the wall-clock stop and OutMulti, :578
the runner features, :667 the sanity stop, :773 nrelevel, :828 OrbTrace,
:916 eqmotion).

Tolerances as in test_torch_simulation.py: f64 configs to F64 = 1e-10
relative (with a floor of 1e-10 of the largest value), text outputs to
their printed digits (TEXT8), level counts exactly.  The runner-feature
flow holds the port's pinned multistep run to its flat run at the JAX
test's own tolerance (x rtol 1e-7, v rtol 1e-6, atol 1e-10) and the flat
run to exp_tpu's flat run at F64.
"""


import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.model import hernquist_model
from exp_tpu.ic.eddington import sample_spherical_model
from exp_tpu.nbody.particles import write_ascii_bodies
from exp_tpu.nbody.simulation import Simulation as JSim
from exp_tpu_torch.nbody.simulation import Simulation as TSim
from test_torch_simulation import (CONFIG, F64, TEXT6, TEXT8, close,
                                   configs, f64, logs)


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


MS = f64(CONFIG).replace("runtag: trun", "runtag: trun\n  multistep: 2\n"
                         "  dynfracV: 0.05\n  dynfracA: 0.05\n  nrelevel: 2"
                         ).replace("  - id: outchkpt\n    parameters: "
                                   "{nint: 10}\n",
                                   "  - id: outchkpt\n    parameters: "
                                   "{nint: 5}\n") + (
    "  - id: outmulti\n    parameters: {nint: 1}\n"
    "  - id: orbtrace\n    parameters: {nint: 1, norb: 4}\n"
    "  - id: outdiag\n    parameters: {nint: 2}\n"
    "  - id: outfrac\n    parameters: {nint: 2}\n"
    "  - id: outcalbr\n    parameters: {nint: 2}\n"
    "  - id: outascii\n    parameters: {nint: 5}\n"
    "  - id: outhdf5\n    parameters: {nint: 5, real4: false}\n")


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    d = tmp_path_factory.mktemp("msrun")
    m = hernquist_model(rmin=1e-4, rmax=20.0, numr=1000)
    m.to_file(d / "halo.model")
    x, v, mass = sample_spherical_model(m, 3000, seed=11)
    write_ascii_bodies(d / "halo.bods", (x, v, mass))
    return d


def by_id(sim, name="halo"):
    """Live rows of a component ordered by particle id: (ids, x, v)."""
    ps = sim._state[name]
    ix, m = np.asarray(ps.indx), np.asarray(ps.mass)
    live = m > 0
    order = np.argsort(ix[live])
    return (ix[live][order], np.asarray(ps.x)[live][order],
            np.asarray(ps.v)[live][order])


@pytest.fixture(scope="module")
def msrun(rundir):
    """One multistep run of 10 big steps (M=2, nrelevel 2) in each driver."""
    pj, pt = configs(rundir, "ms", MS)
    sj, st = JSim.from_file(pj), TSim.from_file(pt, device="cpu")
    assert st.M == 2
    sj.run(10)
    st.run(10)
    return sj, st


def test_multistep_config_run(rundir, msrun):
    """:135 and :773 (nrelevel 2) — OUTLOG, the final state and the level
    populations agree; energy and the virial as the JAX test gates."""
    sj, st = msrun
    lj, lt = logs(rundir, "ms")
    assert lt.shape == lj.shape == (11, 32)
    close(lt, lj, TEXT8)
    E, ratios = lt[:, 15], lt[:, 16]
    assert abs(E[-1] - E[0]) / abs(E[0]) < 5e-3
    assert (np.mean(ratios) - 1.0) ** 2 < 0.01
    ct = st._ms_runner.level_counts(st._ms_state)["halo"]
    assert sum(ct) == 3000
    assert ct == [int(c) for c in
                  sj._ms_runner.level_counts(sj._ms_state)["halo"]]
    it, xt, vt = by_id(st)
    ij, xj, vj = by_id(sj)
    np.testing.assert_array_equal(it, ij)
    close(xt, xj, F64)
    close(vt, vj, F64)


def test_outmulti_and_orbtrace(rundir, msrun):
    """:246's OutMulti and :828's OrbTrace: the same level file, the same
    traced orbits (TEXT8), continuous across rebucketing; the identities
    survive the relevels."""
    lv_t = (rundir / "t_ms" / "trun.levels").read_text().splitlines()
    lv_j = (rundir / "j_ms" / "trun.levels").read_text().splitlines()
    assert len(lv_t) == len(lv_j) == 12
    for a, b in zip(lv_t[1:], lv_j[1:]):
        ta, tb = a.split(), b.split()
        assert ta[1:] == tb[1:] and float(ta[0]) == pytest.approx(
            float(tb[0]), rel=1e-7)
    tr = np.loadtxt(rundir / "t_ms" / "ORBTRACE.trun")
    close(tr, np.loadtxt(rundir / "j_ms" / "ORBTRACE.trun"), TEXT8)
    assert tr.shape == (11, 1 + 4 * 6)
    xs = tr[:, 1:].reshape(len(tr), 4, 6)[:, :, :3]
    assert np.linalg.norm(np.diff(xs, axis=0), axis=2).max() < 0.2
    ids = by_id(msrun[1])[0]
    assert ids.tolist() == list(range(1, 3001))


def _sorted_rows(a):
    return a[np.lexsort(a.T[::-1])]


def test_multistep_writers_match_exp_tpu(rundir, msrun):
    """OutDiag, OutFrac and OutCalbr (their printed digits: TEXT8, and
    TEXT6 for OUTCALBR's %.6g), OutAscii and OutHDF5 (f64, F64) at
    multistep 2 against exp_tpu's; the dumps' rows are sorted first (a
    writer takes the buckets' order, which two runners need not share).
    The single-rate writers are test_torch_simulation.py's."""
    import h5py

    for f, tol in (("OUTDIAG.trun", TEXT8), ("OUTFRAC.trun", TEXT8),
                   ("OUTCALBR.trun", TEXT6)):
        a, b = (np.loadtxt(rundir / f"{w}_ms" / f) for w in ("t", "j"))
        assert a.shape == b.shape and len(a) >= 5, f
        close(a, b, tol, atol=1e-300)
    for k in (0, 5, 10):
        a, b = (_sorted_rows(np.loadtxt(rundir / f"{w}_ms"
                                        / f"halo.trun.{k:05d}.ascii",
                                        skiprows=1)) for w in ("t", "j"))
        assert a.shape == b.shape == (3000, 7)
        close(a, b, F64)
    with h5py.File(rundir / "t_ms" / "OUT.trun.h5", "r") as ft, \
            h5py.File(rundir / "j_ms" / "OUT.trun.h5", "r") as fj:
        assert int(ft.attrs["count"]) == int(fj.attrs["count"]) == 3
        for g in ("00000000", "00000001", "00000002"):
            assert ft[f"snapshots/{g}"].attrs["Time"] == pytest.approx(
                fj[f"snapshots/{g}"].attrs["Time"], rel=1e-7)
            a, b = (_sorted_rows(np.column_stack(
                [f[f"snapshots/{g}/halo/{c}"][...].reshape(3000, -1)
                 for c in ("mass", "pos", "vel", "pot")])) for f in (ft, fj))
            close(a, b, F64)


def test_multistep_checkpoint_restart(rundir, msrun):
    """:210 — restoring drops the stale buckets; the port restores its own
    and exp_tpu's step-10 checkpoint to one state and continues both alike
    (F64), the levels repopulated, energy conserved."""
    from exp_tpu_torch.nbody.output import restore_checkpoint

    _, st = msrun
    x10 = by_id(st)[1]
    pt = configs(rundir, "msr", MS)[1]     # its own outdir
    outs = []
    for who in ("t", "j"):
        s2 = TSim.from_file(pt, device="cpu")
        s2.run(1)                       # buckets exist, then are dropped
        restore_checkpoint(s2, str(rundir / f"{who}_ms" / "OUT.trun.chkpt"))
        assert s2.istep == 10 and s2._ms_state is None
        close(by_id(s2)[1], x10, F64)
        s2.run(5)
        assert sum(s2._ms_runner.level_counts(s2._ms_state)["halo"]) == 3000
        outs.append(by_id(s2))
    for a, b in zip(outs[0], outs[1]):
        close(a, b, F64)


def test_wall_clock_stop(rundir):
    """:246 — a spent wall budget checkpoints and stops before the first
    big step, in both drivers."""
    pj, pt = configs(rundir, "wall", MS.replace("nsteps: 20", "nsteps: 10"))
    for sim in (TSim.from_file(pt, device="cpu"), JSim.from_file(pj)):
        sim.wall_limit = 0.0
        sim.run(10)
        assert sim.istep < 10
    for who in ("t", "j"):
        assert (rundir / f"{who}_wall" / "OUT.trun.chkpt").exists()


FEATURES = {
    "plain": "",
    "adiabatic": "      adiabatic: true\n      ton: 0.04\n      twid: 0.02\n",
    "rtrunc": "      rtrunc: 1.5\n",
    "com": "      com: true\n",
}


def _feature_cfg(feature, multistep):
    glob = f"  multistep: {multistep}\n"
    if multistep:
        # pin every particle to level 0: all dt criteria >> dtime
        glob += ("  dynfracV: 1.0e30\n  dynfracA: 1.0e30\n"
                 "  dynfracP: 1.0e30\n")
    extra = FEATURES[feature]
    params = f"    parameters:\n{extra}" if extra else ""
    return f"""\
Global:
  dtime: 0.02
  nsteps: 6
  runtag: trun
  compute_dtype: float64
{glob}Components:
  - name: halo
    bodyfile: halo.bods
{params}    force:
      id: sphereSL
      parameters:
        numr: 800
        Lmax: 2
        nmax: 8
        rmapping: 1.0
        modelname: halo.model
        cachename: halo.cache.h5
Output:
  - id: outlog
    parameters: {{nint: 6}}
"""


@pytest.mark.parametrize("feature", list(FEATURES))
def test_multistep_feature_equivalence(rundir, feature):
    """:578 — multistep (M=2, every particle at level 0) + a feature equals
    flat stepping + the feature, and the port's flat run equals exp_tpu's."""
    ms = TSim.from_file(configs(rundir, f"fx_{feature}_ms",
                                _feature_cfg(feature, 2))[1], device="cpu")
    ms.run()
    assert ms._ms_runner.level_counts(ms._ms_state)["halo"][0] == 3000
    pj, pt = configs(rundir, f"fx_{feature}_flat", _feature_cfg(feature, 0))
    flat = TSim.from_file(pt, device="cpu", steps_per_block=1)
    jflat = JSim.from_file(pj, steps_per_block=1)
    for s in (flat, jflat):
        s.prime()
        s.run()
    _, xm, vm = by_id(ms)
    _, xf, vf = by_id(flat)
    np.testing.assert_allclose(xm, xf, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(vm, vf, rtol=1e-6, atol=1e-10)
    _, xj, vj = by_id(jflat)
    close(xf, xj, F64)
    close(vf, vj, F64)


def test_multistep_sanity_stop(rundir):
    """:667 — a runaway level demand stops both runs at the same big step
    with a checkpoint."""
    txt = CONFIG.replace("dtime: 0.02", "dtime: 5.0").replace(
        "nsteps: 20", "nsteps: 10").replace(
        "runtag: trun", "runtag: trun\n  multistep: 1\n  maxMindt: 0.05")
    pj, pt = configs(rundir, "runaway", txt)
    st, sj = TSim.from_file(pt, device="cpu"), JSim.from_file(pj)
    for s in (st, sj):
        s.run()
        assert s.stop_requested and s.istep < 10
    assert st.istep == sj.istep
    assert (rundir / "t_runaway" / "OUT.trun.chkpt").exists()


def test_eqmotion_freeze_multistep(rundir):
    """:916 — eqmotion: false keeps the buckets' phase space bit for bit
    across big steps, and equal to exp_tpu's."""
    txt = f64(CONFIG).replace("runtag: trun", "runtag: trun\n"
                              "  eqmotion: false\n  multistep: 2")
    pj, pt = configs(rundir, "eqmms", txt)
    st, sj = TSim.from_file(pt, device="cpu"), JSim.from_file(pj)
    st.run(1)
    sj.run(1)
    x1 = by_id(st)[1]
    st.run(2)
    np.testing.assert_array_equal(by_id(st)[1], x1)
    np.testing.assert_array_equal(x1, by_id(sj)[1])


def test_fused_bigstep_runs_the_same_loop(rundir):
    """fused_bigstep maps to the runner's fused=, which runs the same
    eager loop: the same bits as without it."""
    txt = MS.replace("nsteps: 20", "nsteps: 2")
    a = TSim.from_file(configs(rundir, "unf", txt)[1], device="cpu")
    b = TSim.from_file(configs(rundir, "fus", txt.replace(
        "multistep: 2", "multistep: 2\n  fused_bigstep: true"))[1],
        device="cpu")
    assert b._ms_runner.fused and not a._ms_runner.fused
    a.run()
    b.run()
    for u, w in zip(by_id(a), by_id(b)):
        np.testing.assert_array_equal(u, w)
    assert torch.equal(a._state["halo"].x, b._state["halo"].x)


# ---------------------------------------------------------------------------
# the forces the runner once refused: two-center and source (direct)
# components, both drivers on the same YAML in f64
# ---------------------------------------------------------------------------

TWOCENTER = """\
    force:
      id: twocenter
      parameters:
        basis: sphereSL
        cfac: 1.0
        alpha: 1.0
        parameters: {numr: 600, Lmax: 2, nmax: 6, rmapping: 1.0,
                      modelname: sys.model}
"""


def _system_files(rundir):
    """sys.bods: the halo's 3,000 bodies and a satellite clump (a 0.3,
    M 0.3, 600 bodies) at (3, 0, 0), tests/test_twocenter.py's host +
    satellite at a smaller count; sys.model its basis model; bh.bods one
    body of mass 0.01 on a near-circular orbit at r = 0.5."""
    if (rundir / "sys.bods").exists():
        return
    mh = hernquist_model(rmin=1e-4, rmax=20.0, numr=1000)
    xh, vh, mass_h = sample_spherical_model(mh, 3000, seed=11)
    ms = hernquist_model(a=0.3, M=0.3, rmin=1e-4, rmax=6.0, numr=600)
    xs, vs, mass_s = sample_spherical_model(ms, 600, seed=12)
    write_ascii_bodies(rundir / "sys.bods", (
        np.concatenate([xh, xs + np.array([3.0, 0.0, 0.0])]),
        np.concatenate([vh, vs]), np.concatenate([mass_h, mass_s])))
    hernquist_model(rmin=1e-4, rmax=30.0, numr=800).to_file(
        rundir / "sys.model")
    write_ascii_bodies(rundir / "bh.bods", (np.array([[0.5, 0.0, 0.0]]),
                                            np.array([[0.0, 0.47, 0.0]]),
                                            np.array([0.01])))


def _tc_cfg(multistep, comp_params, pinned=False):
    glob = f"  multistep: {multistep}\n"
    if pinned:
        glob += ("  dynfracV: 1.0e30\n  dynfracA: 1.0e30\n"
                 "  dynfracP: 1.0e30\n")
    return f"""\
Global:
  dtime: 0.02
  nsteps: 4
  runtag: trun
  compute_dtype: float64
{glob}Components:
  - name: sys
    bodyfile: sys.bods
    parameters: {comp_params}
{TWOCENTER}Output:
  - id: outlog
    parameters: {{nint: 1}}
"""


def test_twocenter_multistep_matches_exp_tpu(rundir):
    """tests/test_twocenter.py:85 at M=2: the EJ-tracked center drives the
    inner expansion, the COM the outer; both drivers for 4 big steps, the
    state to F64 by id and OUTLOG to its printed digits."""
    _system_files(rundir)
    pj, pt = configs(rundir, "tc_ms", _tc_cfg(
        2, "{EJ: 2, nEJkeep: 512, EJwindow: 4}"))
    sj, st = JSim.from_file(pj), TSim.from_file(pt, device="cpu")
    for s in (sj, st):
        s.run()
    lj, lt = logs(rundir, "tc_ms")
    assert lt.shape == lj.shape
    close(lt, lj, TEXT8, atol=1e-14)
    for a, b in zip(by_id(st, "sys"), by_id(sj, "sys")):
        close(a, b, F64)
    ke = float(np.asarray(st._diag["sys"]["KE"]))
    assert np.isfinite(ke) and ke > 0


def test_twocenter_multistep_equals_flat(rundir):
    """tests/test_twocenter.py:121 on the port: M=2 with every particle at
    level 0, com and rtrunc, equals flat stepping at the JAX test's
    tolerance (x rtol 1e-7, v rtol 1e-6); the port's flat run equals
    exp_tpu's (F64)."""
    _system_files(rundir)
    feats = "{com: true, rtrunc: 8.0}"
    ms = TSim.from_file(configs(rundir, "tcp_ms", _tc_cfg(2, feats, True))[1],
                        device="cpu")
    ms.run()
    assert ms._ms_runner.level_counts(ms._ms_state)["sys"][0] == 3600
    pj, pt = configs(rundir, "tcp_flat", _tc_cfg(0, feats))
    flat = TSim.from_file(pt, device="cpu", steps_per_block=1)
    jflat = JSim.from_file(pj, steps_per_block=1)
    for s in (flat, jflat):
        s.prime()
        s.run()
    _, xm, vm = by_id(ms, "sys")
    _, xf, vf = by_id(flat, "sys")
    np.testing.assert_allclose(xm, xf, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(vm, vf, rtol=1e-6, atol=1e-9)
    for a, b in zip(by_id(flat, "sys"), by_id(jflat, "sys")):
        close(a, b, F64)


def test_direct_component_multistep_matches_exp_tpu(rundir):
    """A halo (sphereSL) and a one-body `smbh` component under `direct`
    (plummer, soft 0.01), coupled both ways, at M=2 with live levels: the
    runner's source path (every kick reads the body's position and mass).
    Both drivers for 4 big steps: both components' states to F64 and
    OUTLOG to its printed digits.  (The names sort in config order:
    exp_tpu writes OUTLOG's sections in sorted-name order, ROADMAP §3.)"""
    _system_files(rundir)
    txt = f64(CONFIG).replace("nsteps: 20", "nsteps: 4").replace(
        "runtag: trun", "runtag: trun\n  multistep: 2\n  dynfracV: 0.05\n"
        "  dynfracA: 0.05").replace(
        "  - id: outcoef\n    parameters: {nint: 2, name: halo}\n", "")
    txt = txt.replace("  - id: outchkpt\n    parameters: {nint: 10}\n", "")
    txt = txt.replace("Output:", """\
  - name: smbh
    bodyfile: bh.bods
    force:
      id: direct
      parameters: {type: Plummer, soft: 0.01}
Interaction:
  - halo: smbh
  - smbh: halo
Output:""")
    pj, pt = configs(rundir, "bh_ms", txt)
    sj, st = JSim.from_file(pj), TSim.from_file(pt, device="cpu")
    for s in (sj, st):
        s.run()
    assert st.couples == {"halo": ["halo", "smbh"],
                          "smbh": ["smbh", "halo"]}
    lj, lt = logs(rundir, "bh_ms")
    assert lt.shape == lj.shape
    close(lt, lj, TEXT8, atol=1e-14)
    for name in ("halo", "smbh"):
        for a, b in zip(by_id(st, name), by_id(sj, name)):
            close(a, b, F64)
    assert st._coefs["smbh"].shape == (1,)
