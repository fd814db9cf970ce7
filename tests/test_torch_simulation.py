"""The port's YAML driver (exp_tpu_torch/nbody/simulation.py, output.py,
run.py) against exp_tpu's on the same YAML and the same body files: the
single-rate flows of tests/test_simulation.py (the multistep flows are in
test_torch_simulation_multistep.py), the force ids the driver builds, the
component extras (EJ, playback, NOISE, npca, restrictions, the External
stanza, OutSamp, a frozen halo under multistep), and the features it
refuses.

Each flow runs both drivers on one config, written twice with its own
`outdir` (j_<tag>, t_<tag>), the port on the CPU.  Tolerances:
  * f64 configs (compute_dtype: float64): in-memory state, diagnostics and
    coefficients to 1e-10 relative (F64), with an absolute floor of 1e-10
    of the largest value for quantities that are sums cancelling to ~0;
  * OUTLOG (%.8g), ORBTRACE/OUTDIAG/OUTFRAC (%.8g) and OUTCALBR (%.6g)
    hold 8 and 6 significant digits, so their columns agree to a unit in
    the last printed digit (TEXT8 2e-7, TEXT6 2e-5), read the same way;
  * f32 configs (the default compute dtype): OUTLOG rtol 1e-5, atol 1e-6
    (F32_LOG), coefficient files rtol 1e-5 against the largest |c|
    (F32_COEF): trajectories in f32 differ by rounding of order 1e-7 a
    step; tests/test_simulation.py's own bounds on the same flows (energy
    drift 5e-3, virial within 0.1, file vs live coefficients 1e-6) are
    held on the port as well.
"""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.model import hernquist_model
from exp_tpu.config import ConfigError as JConfigError
from exp_tpu.ic.eddington import sample_spherical_model
from exp_tpu.nbody.particles import write_ascii_bodies
from exp_tpu.nbody.simulation import Simulation as JSim
from exp_tpu_torch.config import ConfigError
from exp_tpu_torch.nbody.simulation import Simulation as TSim


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


F64 = 1e-10
TEXT8, TEXT6 = 2e-7, 2e-5
F32_LOG = dict(rtol=1e-5, atol=1e-6)
F32_COEF = 1e-5

CONFIG = """\
Global:
  dtime: 0.02
  nsteps: 20
  runtag: trun
Components:
  - name: halo
    bodyfile: halo.bods
    force:
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
    parameters: {nint: 1}
  - id: outcoef
    parameters: {nint: 2, name: halo}
  - id: outchkpt
    parameters: {nint: 10}
"""


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    d = tmp_path_factory.mktemp("halorun")
    m = hernquist_model(rmin=1e-4, rmax=20.0, numr=1000)
    m.to_file(d / "halo.model")
    x, v, mass = sample_spherical_model(m, 3000, seed=11)
    write_ascii_bodies(d / "halo.bods", (x, v, mass))
    return d


def f64(text):
    return text.replace("  runtag: trun", "  runtag: trun\n"
                        "  compute_dtype: float64")


def configs(rundir, tag, text):
    """The config as two files, one outdir each: (jax path, port path)."""
    out = []
    for who in ("j", "t"):
        p = rundir / f"{tag}_{who}.yml"
        p.write_text(text.replace("Global:\n",
                                  f"Global:\n  outdir: {who}_{tag}\n", 1))
        out.append(str(p))
    return out


def both(rundir, tag, text, nsteps=None, prime=True):
    pj, pt = configs(rundir, tag, text)
    sj, st = JSim.from_file(pj), TSim.from_file(pt, device="cpu")
    for s in (sj, st):
        if prime:
            s.prime()
        s.run(nsteps)
    return sj, st


def table(path, drop_clock=True):
    rows = [r for r in open(path).read().splitlines()
            if not r.startswith("#") and "Time" not in r]
    a = np.array([[float(v) for v in r.split("|")] for r in rows])
    return np.delete(a, 17, 1) if drop_clock else a


def close(t, j, rtol, floor=F64, atol=0.0):
    """|t - j| <= rtol |j| + floor max|j| (the floor over each column)
    + atol."""
    t, j = np.asarray(t), np.asarray(j)
    dt = np.complex128 if np.iscomplexobj(j) else np.float64
    t, j = t.astype(dt), j.astype(dt)
    assert t.shape == j.shape
    scale = np.abs(j).max(axis=0) if j.ndim > 1 else np.abs(j).max()
    bad = np.abs(t - j) > rtol * np.abs(j) + floor * scale + atol
    assert not bad.any(), (f"{bad.sum()} of {bad.size} differ; max rel "
                           f"{np.max(np.abs(t - j) / np.maximum(np.abs(j), 1e-300))}")


def state(sim, name="halo"):
    ps = sim._state[name]
    live = np.asarray(ps.mass) > 0
    return np.asarray(ps.x)[live], np.asarray(ps.v)[live]


def logs(rundir, tag, name="OUTLOG.trun"):
    return (table(rundir / f"j_{tag}" / name),
            table(rundir / f"t_{tag}" / name))


# ---------------------------------------------------------------------------
# tests/test_simulation.py flows
# ---------------------------------------------------------------------------

def test_config_validation(rundir):
    """:58 — the same RunConfig; a bad key fails both."""
    from exp_tpu.config import RunConfig as JRC
    from exp_tpu_torch.config import RunConfig as TRC

    (rundir / "config.yml").write_text(CONFIG)
    assert TRC.from_file(rundir / "config.yml").glob.nsteps == 20
    assert JRC.from_file(rundir / "config.yml").components[0].force.id == \
        TRC.from_file(rundir / "config.yml").components[0].force.id
    (rundir / "bad.yml").write_text(CONFIG.replace("dtime", "dtmie"))
    with pytest.raises(ConfigError):
        TRC.from_file(rundir / "bad.yml")


def test_run_and_outputs_f32(rundir):
    """:71 in the default f32: OUTLOG and the coefficient file agree with
    exp_tpu's (F32_LOG, F32_COEF); the JAX test's own gates hold."""
    from exp_tpu.io.coefs import open_coefs as jopen
    from exp_tpu_torch.io.coefs import SphCoefsFile, open_coefs

    sj, st = both(rundir, "out32", CONFIG)
    lj, lt = logs(rundir, "out32")
    assert lt.shape == lj.shape == (21, 32)
    np.testing.assert_allclose(lt, lj, **F32_LOG)
    ratios, E = lt[1:, 16], lt[:, 15]
    assert (np.mean(ratios) - 1.0) ** 2 < 0.01
    assert abs(E[-1] - E[0]) / abs(E[0]) < 5e-3
    with open_coefs(str(rundir / "t_out32" / "outcoef.halo.trun.h5")) as cf, \
            jopen(str(rundir / "j_out32" / "outcoef.halo.trun.h5")) as cj:
        assert isinstance(cf, SphCoefsFile)
        tt, ct = cf.read_all()
        tj, cjj = cj.read_all()
        assert dict(cf._f.attrs) == dict(cj._f.attrs)
    assert len(tt) == 11 and ct.shape[1:] == (2, 3, 3, 8)
    np.testing.assert_array_equal(tt, tj)
    close(ct, cjj, 0.0, floor=F32_COEF)
    np.testing.assert_allclose(ct[-1], st._coefs["halo"], rtol=1e-6,
                               atol=1e-10)
    c000 = ct[:, 0, 0, 0, 0]
    assert np.all(np.abs(c000 - c000[0]) < 0.05 * np.abs(c000[0]))


def test_run_and_outputs_f64(rundir):
    """:71 in f64: state, diagnostics, coefficient file to F64; OUTLOG to
    its printed digits."""
    from exp_tpu.io.coefs import open_coefs as jopen
    from exp_tpu_torch.io.coefs import open_coefs

    sj, st = both(rundir, "out64", f64(CONFIG))
    lj, lt = logs(rundir, "out64")
    close(lt, lj, TEXT8)
    for a, b in zip(state(st), state(sj)):
        close(a, b, F64)
    for k in ("KE", "PE", "VC", "mom", "L"):
        close(st._diag["halo"][k], np.asarray(sj._diag["halo"][k]), F64)
    with open_coefs(str(rundir / "t_out64" / "outcoef.halo.trun.h5")) as cf, \
            jopen(str(rundir / "j_out64" / "outcoef.halo.trun.h5")) as cj:
        close(cf.read_all()[1], cj.read_all()[1], F64)


def test_outvel_matches_exp_tpu(rundir):
    """OutVel (tests/test_simulation.py::test_outvel_writer) on both
    drivers in f64 for 4 steps, every 2: the same groups, field names,
    times, and each snapshot's 'dens', vx, vy, vz coefficients to F32_COEF
    of the largest (both project in float32 accumulation); finite."""
    import h5py

    txt = f64(CONFIG) + ("  - id: outvel\n"
                         "    parameters: {nint: 2, name: halo}\n")
    sj, st = both(rundir, "outvel", txt, nsteps=4)
    name = "outvel.halo.trun.h5"
    with h5py.File(rundir / "t_outvel" / name) as ft, \
            h5py.File(rundir / "j_outvel" / name) as fj:
        assert list(ft.attrs["fields"]) == list(fj.attrs["fields"]) == [
            "dens", "vx", "vy", "vz"]
        assert ft.attrs["name"] == fj.attrs["name"] == "halo"
        assert sorted(ft.keys()) == sorted(fj.keys())
        assert len(ft.keys()) >= 2
        for g in ft.keys():
            assert ft[g].attrs["Time"] == fj[g].attrs["Time"]
            for k in fj.attrs["fields"]:
                a, b = ft[g][k][()], fj[g][k][()]
                assert a.dtype == b.dtype and np.isfinite(a).all()
                close(a.ravel(), b.ravel(), 0.0, floor=F32_COEF)


def test_checkpoint_restart(rundir):
    """:106 — the port restores its own and exp_tpu's checkpoint at step 10
    to the same state, and both continue alike (F64)."""
    from exp_tpu_torch.nbody.output import restore_checkpoint

    sj, st = both(rundir, "ck", f64(CONFIG), nsteps=10)
    x10 = state(st)[0]
    outs = []
    for who in ("t", "j"):
        s2 = TSim.from_file(str(rundir / "ck_t.yml"), device="cpu")
        restore_checkpoint(s2, str(rundir / f"{who}_ck" / "OUT.trun.chkpt"))
        assert s2.istep == 10
        close(state(s2)[0], x10, F64)
        s2.prime()
        s2.run(4)
        outs.append(state(s2))
    for a, b in zip(*outs):
        close(a, b, F64)
    assert np.isfinite(outs[0][0]).all()


def test_cli_main(rundir, capsys, monkeypatch):
    """:126 — `python -m exp_tpu_torch.run --cpu config.yml -n 4` echoes
    the config and reports particle-steps/s; its OUTLOG matches exp_tpu's
    CLI run.  Without --cpu and with no card it refuses.  --ndev 2 (two
    spawned ranks over gloo) and --distributed (a one-rank world from
    EXP_COORDINATOR / EXP_NPROCS / EXP_PROCID) print the same OUTLOG
    (ROADMAP item 12)."""
    from exp_tpu.run import main as jmain
    from exp_tpu_torch.run import main

    pj, pt = configs(rundir, "cli", f64(CONFIG))
    main(["--cpu", pt, "-n", "4"])
    assert "particle-steps/s" in capsys.readouterr().out
    assert (rundir / "t_cli" / "config.trun.yml").exists()
    jmain([pj, "-n", "4"])
    lj, lt = logs(rundir, "cli")
    assert len(lt) == 5
    close(lt, lj, TEXT8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([pt, "-n", "1"])
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    monkeypatch.setenv("EXP_COORDINATOR", f"127.0.0.1:{s.getsockname()[1]}")
    s.close()
    monkeypatch.setenv("EXP_NPROCS", "1")
    monkeypatch.setenv("EXP_PROCID", "0")
    # --ndev 2 spawns its ranks: in a process of its own, killed with them
    # after 300 s
    import signal
    import subprocess
    import sys

    p = configs(rundir, "nd2", f64(CONFIG))[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent.parent),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-m", "exp_tpu_torch.run",
                             "--cpu", p, "-n", "4", "--ndev", "2"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    main(["--cpu", configs(rundir, "dist", f64(CONFIG))[1], "-n", "4",
          "--distributed"])
    for tag in ("nd2", "dist"):
        lw = table(rundir / f"t_{tag}" / "OUTLOG.trun")
        close(lw, lt, TEXT8)


def test_self_consistent_false_freezes_coefficients(rundir):
    """:155 — the frozen expansion is the prime-time projection in the
    compute dtype, constant step to step, and equal to exp_tpu's."""
    txt = CONFIG.replace("        numr: 800", "        numr: 800\n"
                         "        self_consistent: false")
    pj, pt = configs(rundir, "frz", txt)
    st = TSim.from_file(pt, device="cpu")
    st.prime()
    c0 = st._coefs["halo"].copy()
    st.run(3)
    c3 = st._coefs["halo"].copy()
    st.run(3)
    np.testing.assert_allclose(c3, c0, rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(st._coefs["halo"], c3)
    sj = JSim.from_file(pj)
    sj.prime()
    sj.run(6)
    close(st._coefs["halo"], np.asarray(sj._coefs["halo"]), 0.0,
          floor=F32_COEF)
    np.testing.assert_allclose(table(rundir / "t_frz" / "OUTLOG.trun"),
                               table(rundir / "j_frz" / "OUTLOG.trun"),
                               **F32_LOG)


def test_interaction_one_way_and_dedup_with_noforce(rundir):
    """:186 — `a: b` means b feels a, once; a noforce component moves in
    the halo's field alike in both drivers (F64)."""
    txt = f64(CONFIG).replace("runtag: trun", "runtag: trun\n  "
                              "allcouples: false").replace(
        "Components:", "Interaction:\n  - halo: halo2\n  - halo: halo2\n"
        "Components:\n  - name: halo2\n    bodyfile: halo.bods\n"
        "    force:\n      id: noforce\n")
    sj, st = both(rundir, "iact", txt, nsteps=3)
    assert st.couples == sj.couples
    assert st.couples["halo2"] == ["halo2", "halo"]
    assert st.couples["halo"] == ["halo"]
    for a, b in zip(state(st, "halo2"), state(sj, "halo2")):
        close(a, b, F64)
    np.testing.assert_array_equal(st._coefs["halo2"],
                                  np.zeros((2, 1, 1, 1)))


def test_diag_outputs(rundir):
    """:269 — ORBTRACE, OUTDIAG and OUTFRAC agree to their printed digits."""
    txt = f64(CONFIG) + (
        "  - id : orbtrace\n    parameters : {nint: 1, norb: 3}\n"
        "  - id : outdiag\n    parameters : {nint: 2}\n"
        "  - id : outfrac\n    parameters : {nint: 2}\n")
    both(rundir, "diag", txt, nsteps=4)
    for name, ncol in (("ORBTRACE.trun", 19), ("OUTFRAC.trun", 9),
                       ("OUTDIAG.trun", 6)):
        t = np.loadtxt(rundir / "t_diag" / name)
        j = np.loadtxt(rundir / "j_diag" / name)
        assert t.shape == j.shape and t.shape[1] == ncol
        close(t, j, TEXT8)
    tr = np.loadtxt(rundir / "t_diag" / "ORBTRACE.trun")
    assert np.abs(tr[-1, 1:4] - tr[0, 1:4]).max() > 0
    fr = np.loadtxt(rundir / "t_diag" / "OUTFRAC.trun")
    assert np.all(np.diff(fr[0, 1:]) > 0)


def test_outcalbr_and_timers(rundir, capsys):
    """:292 — OUTCALBR's bins agree (TEXT6); VERBOSE > 3 prints timings."""
    txt = f64(CONFIG).replace("runtag: trun", "runtag: trun\n  VERBOSE: 4") \
        + "  - id : outcalbr\n    parameters : {nint: 2, num: 5}\n"
    both(rundir, "calbr", txt, nsteps=4)
    assert "timing:" in capsys.readouterr().out
    t = np.loadtxt(rundir / "t_calbr" / "OUTCALBR.trun")
    j = np.loadtxt(rundir / "j_calbr" / "OUTCALBR.trun")
    assert t.shape == j.shape == (2, 26)
    counts = t[-1, 5::5]
    assert counts.sum() == 3000
    np.testing.assert_array_equal(counts, j[-1, 5::5])
    close(t, j, TEXT6, floor=1e-6)


def test_fpe_guard(rundir):
    """:315 — fpe: true passes a healthy run and, on a poisoned state,
    dumps SPSCHK.<runtag>.badvalues and raises, in both drivers."""
    txt = CONFIG.replace("runtag: trun", "runtag: trun\n  fpe: true")
    sj, st = both(rundir, "fpe", txt, nsteps=2)
    st._state["halo"].v[0, 0] = float("nan")
    with pytest.raises(FloatingPointError):
        st.run(2)
    assert (rundir / "t_fpe" / "SPSCHK.trun.badvalues").exists()
    from dataclasses import replace

    ps = sj._state["halo"]
    sj._state["halo"] = replace(ps, v=ps.v.at[0, 0].set(np.nan))
    with pytest.raises(FloatingPointError):
        sj.run(2)


def test_adaptive_basis_recompute(rundir):
    """:358 — sphereSL dtime > 0 rebuilds the basis from the particles at
    t = 0.08 in both drivers; the runs agree after it (F64)."""
    txt = f64(CONFIG).replace("rmapping: 1.0", "rmapping: 1.0\n"
                              "        dtime: 0.08")
    pj, pt = configs(rundir, "adap", txt)
    st = TSim.from_file(pt, device="cpu")
    st.prime()
    f0 = st.components["halo"].force
    st.run(10)
    assert st.components["halo"].force is not f0
    assert st.components["halo"].basis_tnext > 0.08
    d = st._diag["halo"]
    assert 0.8 < -2.0 * float(d["KE"]) / float(d["VC"]) < 1.25
    sj = JSim.from_file(pj)
    sj.prime()
    sj.run(10)
    for a, b in zip(state(st), state(sj)):
        close(a, b, F64)


def test_chkpt_bak_generations(rundir):
    """:380 — nbak > 1 keeps .bak, .bak1, .bak2; the newest restores, also
    exp_tpu's into the port."""
    from exp_tpu_torch.nbody.output import restore_checkpoint

    txt = CONFIG.replace("  - id: outchkpt\n    parameters: {nint: 10}\n",
                         "  - id: outchkpt\n    parameters: {nint: 2, "
                         "nbak: 3}\n")
    sj, st = both(rundir, "bak", txt, nsteps=6)
    for who in ("t", "j"):
        base = str(rundir / f"{who}_bak" / "OUT.trun.chkpt")
        assert all(os.path.exists(base + s)
                   for s in ("", ".bak", ".bak1", ".bak2"))
        s2 = TSim.from_file(str(rundir / "bak_t.yml"), device="cpu")
        restore_checkpoint(s2, base)
        assert abs(s2.time - st.time) < 1e-12 and s2.istep == 6


def test_rtrunc(rundir):
    """:403 — particles beyond rtrunc leave the expansion: the monopole
    falls, as in exp_tpu (coefficients F64)."""
    txt = f64(CONFIG).replace("bodyfile: halo.bods", "bodyfile: halo.bods\n"
                              "    parameters:\n      rtrunc: 1.0")
    sj, st = both(rundir, "rt", txt, nsteps=2)
    close(st._coefs["halo"], np.asarray(sj._coefs["halo"]), F64)
    sf = TSim.from_file(configs(rundir, "rtf", f64(CONFIG))[1], device="cpu")
    sf.prime()
    sf.run(2)
    assert np.abs(st._coefs["halo"][0]).sum() < \
        0.9 * np.abs(sf._coefs["halo"][0]).sum()


def test_com_system(rundir):
    """:427 — com: true expands about the COM of a halo displaced by 2:
    virial balance and COM as the JAX test gates, state F64."""
    b = np.loadtxt(rundir / "halo.bods", skiprows=1)
    b[:, 1] += 2.0
    hdr = open(rundir / "halo.bods").readline().strip()
    np.savetxt(rundir / "off.bods", b, header=hdr, comments="")
    txt = f64(CONFIG).replace("bodyfile: halo.bods", "bodyfile: off.bods\n"
                              "    parameters:\n      com: true")
    sj, st = both(rundir, "com", txt, nsteps=10)
    d = st._diag["halo"]
    assert abs(-2.0 * float(d["KE"]) / float(d["VC"]) - 1.0) < 0.15
    np.testing.assert_allclose(d["com"][0] / float(d["mass"]), 2.0,
                               atol=0.05)
    for a, c in zip(state(st), state(sj)):
        close(a, c, F64)


def test_nbodmax(rundir):
    """:451 — nbodmax is a hard config error in both."""
    pj, pt = configs(rundir, "nb", CONFIG.replace(
        "runtag: trun", "runtag: trun\n  nbodmax: 100"))
    with pytest.raises(ConfigError, match="nbodmax"):
        TSim.from_file(pt, device="cpu")
    with pytest.raises(JConfigError, match="nbodmax"):
        JSim.from_file(pj)


def test_psp_bodyfile_ingestion(rundir):
    """:705 — a PSP body file gives the ascii run's result exactly (1e-12,
    as the JAX test), and exp_tpu's (F64)."""
    from exp_tpu_torch.io.psp import PSPComponent, PSPDump, write_psp

    b = np.loadtxt(rundir / "halo.bods", skiprows=1)
    d = PSPDump(time=0.0)
    d.components.append(PSPComponent(
        name="halo", info="name: halo\n", mass=b[:, 0], x=b[:, 1:4],
        v=b[:, 4:7], pot=np.zeros(len(b))))
    write_psp(str(rundir / "halo.psp"), d)
    txt = f64(CONFIG)
    sj, sb = both(rundir, "pspb", txt.replace("bodyfile: halo.bods",
                                              "bodyfile: halo.psp"),
                  nsteps=3)
    sa = TSim.from_file(configs(rundir, "pspa", txt)[1], device="cpu")
    sa.prime()
    sa.run(3)
    for k in ("KE", "PE"):
        assert float(sa._diag["halo"][k]) == pytest.approx(
            float(sb._diag["halo"][k]), rel=1e-12)
        close(sb._diag["halo"][k], np.asarray(sj._diag["halo"][k]), F64)


def test_outchkptq_quick_checkpoint(rundir):
    """:737 — outchkptq writes f32 datasets, the same layout as exp_tpu's."""
    import h5py

    txt = CONFIG.replace("nsteps: 20", "nsteps: 4").replace(
        "  - id: outchkpt\n    parameters: {nint: 10}\n",
        "  - id: outchkptq\n    parameters: {nint: 2}\n")
    both(rundir, "ckq", txt)
    with h5py.File(rundir / "t_ckq" / "OUT.trun.chkpt") as ft, \
            h5py.File(rundir / "j_ckq" / "OUT.trun.chkpt") as fj:
        assert ft["halo"]["x"].dtype == np.float32
        assert sorted(ft["halo"]) == sorted(fj["halo"])
        for k in ft["halo"]:
            assert ft["halo"][k].dtype == fj["halo"][k].dtype, k
            assert ft["halo"][k].shape == fj["halo"][k].shape, k
        assert dict(ft.attrs) == dict(fj.attrs)


def test_restart_continues_outputs(rundir):
    """:794 — an `infile:` restart through the CLI appends to OUTLOG and
    the coefficient series instead of truncating them; the continued
    OUTLOG matches exp_tpu's (TEXT8)."""
    from exp_tpu.run import main as jmain
    from exp_tpu_torch.io.coefs import open_coefs
    from exp_tpu_torch.run import main

    txt = f64(CONFIG).replace("nsteps: 20", "nsteps: 10")
    both(rundir, "cont", txt)
    rows1 = (rundir / "t_cont" / "OUTLOG.trun").read_text().splitlines()
    with open_coefs(str(rundir / "t_cont" / "outcoef.halo.trun.h5")) as f:
        n1 = len(f.times())
    pj, pt = configs(rundir, "cont", txt.replace(
        "runtag: trun", "runtag: trun\n  infile: OUT.trun.chkpt"))
    main(["--cpu", pt, "-n", "6"])
    jmain([pj, "-n", "6"])
    rows2 = (rundir / "t_cont" / "OUTLOG.trun").read_text().splitlines()
    assert len(rows2) > len(rows1) and rows2[:len(rows1)] == rows1
    with open_coefs(str(rundir / "t_cont" / "outcoef.halo.trun.h5")) as f:
        ts = f.times()
    assert len(ts) > n1 and ts[-1] > 0.2 - 1e-9
    lj, lt = logs(rundir, "cont")
    close(lt, lj, TEXT8)


def test_reference_global_keys(rundir):
    """:862 — the reference's Global vocabulary parses; the honored keys
    reach the Simulation as in exp_tpu."""
    txt = CONFIG.replace(
        "runtag: trun",
        "runtag: trun\n"
        "  nthrds: 4\n  cuda: off\n  use_cuda: false\n  ngpus: 0\n"
        "  barrier_check: true\n  barrier_quiet: true\n  mpi_wait: false\n"
        "  fpe_trap: false\n  fpe_trace: false\n  traceback: true\n"
        "  runtime: 0.5\n  restart_cmd: 'echo resub'\n  nreport: 5\n"
        "  random_seed: 42\n  eqmotion: true\n  restart_as_new: false\n"
        "  NICE: 0\n  rlimit: 0\n  use_cwd: false\n  centerlevl: 1")
    pj, pt = configs(rundir, "gkeys", txt)
    st, sj = TSim.from_file(pt, device="cpu"), JSim.from_file(pj)
    assert st.wall_limit == pytest.approx(0.5 * 3600.0)
    for k in ("wall_limit", "restart_cmd", "nreport", "eqmotion", "dt",
              "nsteps", "steps_per_block", "is_restart"):
        assert getattr(st, k) == getattr(sj, k), k


def test_eqmotion_freeze(rundir, capsys):
    """:892 — eqmotion: false freezes x and v while the fields are still
    evaluated (acc F64 against exp_tpu's); nreport prints its lines."""
    txt = f64(CONFIG).replace("runtag: trun", "runtag: trun\n"
                              "  eqmotion: false\n  nreport: 2")
    pj, pt = configs(rundir, "eqm", txt)
    st = TSim.from_file(pt, device="cpu")
    st.prime()
    x0, v0 = (a.clone() for a in (st._state["halo"].x, st._state["halo"].v))
    st.run(6)
    assert st.istep == 6 and st.time == pytest.approx(6 * st.dt)
    assert torch.equal(st._state["halo"].x, x0)
    assert torch.equal(st._state["halo"].v, v0)
    out = capsys.readouterr().out
    assert "step 2" in out and "step 4" in out and "step 6" in out
    sj = JSim.from_file(pj)
    sj.prime()
    sj.run(6)
    acc = st._state["halo"].acc.numpy()
    assert np.isfinite(acc).all() and np.abs(acc).max() > 0
    close(acc, np.asarray(sj._state["halo"].acc), F64)


def test_restart_as_new(rundir):
    """:936 — restart_as_new seeds a new run from exp_tpu's checkpoint:
    time and step 0, fresh outputs, the checkpoint's bodies."""
    from exp_tpu_torch.nbody.output import restore_checkpoint

    sj, _ = both(rundir, "asn0", f64(CONFIG), nsteps=10)
    x10 = np.asarray(sj._state["halo"].x)
    txt = f64(CONFIG).replace("runtag: trun", "runtag: trun\n"
                              "  infile: OUT.trun.chkpt\n"
                              "  restart_as_new: true")
    s2 = TSim.from_file(configs(rundir, "asn1", txt)[1], device="cpu")
    assert s2.is_restart is False
    restore_checkpoint(s2, str(rundir / "j_asn0" / "OUT.trun.chkpt"),
                       as_new=True)
    assert s2.istep == 0 and s2.time == 0.0
    close(s2._state["halo"].x.numpy(), x10, 1e-12)
    s2.prime()
    s2.run(2)
    assert s2.istep == 2


def test_psp_restart_and_outpsn(rundir):
    """tests/test_io.py:153/:215 through the driver: OutPSN dumps read
    back as the state, and a PSP checkpoint restarts the run."""
    from exp_tpu_torch.io.psp import read_psp
    from exp_tpu_torch.nbody.output import restore_checkpoint

    txt = f64(CONFIG).replace("nsteps: 20", "nsteps: 4") + \
        "  - id: outpsn\n    parameters: {nint: 2, real4: false}\n"
    sj, st = both(rundir, "psn", txt)
    for k in (0, 2, 4):
        pt_ = rundir / "t_psn" / f"OUT.trun.{k:05d}"
        pj_ = rundir / "j_psn" / f"OUT.trun.{k:05d}"
        dt_, dj_ = read_psp(str(pt_)), read_psp(str(pj_))
        assert dt_.time == dj_.time
        close(dt_.components[0].x, dj_.components[0].x, F64)
    np.testing.assert_array_equal(dt_.components[0].x, state(st)[0])
    s2 = TSim.from_file(str(rundir / "psn_t.yml"), device="cpu")
    restore_checkpoint(s2, str(rundir / "j_psn" / "OUT.trun.00004"))
    assert s2.time == pytest.approx(0.08) and s2.istep == 4
    close(state(s2)[0], state(sj)[0], F64)


def test_outps_outhdf5_outspl_outascii(rundir):
    """tests/test_io.py:255's OutPS + OutHDF5 run (noforce, f32), with
    OutSPL and OutAscii: the same files, the headers byte-equal, the
    values within an f32 ulp a step (rtol 5e-7 over 4 steps: exp_tpu's
    XLA contracts the drift x + v dt into one FMA, the port rounds v dt
    first, so a position may move an ulp apart each step)."""
    import h5py

    from exp_tpu_torch.io.psp import read_psp, read_spl

    rng = np.random.default_rng(9)
    n = 100
    write_ascii_bodies(rundir / "b.bods", (rng.normal(0, 0.5, (n, 3)),
                                           rng.normal(0, 0.2, (n, 3)),
                                           np.full(n, 1.0 / n)))
    txt = """\
Global:
  dtime: 0.01
  nsteps: 4
  runtag: psrun
Components:
  - name: halo
    bodyfile: b.bods
    force: {id: noforce, parameters: {}}
Output:
  - id: outps
    parameters: {nint: 2, real4: false}
  - id: outhdf5
    parameters: {nint: 2}
  - id: outspl
    parameters: {nint: 4, nparts: 2}
  - id: outascii
    parameters: {nint: 4}
"""
    both(rundir, "ps", txt)
    ulp2 = dict(rtol=5e-7, atol=1e-12)
    t, j = rundir / "t_ps", rundir / "j_ps"
    assert (t / "SPL.psrun.00004").read_bytes() == \
        (j / "SPL.psrun.00004").read_bytes()
    dt_, dj_ = read_psp(str(t / "OUT.psrun")), read_psp(str(j / "OUT.psrun"))
    assert len(dt_) == len(dj_) == 3
    st_, sj_ = read_spl(str(t / "SPL.psrun.00004")), \
        read_spl(str(j / "SPL.psrun.00004"))
    for a, b in zip(dt_ + [st_], dj_ + [sj_]):
        assert a.time == b.time
        for k in ("mass", "x", "v", "pot"):
            np.testing.assert_allclose(getattr(a.components[0], k),
                                       getattr(b.components[0], k), **ulp2)
    np.testing.assert_allclose(
        np.loadtxt(t / "halo.psrun.00004.ascii", skiprows=1),
        np.loadtxt(j / "halo.psrun.00004.ascii", skiprows=1), **ulp2)
    with h5py.File(t / "OUT.psrun.h5") as ft, \
            h5py.File(j / "OUT.psrun.h5") as fj:
        assert ft.attrs["count"] == fj.attrs["count"] == 3
        for s in ("00000000", "00000002"):
            assert ft[f"snapshots/{s}"].attrs["Time"] == \
                fj[f"snapshots/{s}"].attrs["Time"]
            for k in ("mass", "pos", "vel", "pot"):
                np.testing.assert_allclose(
                    ft[f"snapshots/{s}/halo/{k}"][()],
                    fj[f"snapshots/{s}/halo/{k}"][()], **ulp2)


# ---------------------------------------------------------------------------
# the other force ids of build_force
# ---------------------------------------------------------------------------

def _bodies(rundir, kind):
    rng = np.random.default_rng(21)
    n = 2000
    if kind == "cube":
        x = rng.uniform(0, 1, (n, 3))
    elif kind == "slab":
        x = np.column_stack([rng.uniform(0, 1, (n, 2)),
                             0.01 * rng.standard_normal(n)])
    else:
        return "halo.bods"
    v = 0.05 * rng.standard_normal((n, 3))
    write_ascii_bodies(rundir / f"{kind}.bods", (x, v, np.full(n, 1.0 / n)))
    return f"{kind}.bods"


FORCES = {
    "cube": ("cube", "cube", "{nmaxx: 2, nmaxy: 2, nmaxz: 3}"),
    "slabSL": ("slabSL", "slab", "{nmaxx: 2, nmaxy: 1, nmaxz: 3, "
               "zmax: 0.1, hslab: 0.01}"),
    "cylinder": ("cylinder", "halo", "{mmax: 2, nmax: 4, lmaxfid: 4, "
                 "nmaxfid: 4, ncylnx: 16, ncylny: 8, rnum: 24, tnum: 12, "
                 "acyl: 0.5, hcyl: 0.1}"),
    "cylinder_particles": ("cylinder", "halo", "{mmax: 2, nmax: 4, "
                           "lmaxfid: 4, nmaxfid: 4, ncylnx: 16, ncylny: 8, "
                           "rnum: 24, tnum: 12, acyl: 0.5, hcyl: 0.1, "
                           "conditioning: particles}"),
    "flatdisk": ("flatdisk", "halo", "{mmax: 2, nmax: 4, numx: 16, "
                 "numy: 8, knots: 40, numk: 16}"),
    "CBDisk": ("CBDisk", "halo", "{Mmax: 2, nmax: 4, numx: 16, numy: 8, "
               "knots: 40, numk: 16}"),
    "sphereSL_builtin": ("sphereSL", "halo", "{Lmax: 2, nmax: 6, "
                         "numr: 400, modelname: 'hernquist:a=1,M=1'}"),
    "sphereSL_gather": ("sphereSL", "halo", "{Lmax: 2, nmax: 6, numr: 400, "
                        "modelname: halo.model, backend: gather}"),
    "bessel": ("bessel", "halo", "{Lmax: 2, nmax: 6, rmax: 25.0, numr: 400}"),
    "CBsphere": ("CBsphere", "halo", "{Lmax: 2, nmax: 6, numr: 400, "
                 "rmax: 30.0}"),
    "hernq": ("hernq", "halo", "{Lmax: 2, nmax: 6, numr: 400, rmax: 30.0, "
              "scale: 1.2}"),
    "direct": ("direct", "halo", "{type: Plummer, soft: 0.01}"),
    "shells": ("shells", "halo", "{rmax: 20.0, nbins: 64}"),
    "halobulge": ("halobulge", "halo", "{modelname: halo.model}"),
    "twocenter": ("twocenter", "halo", "{basis: sphereSL, cfac: 1.0, "
                  "alpha: 2.0, parameters: {numr: 400, Lmax: 2, nmax: 6, "
                  "rmapping: 1.0, modelname: halo.model}}"),
}


@pytest.mark.parametrize("case", list(FORCES))
def test_force_ids_match(rundir, case):
    """build_force's other ids through both drivers: 3 KDK steps in f64,
    coefficients and state to F64 (tables on the host in f64 on both
    sides); a twocenter's coefficients are its (inner, outer) pair, a
    direct component's a (1,) zero."""
    fid, kind, params = FORCES[case]
    txt = f"""\
Global:
  dtime: 0.005
  nsteps: 3
  runtag: trun
  compute_dtype: float64
Components:
  - name: c
    bodyfile: {_bodies(rundir, kind)}
    force:
      id: {fid}
      parameters: {params}
Output:
  - id: outlog
    parameters: {{nint: 1}}
"""
    sj, st = both(rundir, f"f_{case}", txt)
    ct, cj = np.asarray(st._coefs["c"]), np.asarray(sj._coefs["c"])
    assert ct.shape == cj.shape
    close(ct, cj, F64)
    for a, b in zip(state(st, "c"), state(sj, "c")):
        close(a, b, F64)


# ---------------------------------------------------------------------------
# the driver's extras: each runs both drivers on the same YAML (f64, 4
# steps); the final state to F64 and OUTLOG to its printed digits
# ---------------------------------------------------------------------------

PORTED = {
    "EJ": ("comp", "EJ: 2"), "nEJaccel": ("comp", "EJ: 2\n      nEJaccel: 3"),
    "centerfile": ("comp", "centerfile: ctr.dat"),
    "playback": ("comp", "playback: outcoef.h5"),
    "npca": ("comp", "npca: 2"), "NOISE": ("noise", "NOISE: true\n        noiseN: 3000.0"),
    "NO_L1": ("force", "NO_L1: true"), "FIX_L0": ("force", "FIX_L0: true"),
    "EVEN_L": ("force", "EVEN_L: true"),
    "mlim_cylinder": ("cylforce", "mlim: 1"),
    "External": ("ext", "External:\n  - id: userdisk\n"),
    "periodicBC": ("ext", "External:\n  - id: periodicBC\n"
                   "    parameters: {L: 4.0, btype: ppv}\n"),
    "outsamp": ("out", "  - id: outsamp\n    parameters: {nint: 2}\n"),
    "frozen_multistep": ("glob", "self_consistent"),
}

CYL_PARAMS = ("{mmax: 2, nmax: 4, lmaxfid: 4, nmaxfid: 4, ncylnx: 16, "
              "ncylny: 8, rnum: 24, tnum: 12, acyl: 0.5, hcyl: 0.1, ")


def _extras_files(rundir):
    """ctr.dat (a drifting center) and outcoef.h5 (a port run's own
    coefficient series, f64, one record a step)."""
    if not (rundir / "ctr.dat").exists():
        np.savetxt(rundir / "ctr.dat",
                   np.array([[0.0, 0.0, 0.0, 0.0], [1.0, 0.5, -0.25, 0.1]]))
    if not (rundir / "outcoef.h5").exists():
        src = f64(CONFIG).replace("{nint: 2, name: halo}",
                                  "{nint: 1, name: halo}")
        sim = TSim.from_file(configs(rundir, "pbsrc", src)[1], device="cpu")
        sim.run(6)
        os.replace(rundir / "t_pbsrc" / "outcoef.halo.trun.h5",
                   rundir / "outcoef.h5")


def ported_config(case):
    where, what = PORTED[case]
    txt = f64(CONFIG).replace("nsteps: 20", "nsteps: 4").replace(
        "  - id: outchkpt\n    parameters: {nint: 10}\n", "")
    if where == "comp":
        txt = txt.replace("bodyfile: halo.bods", "bodyfile: halo.bods\n"
                          f"    parameters:\n      {what}")
    elif where in ("force", "noise"):
        txt = txt.replace("        numr: 800", f"        numr: 800\n"
                          f"        {what}")
        if where == "noise":
            # under multistep, where exp_tpu draws once an extras call; its
            # single-rate driver discards one draw when it compiles a step
            # (test_torch_extras_pca.py::test_noise_run_end_to_end)
            txt = txt.replace("runtag: trun", "runtag: trun\n  multistep: 1")
    elif where == "cylforce":
        a = txt.index("      parameters:\n        numr")
        b = txt.index("Output:")
        txt = (txt[:a] + f"      parameters: {CYL_PARAMS}{what}}}\n"
               + txt[b:]).replace("id: sphereSL", "id: cylinder")
    elif where in ("ext", "out"):
        txt = txt + what
    elif where == "glob":
        txt = txt.replace("runtag: trun", "runtag: trun\n  multistep: 2") \
            .replace("        numr: 800", "        numr: 800\n"
                     "        self_consistent: false")
    return txt


def by_indx(sim, name="halo"):
    ps = sim._state[name]
    ix, m = np.asarray(ps.indx), np.asarray(ps.mass)
    o = np.argsort(ix[m > 0])
    return np.asarray(ps.x)[m > 0][o], np.asarray(ps.v)[m > 0][o]


#: exp_tpu's driver in a child process: the config's run, its final
#: state saved; JAX set up as the root conftest.py sets it, the persistent
#: compilation cache off as in the module's fixture, and the cache
#: module's debug log on stderr
_CHILD = """\
import logging, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_ENABLE_X64"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)
logging.basicConfig(stream=sys.stderr, level=logging.WARNING)
logging.getLogger("jax._src.compilation_cache").setLevel(logging.DEBUG)
import numpy as np
from exp_tpu.nbody.simulation import Simulation
sim = Simulation.from_file(sys.argv[1])
if sys.argv[3] == "1":
    sim.prime()
sim.run()
ps = sim._state["halo"]
np.savez(sys.argv[2], **{k: np.asarray(getattr(ps, k))
                         for k in ("x", "v", "mass", "indx")})
"""


def exp_tpu_in_child(rundir, path, prime=True):
    """exp_tpu's side of a parity case in a child process (F1, ROADMAP §3:
    an abort inside exp_tpu's eager ops took a test worker down with
    nothing recorded).  On a non-zero exit the case fails with the child's
    stderr: the C++ abort message, Python's fault handler traceback and
    JAX's compilation-cache debug log.  Returns an object whose
    `_state["halo"]` holds the final x, v, mass and indx."""
    import subprocess
    import sys
    from types import SimpleNamespace

    out = Path(rundir) / (Path(path).stem + ".state.npz")
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-X", "faulthandler", "-c", _CHILD,
                        path, str(out), "1" if prime else "0"],
                       cwd=rundir, env=env, capture_output=True, text=True,
                       timeout=600)
    if p.returncode != 0:
        pytest.fail(f"exp_tpu's driver exited {p.returncode} in its child "
                    f"process; its stderr:\n{p.stderr[-12000:]}")
    z = np.load(out)
    return SimpleNamespace(_state={"halo": SimpleNamespace(**z)})


@pytest.mark.parametrize("case", list(PORTED))
def test_ported_feature_matches_exp_tpu(rundir, case):
    """Each extra the driver once refused: both drivers on the same YAML
    in f64 for 4 steps (big steps under multistep); the final state to
    F64, OUTLOG to its printed digits (TEXT8), the OutSamp file (float32
    accumulation in both) to F32_COEF; a frozen halo's coefficients equal
    its captured set bit for bit.  The outsamp case runs exp_tpu's driver
    in a child process (exp_tpu_in_child, ROADMAP §3 F1)."""
    _extras_files(rundir)
    prime = case not in ("frozen_multistep", "NOISE")
    if case == "outsamp":
        # exp_tpu's side in a child process, which reports an abort (F1)
        pj, pt = configs(rundir, f"px_{case}", ported_config(case))
        sj = exp_tpu_in_child(rundir, pj, prime=prime)
        st = TSim.from_file(pt, device="cpu")
        st.prime()
        st.run()
    else:
        sj, st = both(rundir, f"px_{case}", ported_config(case), prime=prime)
    for a, b in zip(by_indx(st), by_indx(sj)):
        close(a, b, F64)
    if case == "nEJaccel":
        # the estimator's queue (3 samples, the first at the start) is
        # full from the 2nd step: the correction acts in steps 3 and 4
        pa = st.components["halo"].pseudo()
        assert np.any(pa[0] != 0)
        for u, q in zip(pa, sj.components["halo"].pseudo()):
            close(u, q, F64, floor=1e-12)
    lj, lt = logs(rundir, f"px_{case}")
    assert lt.shape == lj.shape == (5, 32)
    # atol: the centre-of-mass columns cancel to ~1e-17
    close(lt, lj, TEXT8, atol=1e-14)
    assert np.isfinite(lt).all()
    if case == "outsamp":
        import h5py

        name = "outsamp.halo.trun.h5"
        with h5py.File(rundir / f"t_px_{case}" / name) as ft, \
                h5py.File(rundir / f"j_px_{case}" / name) as fj:
            assert sorted(ft.keys()) == sorted(fj.keys())
            assert len(ft.keys()) == 3
            for k in ft.keys():
                assert ft[k].attrs["Time"] == fj[k].attrs["Time"]
                # exp_tpu's OutSamp projects in its float32 default
                # accumulation: F32_COEF of the largest value
                for d in ("mean", "variance"):
                    close(ft[k][d][()], fj[k][d][()], 0.0, floor=F32_COEF)
    if case == "frozen_multistep":
        np.testing.assert_array_equal(_host_c(st), _host_c(st, frozen=True))


def _host_c(sim, frozen=False):
    c = sim._frozen["halo"] if frozen else sim._coefs["halo"]
    return np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c)


# ---------------------------------------------------------------------------
# refusals: what the driver once refused under a world (ROADMAP item 12b)
# ---------------------------------------------------------------------------

REFUSED = {
    "outvel": ("out", "  - id: outvel\n    parameters: {nint: 2}\n"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_unported_features_raise(rundir, case):
    """OutVel, which a world of several ranks refused until ROADMAP item
    12b, builds there now with a gather of its own (each rank's
    projections summed over the ranks; the 2-rank runs are
    tests/test_torch_distributed.py's), and no refusal naming item 12b is
    left in the driver or its writers."""
    import inspect

    from exp_tpu_torch.config import OutputConfig
    from exp_tpu_torch.nbody import output, simulation

    where, what = REFUSED[case]
    txt = CONFIG + what
    p = configs(rundir, f"ref_{case}", txt)[1]
    sim = TSim.from_file(p, device="cpu")
    sim.dist = True
    o = sim._make_output(OutputConfig(id=case, parameters={"nint": 2}))
    assert type(o).gather is not output.Output.gather
    for mod in (simulation, output):
        assert "12b" not in inspect.getsource(mod)
        assert "NotImplementedError(" not in inspect.getsource(mod)


def test_multi_process_world_raises(rundir, monkeypatch):
    """A process group of several ranks that no World of its size joined
    refuses to start (each rank would run the whole system alone); a World
    of one rank without a group is the one-device driver, and the writers
    a world of several ranks refused until ROADMAP item 12b build there
    with a gather of the host phase space (the 2-rank driver runs in
    tests/test_torch_distributed.py)."""
    from exp_tpu_torch.config import OutputConfig
    from exp_tpu_torch.nbody.output import Output
    from exp_tpu_torch.parallel.distributed import World

    p = configs(rundir, "mp", CONFIG)[1]
    sim = TSim.from_file(p, device="cpu", world=World())
    assert sim.world is None and sim.is_primary and not sim.dist
    sim.dist = True
    for oid in ("outascii", "orbtrace", "outhdf5"):
        o = sim._make_output(OutputConfig(id=oid, parameters={}))
        assert type(o).gather is not Output.gather, oid
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    for kw in ({}, {"world": World()}):
        with pytest.raises(RuntimeError, match="no rank runs alone"):
            TSim.from_file(p, device="cpu", **kw)