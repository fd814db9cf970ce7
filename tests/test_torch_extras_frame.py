"""The non-inertial frame correction (nEJaccel) of the port's driver against
exp_tpu's while the correction is non-zero: a prescribed quadratic center
under multistep, EJ's tracked center on the single-rate and the multistep
paths with the estimator's queue full for most of the run, and a reduced
disk + halo composite with chip_smoke.py E1's extras (the disk's EJ: 2 and
nEJaccel, the halo's Hall smoothing) under multistep.

Tolerances: driver runs in f64 to F64 = 1e-10 relative
(test_torch_simulation.py), OUTLOG and the orient log to their printed
digits (TEXT8); the frame acceleration each step to F64 of its largest
component (both drivers fit the same NumPy f64 samples).
"""


import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

import jax.numpy as jnp
from exp_tpu.nbody.simulation import Simulation as JSim
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


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    """A 2,000-body Hernquist halo and a 1,500-body exponential disk (the
    disk on circular orbits of the halo + disk potential, with 10%
    dispersion), as ascii body files."""
    from exp_tpu.basis.model import hernquist_model
    from exp_tpu.ic.disk import sample_exponential_disk
    from exp_tpu.ic.eddington import sample_spherical_model
    from exp_tpu.nbody.particles import write_ascii_bodies

    d = tmp_path_factory.mktemp("framerun")
    m = hernquist_model(rmin=1e-3, rmax=10.0)
    m.to_file(d / "halo.model")
    x, v, mass = sample_spherical_model(m, 2000, seed=13)
    write_ascii_bodies(d / "halo.bods", (x, v, mass))
    xd, md = sample_exponential_disk(1500, acyl=0.5, hcyl=0.05, mass=0.1,
                                     seed=5)
    R = np.hypot(xd[:, 0], xd[:, 1]) + 1e-12
    vc = np.sqrt(R * R / (R + 1.0) ** 2 + 0.1 * R / (R + 0.5) ** 2)
    rng = np.random.default_rng(6)
    vd = np.stack([-vc * xd[:, 1] / R, vc * xd[:, 0] / R,
                   np.zeros(len(R))], -1) + 0.1 * vc[:, None] \
        * rng.standard_normal((len(R), 3))
    write_ascii_bodies(d / "disk.bods", (xd, vd, md))
    return d


def _run(rundir, tag, txt, nsteps, **kw):
    """Both drivers on one config, a step (big step) at a time; returns
    (sj, st, [(accel_j, accel_t) after each step]) for the component
    `kw.pop('name')`."""
    name = kw.pop("name", "halo")
    pj, pt = configs(rundir, tag, txt)
    sj = JSim.from_file(pj, **kw)
    st = TSim.from_file(pt, device="cpu", **kw)
    acc = []
    for s in (sj, st):
        s.prime()
    for _ in range(nsteps):
        for s in (sj, st):
            s.run(1)
        if st.components[name].pseudo is not None:
            acc.append((sj.components[name].pseudo()[0],
                        st.components[name].pseudo()[0]))
    return sj, st, acc


def _by_indx(sim, name):
    ps = sim._state[name]
    m = np.asarray(ps.mass)
    o = np.argsort(np.asarray(ps.indx)[m > 0])
    return np.asarray(ps.x)[m > 0][o], np.asarray(ps.v)[m > 0][o]


def _com(sim, name="halo"):
    d = sim._diag[name]
    return np.asarray(d["com"], np.float64) / float(np.asarray(d["mass"]))


def test_pseudo_multistep_centerfile(rundir):
    """test_orient.py:191 under multistep (M=2): a halo in a uniform field
    g, its expansion center prescribed on the free-fall trajectory
    X(t) = g t^2 / 2 by a centerfile sampled every big step, so that the
    estimator's quadratic fit returns g from the 3rd big step on.  Without
    nEJaccel the halo falls (COM ~ X(t)); with it the correction cancels
    the field.  Each big step's frame acceleration and COM, the final state
    and OUTLOG equal exp_tpu's."""
    from exp_tpu.forces.external import ExternalField as JExt
    from exp_tpu.forces.external import register_external as jreg
    from exp_tpu_torch.forces.external import ExternalField as TExt
    from exp_tpu_torch.forces.external import register_external as treg

    gx, nbig, dt = 0.05, 16, 0.02

    class JUniformX(JExt):
        def acceleration(self, x, t):
            return jnp.zeros_like(x).at[:, 0].set(gx), -gx * x[:, 0]

    class TUniformX(TExt):
        def acceleration(self, x, t):
            acc = torch.zeros_like(x)
            acc[:, 0] = gx
            return acc, -gx * x[:, 0]

    jreg("test_uniform_x_ms", JUniformX)
    treg("test_uniform_x_ms", TUniformX)
    ts = np.arange(0, (nbig + 2) * dt, dt)
    np.savetxt(rundir / "ctrq.dat",
               np.column_stack([ts, 0.5 * gx * ts * ts,
                                np.zeros_like(ts), np.zeros_like(ts)]))

    def com_path(naccel):
        txt = f"""\
Global:
  dtime: {dt}
  nsteps: {nbig}
  runtag: trun
  multistep: 2
  dynfracV: 0.05
  dynfracA: 0.05
  compute_dtype: float64
Components:
  - name: halo
    bodyfile: halo.bods
    parameters: {{centerfile: ctrq.dat, nEJaccel: {naccel}}}
    force:
      id: sphereSL
      parameters: {{numr: 600, Lmax: 2, nmax: 6, rmapping: 1.0,
                   modelname: halo.model}}
External:
  - id: test_uniform_x_ms
Output:
  - id: outlog
    parameters: {{nint: 1}}
"""
        tag = f"psms{naccel}"
        pj, pt = configs(rundir, tag, txt)
        sj, st = JSim.from_file(pj), TSim.from_file(pt, device="cpu")
        assert st.M == 2
        coms, accs = [], []
        for _ in range(nbig):
            for s in (sj, st):
                s.run(1)
            coms.append((_com(sj)[0], _com(st)[0]))
            if naccel:
                accs.append((sj.components["halo"].pseudo()[0],
                             st.components["halo"].pseudo()[0]))
        coms = np.array(coms)
        close(coms[:, 1], coms[:, 0], F64)
        for a, b in zip(_by_indx(st, "halo"), _by_indx(sj, "halo")):
            close(a, b, F64)
        close(table(rundir / f"t_{tag}" / "OUTLOG.trun"),
              table(rundir / f"j_{tag}" / "OUTLOG.trun"), TEXT8,
              atol=1e-14)
        return coms[:, 1], accs

    com_off, _ = com_path(0)
    com_on, accs = com_path(3)
    for aj, at in accs:
        close(at, aj, F64, floor=1e-12)
    # the queue holds 3 samples from the 2nd big step on (the first at
    # init): the fit of an exact parabola returns g
    live = [at for _, at in accs if np.any(at != 0)]
    assert len(live) >= nbig - 2
    for at in live:
        np.testing.assert_allclose(at, [gx, 0.0, 0.0], atol=1e-9)
    # the halo falls at g without the correction; with it, its COM moves
    # at the velocity it gained before the queue filled, unaccelerated
    T_ = nbig * dt
    np.testing.assert_allclose(com_off[-1], 0.5 * gx * T_ * T_, rtol=0.1)
    tt = (np.arange(nbig) + 1) * dt
    np.testing.assert_allclose(2.0 * np.polyfit(tt, com_off, 2)[0], gx,
                               rtol=0.1)
    assert abs(2.0 * np.polyfit(tt[3:], com_on[3:], 2)[0]) < 0.05 * gx


EJ2 = """\
Global:
  dtime: 0.02
  nsteps: {nsteps}
  runtag: ej2
  compute_dtype: float64
  multistep: {M}
  maxMindt: 1.0
Components:
  - name: halo
    bodyfile: halo.bods
    parameters: {{EJ: 2, nEJkeep: 128, EJwindow: 4, nEJaccel: 3}}
    force:
      id: sphereSL
      parameters: {{numr: 600, Lmax: 2, nmax: 6, rmapping: 1.0,
                   modelname: halo.model}}
Output:
  - id: outlog
    parameters: {{nint: 1}}
"""


@pytest.mark.parametrize("multistep", [0, 2])
def test_ej_frame_correction(rundir, multistep):
    """EJ: 2 with nEJaccel 3 (the frame acceleration from the tracked
    center, updated every step or big step): the queue fills at the 2nd
    update and the correction acts on 6 of the 8 steps.  The frame
    acceleration after every step, the tracked center, the final state,
    OUTLOG and the orient log equal exp_tpu's on the single-rate path
    (blocks of one step) and under multistep (M=2)."""
    nsteps = 8
    txt = EJ2.format(nsteps=nsteps, M=multistep)
    kw = {} if multistep else {"steps_per_block": 1}
    sj, st, acc = _run(rundir, f"ejf{multistep}", txt, nsteps, **kw)
    nz = 0
    for aj, at in acc:
        close(at, aj, F64, floor=1e-12)
        nz += bool(np.any(at != 0))
    assert nz >= nsteps - 2
    close(st._centers["halo"], np.asarray(sj._centers["halo"]), F64)
    for a, b in zip(_by_indx(st, "halo"), _by_indx(sj, "halo")):
        close(a, b, F64)
    d = f"ejf{multistep}"
    close(table(rundir / f"t_{d}" / "OUTLOG.ej2"),
          table(rundir / f"j_{d}" / "OUTLOG.ej2"), TEXT8, atol=1e-14)
    ot = np.loadtxt(rundir / f"t_{d}" / "ej2.orient.halo")
    oj = np.loadtxt(rundir / f"j_{d}" / "ej2.orient.halo")
    assert ot.shape == oj.shape and len(ot) >= nsteps
    close(ot, oj, TEXT8, atol=1e-14)


E1_SMALL = """\
Global:
  dtime: 0.002
  nsteps: {nbig}
  runtag: e1
  compute_dtype: float64
  multistep: 2
  dynfracV: 0.01
  dynfracA: 0.03
  maxMindt: 1.0
Components:
  - name: halo
    bodyfile: halo.bods
    parameters: {{npca: 5, nsamples: 8, tk_type: Hall}}
    force:
      id: sphereSL
      parameters: {{numr: 600, Lmax: 2, nmax: 6, rmapping: 1.0,
                   modelname: halo.model}}
  - name: disk
    bodyfile: disk.bods
    parameters: {{EJ: 2, nEJkeep: 256, EJwindow: 16{accel}}}
    force:
      id: cylinder
      parameters: {{mmax: 2, nmax: 4, lmaxfid: 4, nmaxfid: 4, ncylnx: 16,
                   ncylny: 8, rnum: 24, tnum: 12, acyl: 0.5, hcyl: 0.05}}
Interaction:
  - halo: disk
  - disk: halo
Output:
  - id: outlog
    parameters: {{nint: 1}}
"""


def test_e1_extras_reduced(rundir):
    """chip_smoke.py E1's extras (the disk's EJ: 2, nEJkeep 256, EJwindow
    16, nEJaccel 8; the halo's npca 5, nsamples 8, Hall) and its dtime,
    M = 2, dynfrac and 10 big steps on a reduced disk + halo (2,000 +
    1,500 bodies, small bases, maxMindt 1 so that no overrun stops the
    run): the frame acceleration after every big step,
    the tracked center, the Hall weights, the final state and OUTLOG equal
    exp_tpu's, with the correction live in the last 3 big steps.  The
    energy drift with and without nEJaccel, in both drivers, is printed
    (-rP): the estimator's quadratic fit over 8 noisy centroids of the
    top-256 set one dtime apart gives a frame acceleration far above the
    disk's own, in exp_tpu's driver as in the port's."""
    nbig = 10
    drift = {}
    for naccel in (8, 0):
        accel = f", nEJaccel: {naccel}" if naccel else ""
        txt = E1_SMALL.format(nbig=nbig, accel=accel)
        sj, st, acc = _run(rundir, f"e1s{naccel}", txt, nbig, name="disk")
        for aj, at in acc:
            close(at, aj, F64, floor=1e-12)
        if naccel:
            live = [np.linalg.norm(at) for _, at in acc if np.any(at != 0)]
            assert len(live) >= 3
            frame = max(live)
        close(st._centers["disk"], np.asarray(sj._centers["disk"]), F64)
        close(st._hall["halo"].numpy(), np.asarray(sj._hall["halo"]), F64)
        for n in ("halo", "disk"):
            for a, b in zip(_by_indx(st, n), _by_indx(sj, n)):
                close(a, b, F64)
        lt = table(rundir / f"t_e1s{naccel}" / "OUTLOG.e1")
        lj = table(rundir / f"j_e1s{naccel}" / "OUTLOG.e1")
        # exp_tpu writes the component sections in the sorted order of
        # its diagnostics' names (disk, halo) under the header's (halo,
        # disk); the port in the header's
        lj = np.concatenate([lj[:, :17], lj[:, 32:], lj[:, 17:32]], 1)
        close(lt, lj, TEXT8, atol=1e-14)
        for who, log in (("port", lt), ("exp_tpu", lj)):
            e = log[:, 12] + log[:, 13]
            drift[(who, naccel)] = abs(e[-1] - e[0]) / abs(e[0])
    print(f"E1 reduced: max |frame accel| {frame:.4g}; |dE/E| over {nbig} "
          f"big steps with nEJaccel 8: port {drift['port', 8]:.6e}, "
          f"exp_tpu {drift['exp_tpu', 8]:.6e}; without: port "
          f"{drift['port', 0]:.6e}, exp_tpu {drift['exp_tpu', 0]:.6e}")
