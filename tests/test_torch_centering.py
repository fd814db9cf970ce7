"""The port's center tracking (exp_tpu_torch/nbody/centering.py) and the
driver's EJ, nEJaccel and centerfile against exp_tpu's: the flows of
tests/test_orient.py on the same inputs, made from a seed with NumPy.

Tolerances: the host regressions are the same NumPy float64 code, held to
1e-12; the top-K centroid and angular momentum of f64 rows to 1e-12
relative (a sum of K rows in an order that may differ between torch.topk
and lax.top_k only on ties, which continuous f64 energies do not have);
driver runs in f64 to F64 = 1e-10 relative (test_torch_simulation.py),
OUTLOG to its printed digits (TEXT8).
"""


import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

import jax.numpy as jnp
from exp_tpu.nbody import centering as J
from exp_tpu.nbody.simulation import Simulation as JSim
from exp_tpu_torch.nbody import centering as T
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


def test_regression_tracks_moving_center():
    """test_orient.py:14 — a linearly drifting center is recovered by the
    regression, in both packages to the same numbers."""
    os_ = [T.EJOrient(window=8, damp=1.0), J.EJOrient(window=8, damp=1.0)]
    vel = np.array([0.1, -0.05, 0.02])
    for k in range(12):
        t = 0.1 * k
        c1 = vel * t + np.random.default_rng(k).normal(0, 1e-12, 3)
        for o in os_:
            o._push(t, c1, np.array([0.0, 0.0, 1.0]))
            o._refresh(t)
    np.testing.assert_allclose(os_[0].center, vel * 1.1, atol=1e-9)
    np.testing.assert_array_equal(os_[0].center, os_[1].center)


def test_axis_to_body_maps_axis_to_z():
    """test_orient.py:27 — and the same matrices as exp_tpu's."""
    rng = np.random.default_rng(3)
    for _ in range(5):
        a = rng.normal(size=3)
        body, orig = T._axis_to_body(a)
        z = body @ (a / np.linalg.norm(a))
        np.testing.assert_allclose(z, [0, 0, 1], atol=1e-12)
        np.testing.assert_allclose(body @ orig, np.eye(3), atol=1e-12)
        np.testing.assert_array_equal(body, J._axis_to_body(a)[0])
    np.testing.assert_array_equal(T.euler_slater(0.3, -0.7, 0.2),
                                  J.euler_slater(0.3, -0.7, 0.2))


def _tilted_disk(n=4000, tilt=0.5, seed=4):
    """Thin cold disk tilted by `tilt` radians about the x-axis."""
    from exp_tpu.ic.disk import sample_exponential_disk

    x, mass = sample_exponential_disk(n, acyl=1.0, hcyl=0.02, mass=1.0,
                                      seed=seed)
    R = np.hypot(x[:, 0], x[:, 1])
    vc = np.sqrt(R / (R * R + 1.0) ** 1.5 + 1e-12)
    v = np.stack([-vc * x[:, 1] / R, vc * x[:, 0] / R, np.zeros(n)], -1)
    ct, st = np.cos(tilt), np.sin(tilt)
    Rx = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]])
    return x @ Rx.T, v @ Rx.T, mass, Rx @ np.array([0.0, 0, 1])


def test_tilted_disk_axis_recovery():
    """test_orient.py:51 — EJOrient recovers a tilted disk's normal from
    the most-bound set; the centroid and L equal exp_tpu's (1e-12), and
    zero-mass rows (the padding) never enter the set."""
    from dataclasses import replace

    from exp_tpu.nbody.particles import ParticleSystem as JPS
    from exp_tpu_torch.nbody.particles import ParticleSystem as TPS

    x, v, mass, normal = _tilted_disk()
    r = np.linalg.norm(x, axis=1)
    pot = -1.0 / (r + 0.1)
    # padding rows at the origin with the deepest potential
    xp = np.concatenate([x, np.zeros((96, 3))])
    vp = np.concatenate([v, np.zeros((96, 3))])
    mp = np.concatenate([mass, np.zeros(96)])
    pp = np.concatenate([pot, np.full(96, -100.0)])
    tps = TPS.from_arrays(xp, vp, mp, dtype=F64T, device="cpu")
    tps.pot = torch.as_tensor(pp)
    jps = replace(JPS.from_arrays(xp, vp, mp, dtype=jnp.float64),
                  pot=jnp.asarray(pp))
    ct, Lt = T._most_bound_centroid(tps.x, tps.v, tps.mass, tps.pot, k=512)
    cj, Lj = J._most_bound_centroid(jps.x, jps.v, jps.mass, jps.pot, k=512)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=1e-12)
    o = T.EJOrient(nkeep=512, window=4)
    o.update(tps, time=0.0)
    assert abs(float(np.dot(o.axis, normal))) > 0.999
    np.testing.assert_allclose(np.abs(o.body @ normal), [0, 0, 1],
                               atol=5e-3)


def test_axis_feedback_restores_m_spectrum():
    """test_orient.py:70 on the port's flatdisk force: rotating a tilted
    disk into the body frame cuts its m > 0 power several-fold, and the
    coefficients equal exp_tpu's (F64)."""
    from exp_tpu.basis.flatdisk import build_flatdisk_tables
    from exp_tpu.forces.cylinder import CylinderForce as JCyl
    from exp_tpu_torch.basis.flatdisk import \
        build_flatdisk_tables as t_tables
    from exp_tpu_torch.forces.cylinder import CylinderForce as TCyl

    kw = dict(mmax=4, nmax=6, model="expon", acyl=1.0, rcylmin=1e-3,
              rcylmax=20.0, numx=128, numy=64, knots=200, numk=128)
    ft = TCyl.from_tables(t_tables(**kw), dtype=F64T, device="cpu")
    fj = JCyl.from_tables(build_flatdisk_tables(**kw), dtype=jnp.float64)
    x, v, mass, normal = _tilted_disk(tilt=0.5)
    body, _ = T._axis_to_body(normal)

    def mpower(c):
        p = (np.asarray(c) ** 2).sum(axis=(0, 2))
        return p / p.sum()

    from exp_tpu_torch.nbody.multistep import rotate

    c_tilt = ft.coefficients(torch.as_tensor(x), torch.as_tensor(mass),
                             accum_dtype=F64T)
    c_rot = ft.coefficients(rotate(torch.as_tensor(x), torch.as_tensor(body)),
                            torch.as_tensor(mass), accum_dtype=F64T)
    close(c_rot.numpy(), np.asarray(fj.coefficients(
        jnp.asarray(x @ body.T), jnp.asarray(mass),
        accum_dtype=jnp.float64)), F64)
    p_tilt, p_rot = mpower(c_tilt), mpower(c_rot)
    assert p_rot[0] > 0.99
    assert p_rot[1:].sum() < 0.3 * p_tilt[1:].sum()


def test_orient_log_restart(tmp_path):
    """test_orient.py:103 — the port's orient log restores its tracker
    and exp_tpu's tracker alike, and exp_tpu's log the port's."""
    rng = np.random.default_rng(8)
    logs = {w: str(tmp_path / f"{w}.orient.disk") for w in "tj"}
    os_ = {"t": T.EJOrient(window=6, damp=1.0, logfile=logs["t"]),
           "j": J.EJOrient(window=6, damp=1.0, logfile=logs["j"])}
    for k in range(10):
        t = 0.05 * k
        c1 = np.array([0.2 * t, 0.0, 0.01]) + rng.normal(0, 1e-10, 3)
        a1 = np.array([np.sin(0.3), 0.0, np.cos(0.3)])
        for o in os_.values():
            o._push(t, c1, a1)
            o._refresh(t)
            o._log(t, c1, a1)
    assert open(logs["t"]).read() == open(logs["j"]).read()
    for src in "tj":
        for cls in (T.EJOrient, J.EJOrient):
            o2 = cls(window=6, damp=1.0, logfile=logs[src])
            o2.load_log()
            np.testing.assert_allclose(o2.center, os_["t"].center,
                                       atol=1e-10)
            np.testing.assert_allclose(o2.body, os_["t"].body, atol=1e-10)


def test_pseudoaccel_estimator():
    """test_orient.py:167 — the quadratic-LS frame acceleration, the same
    numbers as exp_tpu's."""
    g = np.array([0.3, -0.1, 0.05])
    pas = [T.PseudoAccel(nsize=5, center=True, axis=True),
           J.PseudoAccel(nsize=5, center=True, axis=True)]
    w = 0.2
    for k in range(5):
        t = 0.1 * k
        for pa in pas:
            assert np.all(pa()[0] == 0.0)
            pa.add(t, 0.5 * g * t * t,
                   np.array([np.sin(w * t), 0.0, np.cos(w * t)]))
    a, om, dom = pas[0]()
    np.testing.assert_allclose(a, g, rtol=1e-8)
    np.testing.assert_allclose(om, [0.0, w, 0.0], atol=5e-4)
    for u, q in zip(pas[0](), pas[1]()):
        np.testing.assert_array_equal(u, q)


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    from exp_tpu.basis.model import hernquist_model
    from exp_tpu.ic.eddington import sample_spherical_model
    from exp_tpu.nbody.particles import write_ascii_bodies

    d = tmp_path_factory.mktemp("ejrun")
    m = hernquist_model(rmin=1e-3, rmax=10.0)
    m.to_file(d / "halo.model")
    x, v, mass = sample_spherical_model(m, 2000, seed=13)
    write_ascii_bodies(d / "halo.bods", (x, v, mass))
    return d


EJ3 = """\
Global:
  dtime: 0.02
  nsteps: 6
  runtag: ej3
  compute_dtype: float64
Components:
  - name: halo
    bodyfile: halo.bods
    parameters: {EJ: 3, nEJkeep: 128, EJwindow: 4, nEJaccel: 3}
    force:
      id: sphereSL
      parameters: {numr: 600, Lmax: 2, nmax: 6, rmapping: 1.0,
                   modelname: halo.model}
Output:
  - id: outlog
    parameters: {nint: 2}
"""


def _state(sim):
    ps = sim._state["halo"]
    m = np.asarray(ps.mass)
    o = np.argsort(np.asarray(ps.indx)[m > 0])
    return np.asarray(ps.x)[m > 0][o], np.asarray(ps.v)[m > 0][o]


@pytest.mark.parametrize("multistep", [0, 1])
def test_simulation_ej_axis_flag(rundir, multistep):
    """test_orient.py:128 — EJ: 3 (AXIS|CENTER, with nEJaccel's frame
    correction) drives the center and the rotation into the step on both
    paths; the tracked center and rotation, the orient log (TEXT8), the
    final state (F64) and OUTLOG equal exp_tpu's; the rotation is
    orthonormal and the run finite."""
    txt = EJ3.replace("compute_dtype: float64", "compute_dtype: float64\n"
                      f"  multistep: {2 * multistep}")
    if multistep:
        # the frame correction of a 3-sample axis fit over 0.02-spaced
        # updates kicks every particle past the finest level in both
        # drivers; the multistep case tracks without it
        txt = txt.replace(", nEJaccel: 3", "")
    pj, pt = configs(rundir, f"ej3_{multistep}", txt)
    sj = JSim.from_file(pj, steps_per_block=2)
    st = TSim.from_file(pt, device="cpu", steps_per_block=2)
    for s in (sj, st):
        s.run()
    Rm = st._rots["halo"]
    np.testing.assert_allclose(Rm @ Rm.T, np.eye(3), atol=1e-10)
    assert not np.allclose(Rm, np.eye(3))
    close(Rm, np.asarray(sj._rots["halo"]), F64, floor=1e-12)
    close(st._centers["halo"], np.asarray(sj._centers["halo"]), F64)
    for a, b in zip(_state(st), _state(sj)):
        close(a, b, F64)
    ot = np.loadtxt(rundir / f"t_ej3_{multistep}" / "ej3.orient.halo")
    oj = np.loadtxt(rundir / f"j_ej3_{multistep}" / "ej3.orient.halo")
    assert ot.shape == oj.shape == (3 if not multistep else 6, 15)
    close(ot, oj, TEXT8, atol=1e-14)
    close(table(rundir / f"t_ej3_{multistep}" / "OUTLOG.ej3"),
          table(rundir / f"j_ej3_{multistep}" / "OUTLOG.ej3"), TEXT8,
          atol=1e-14)
    assert np.isfinite(_state(st)[0]).all()


def test_pseudo_collapses_uniform_field(rundir):
    """test_orient.py:191 — an equilibrium halo in a uniform external
    field, its expansion center on the free-fall trajectory of a
    centerfile: free fall without nEJaccel, the COM held with it; each run
    equals exp_tpu's (COM path to F64), a test field registered in both
    registries."""
    from exp_tpu.forces.external import ExternalField as JExt
    from exp_tpu.forces.external import register_external as jreg
    from exp_tpu_torch.forces.external import ExternalField as TExt
    from exp_tpu_torch.forces.external import register_external as treg

    gx, nstep, dt = 0.05, 40, 0.01

    class JUniformX(JExt):
        def acceleration(self, x, t):
            return jnp.zeros_like(x).at[:, 0].set(gx), -gx * x[:, 0]

    class TUniformX(TExt):
        def acceleration(self, x, t):
            acc = torch.zeros_like(x)
            acc[:, 0] = gx
            return acc, -gx * x[:, 0]

    jreg("test_uniform_x", JUniformX)
    treg("test_uniform_x", TUniformX)
    ts = np.arange(0, (nstep + 2) * dt, dt)
    np.savetxt(rundir / "ctr.dat",
               np.column_stack([ts, 0.5 * gx * ts * ts,
                                np.zeros_like(ts), np.zeros_like(ts)]))

    def com_path(naccel):
        txt = f"""\
Global: {{dtime: {dt}, nsteps: {nstep}, runtag: ps{naccel},
          compute_dtype: float64}}
Components:
  - name: halo
    bodyfile: halo.bods
    parameters: {{centerfile: ctr.dat, nEJaccel: {naccel}}}
    force:
      id: sphereSL
      parameters: {{numr: 600, Lmax: 2, nmax: 6, rmapping: 1.0,
                   modelname: halo.model}}
External:
  - id: test_uniform_x
Output: []
"""
        out = []
        for p, cls, kw in zip(configs(rundir, f"ps{naccel}", txt),
                              (JSim, TSim), ({}, {"device": "cpu"})):
            sim = cls.from_file(p, steps_per_block=1, **kw)
            sim.prime()
            coms = []
            for _ in range(nstep):
                sim.run(nsteps=1)
                d = sim._diag["halo"]
                coms.append(float(np.asarray(d["com"])[0])
                            / float(np.asarray(d["mass"])))
            out.append(np.array(coms))
        close(out[1], out[0], F64)
        return out[1]

    com_off, com_on = com_path(0), com_path(3)
    T_ = nstep * dt
    np.testing.assert_allclose(com_off[-1], 0.5 * gx * T_ * T_, rtol=0.1)
    assert abs(com_on[-1]) < 0.2 * abs(com_off[-1])
    tt = (np.arange(nstep) + 1) * dt
    np.testing.assert_allclose(2.0 * np.polyfit(tt, com_off, 2)[0], gx,
                               rtol=0.1)
    assert abs(2.0 * np.polyfit(tt[5:], com_on[5:], 2)[0]) < 0.05 * gx


def test_centerfile(rundir):
    """test_simulation.py:335 — the expansion center follows the file's
    trajectory (at the start of the last block), in both drivers; the
    state equals exp_tpu's (F64)."""
    np.savetxt(rundir / "ctr2.dat",
               np.array([[0.0, 0.0, 0.0, 0.0], [1.0, 0.5, -0.25, 0.1]]))
    txt = EJ3.replace("{EJ: 3, nEJkeep: 128, EJwindow: 4, nEJaccel: 3}",
                      "{centerfile: ctr2.dat}")
    sj, st = [cls.from_file(p, **kw) for p, cls, kw in zip(
        configs(rundir, "ctr", txt), (JSim, TSim), ({}, {"device": "cpu"}))]
    for s in (sj, st):
        s.prime()
        s.run(4)
    t_block = st.time - st.dt * st.steps_per_block
    np.testing.assert_allclose(
        st._centers["halo"], [0.5 * t_block, -0.25 * t_block, 0.1 * t_block],
        atol=1e-12)
    for a, b in zip(_state(st), _state(sj)):
        close(a, b, F64)
