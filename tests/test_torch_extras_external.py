"""The port's External stanza (forces/external.py, ic/ellipsoid.py) against
exp_tpu's: each field's potential and acceleration at seeded points
(torch.autograd against jax.grad), the host operators' draws and files,
PeriodicBC, and the fields in both drivers on the same YAML — the flows of
tests/test_more_forces.py:95-300, tests/test_ellipsoid.py:99-150,
tests/test_slab.py:141 and tests/test_simulation.py:482.

Tolerances: potentials and accelerations of f64 points to 1e-12 relative
to the largest value (the same arithmetic in another order); driver runs
in f64 to F64 = 1e-10 relative, OUTLOG to its printed digits (TEXT8).
Test points keep off the clip edges of UserDisk's table and UserHalo's
radial range (where torch.clamp and jnp.clip pass different gradients)
and off the z axis (UserBar's arctan2 is singular there in both).
"""


import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

import jax.numpy as jnp
from exp_tpu.basis.model import hernquist_model
from exp_tpu.forces import external as J
from exp_tpu.ic.eddington import sample_spherical_model
from exp_tpu.nbody.particles import write_ascii_bodies
from exp_tpu.nbody.simulation import Simulation as JSim
from exp_tpu_torch.forces import external as T
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
FIELD = 1e-12

FIELDS = {
    "userlogpot": ("UserLogPot", dict(v0=1.2, q=0.8, rc=0.2)),
    "usermndisk": ("UserMNdisk", dict(a=1.0, b=0.2, mass=2.0)),
    "userbar": ("UserBar", dict(amplitude=0.05, length=0.5, omega=2.0,
                                Ton=1.0)),
    "tidalField": ("TidalField", dict(txx=0.1, tyy=-0.05, tzz=0.2)),
    "usermw": ("UserMW", {}),
    "externalShock": ("ExternalShock", dict(AMPL=0.3, PER=0.4, T0=1.0)),
    "userdisk": ("UserDisk", dict(a=1.0, mass=1.0)),
    "userellipsoid": ("UserEllipsoid", dict(mass=0.2, omega=1.0,
                                            Ton=-1e9)),
    "ellipsoid_powerlaw": ("UserEllipsoid", dict(bartype="powerlaw",
                                                 param=1.0)),
    "ellipsoid_expon": ("UserEllipsoid", dict(bartype="expon",
                                              param=0.5)),
}


def _points(n=32, seed=3):
    x = np.random.default_rng(seed).normal(0, 1, (n, 3))
    x[:, :2] += 0.05            # off the z axis
    return x


@pytest.mark.parametrize("case", list(FIELDS))
def test_external_autodiff(case):
    """Each field at seeded points (half inside the ellipsoids' semi-axes):
    the port's potential and torch.autograd acceleration equal exp_tpu's
    jax.grad (FIELD), and the acceleration is -grad Phi by central
    differences (the JAX test's rtol 2e-3)."""
    cls, kw = FIELDS[case]
    if cls == "UserDisk":
        jf = J.UserDisk(dtype=jnp.float64, **kw)
        tf = T.UserDisk(dtype=F64T, **kw)
    else:
        jf, tf = getattr(J, cls)(**kw), getattr(T, cls)(**kw)
    x = _points()
    x[:16] *= 0.2
    t = 1.7
    aj, pj = jf.acceleration(jnp.asarray(x), t)
    at, pt = tf.acceleration(torch.as_tensor(x), t)
    close(at.numpy(), np.asarray(aj), 0.0, floor=FIELD)
    close(pt.numpy(), np.asarray(pj), 0.0, floor=FIELD)
    h = 1e-5
    dx = np.zeros_like(x)
    dx[:, 1] = h
    num = -(tf.potential(torch.as_tensor(x + dx), t)
            - tf.potential(torch.as_tensor(x - dx), t)).numpy() / (2 * h)
    np.testing.assert_allclose(at.numpy()[:, 1], num, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("case", list(FIELDS) + ["userhalo"])
def test_external_finite_at_origin_and_axis(case, tmp_path):
    """Every field's force and potential are finite at x = 0 and on the z
    axis, where the zero-mass padding rows of a world and the multistep
    buckets' holes sit.  exp_tpu's UserBar, UserMW and UserDisk give NaN
    there (the gradient of atan2(y, x) or sqrt(r2) at 0; ROADMAP §3); the
    port's are written so that the gradient is finite, and on the z axis
    the force of each axisymmetric field and of the bar has no x or y
    component.  Where exp_tpu's value is finite the port's equals it
    (FIELD); off the axis test_external_autodiff holds them equal."""
    if case == "userhalo":
        m = hernquist_model(rmin=1e-3, rmax=20.0, numr=800)
        m.to_file(tmp_path / "h.model")
        conf = {"id": "userhalo", "parameters": {"modelname": "h.model"}}
        jf = J.build_external(conf, workdir=str(tmp_path), dtype=jnp.float64)
        tf = T.build_external(conf, workdir=str(tmp_path), dtype=F64T)
    else:
        cls, kw = FIELDS[case]
        if cls == "UserDisk":
            jf = J.UserDisk(dtype=jnp.float64, **kw)
            tf = T.UserDisk(dtype=F64T, **kw)
        else:
            jf, tf = getattr(J, cls)(**kw), getattr(T, cls)(**kw)
    x = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.3], [0.0, 0.0, -0.3],
                  [0.0, 0.0, 1.5], [0.0, 0.0, -4.0]])
    for t in (0.0, 1.7):
        at, pt = tf.acceleration(torch.as_tensor(x), t)
        at, pt = at.numpy(), pt.numpy()
        assert np.isfinite(at).all() and np.isfinite(pt).all(), (case, t)
        if not case.startswith(("userellipsoid", "ellipsoid")):
            assert np.all(at[:, :2] == 0.0), (case, at)
        aj, pj = (np.asarray(u) for u in jf.acceleration(jnp.asarray(x), t))
        ok = np.isfinite(aj).all(axis=1)
        if ok.any():
            close(at[ok], aj[ok], 0.0, floor=FIELD, atol=1e-300)
        close(pt, pj, 0.0, floor=FIELD, atol=1e-300)


def test_userhalo_from_model(tmp_path):
    """build_external's userhalo from a model file: the closed-form M(r)/r^2
    and the interpolated potential equal exp_tpu's inside the table and
    beyond it (the Keplerian continuation)."""
    m = hernquist_model(rmin=1e-3, rmax=20.0, numr=800)
    m.to_file(tmp_path / "h.model")
    conf = {"id": "userhalo", "parameters": {"modelname": "h.model"}}
    jf = J.build_external(conf, workdir=str(tmp_path), dtype=jnp.float64)
    tf = T.build_external(conf, workdir=str(tmp_path), dtype=F64T)
    assert isinstance(tf, T.UserHalo)
    x = np.concatenate([_points(), 30.0 * _points(8, seed=4)])
    aj, pj = jf.acceleration(jnp.asarray(x), 0.0)
    at, pt = tf.acceleration(torch.as_tensor(x), 0.0)
    close(at.numpy(), np.asarray(aj), 0.0, floor=FIELD)
    close(pt.numpy(), np.asarray(pj), 0.0, floor=FIELD)
    r = np.linalg.norm(x[-8:], axis=1)
    np.testing.assert_allclose(pt.numpy()[-8:], -m.mass[-1] / r, rtol=1e-6)


@pytest.mark.parametrize("bartype,param", [("powerlaw", 1.0),
                                           ("ferrers", 2.0),
                                           ("expon", 0.5)])
def test_ellipsoid_force(bartype, param):
    """EllipsoidForce's potential, lambda solve and autograd force equal
    exp_tpu's (FIELD) inside and outside the ellipsoid."""
    from exp_tpu.ic.ellipsoid import EllipsoidForce as JE
    from exp_tpu_torch.ic.ellipsoid import EllipsoidForce as TE

    kw = dict(a=(1.0, 0.6, 0.3), mass=1.0, bartype=bartype, param=param)
    x = np.concatenate([0.3 * _points(16), 2.0 * _points(16, seed=5)])
    aj, pj = JE(**kw).acceleration(jnp.asarray(x))
    at, pt = TE(**kw).acceleration(torch.as_tensor(x))
    close(at.numpy(), np.asarray(aj), 0.0, floor=FIELD)
    close(pt.numpy(), np.asarray(pj), 0.0, floor=FIELD)
    lt = TE(**kw)._lambda(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(lt, np.asarray(JE(**kw)._lambda(
        jnp.asarray(x))), rtol=1e-12, atol=1e-14)
    assert (lt[:16] == 0).any() and (lt[16:] > 0).all()


def test_user_ellipsoid_external():
    """test_ellipsoid.py:99 — the pattern rotates: after a quarter turn
    the major axis lies along y; build_external's id."""
    ue = T.UserEllipsoid(a=(0.5, 0.25, 0.125), mass=0.1, omega=2.0,
                         Ton=-1e9)
    x = torch.tensor([[0.4, 0.0, 0.0]], dtype=F64T)
    p0 = float(ue.potential(x, 0.0)[0])
    pq = float(ue.potential(x, (np.pi / 2) / 2.0)[0])
    py0 = float(ue.potential(torch.tensor([[0.0, 0.4, 0.0]],
                                          dtype=F64T), 0.0)[0])
    np.testing.assert_allclose(pq, py0, rtol=1e-5)
    assert p0 < pq
    assert torch.isfinite(ue.acceleration(x, 0.0)[0]).all()
    f = T.build_external({"id": "userellipsoid",
                          "parameters": {"mass": 0.1, "omega": 2.0}})
    assert isinstance(f, T.UserEllipsoid)


def test_mn_disk_circular_speed():
    """test_more_forces.py:115 — vc^2(R) = M R^2/(R^2+(a+b)^2)^{3/2}."""
    ext = T.UserMNdisk(a=1.0, b=0.2, mass=1.0)
    R = np.array([0.5, 1.0, 3.0])
    acc, _ = ext.acceleration(torch.as_tensor(
        np.stack([R, 0 * R, 0 * R], -1)), 0.0)
    np.testing.assert_allclose(-acc.numpy()[:, 0] * R,
                               R ** 2 / (R ** 2 + 1.2 ** 2) ** 1.5,
                               rtol=1e-5)


def test_periodic_bc_wrap():
    """PeriodicBC.wrap: torch.remainder's floor-mod and the reflect fold
    equal jnp.mod's, bit for bit; 'v' leaves the axis untouched."""
    x = 3.0 * np.random.default_rng(6).normal(size=(500, 3))
    for bt in ("ppp", "rrv", "prv"):
        pj = J.PeriodicBC(L=1.3, sy=0.7, btype=bt)
        pt = T.PeriodicBC(L=1.3, sy=0.7, btype=bt)
        np.testing.assert_array_equal(pt.wrap(torch.as_tensor(x)).numpy(),
                                      np.asarray(pj.wrap(jnp.asarray(x))))


def _state(sim, name):
    ps = sim._state[name]
    m = np.asarray(ps.mass)
    o = np.argsort(np.asarray(ps.indx)[m > 0])
    return np.asarray(ps.x)[m > 0][o], np.asarray(ps.v)[m > 0][o]


def _both(d, tag, txt, spb=None, prime=True, nsteps=None):
    pj, pt = configs(d, tag, txt)
    sj = JSim.from_file(pj, steps_per_block=spb)
    st = TSim.from_file(pt, device="cpu", steps_per_block=spb)
    for s in (sj, st):
        if prime:
            s.prime()
        s.run(nsteps)
    return sj, st


def test_external_in_driver(tmp_path):
    """test_more_forces.py:126 — test particles on circular orbits in a
    fixed MN disk through the External stanza: the radius holds (1e-3)
    and the orbits equal exp_tpu's (F64)."""
    vc = np.sqrt(1.0 / (1 + 1.2 ** 2) ** 1.5)
    x = np.array([[1.0, 0, 0], [0, 1.0, 0]])
    v = np.array([[0, vc, 0], [-vc, 0, 0]])
    write_ascii_bodies(tmp_path / "t.bods", (x, v, np.array([1e-10, 1e-10])))
    txt = """\
Global:
  dtime: 0.02
  nsteps: 100
  runtag: ext0
  compute_dtype: float64
Components:
  - name: test
    bodyfile: t.bods
    force: {id: noforce, parameters: {}}
Output:
  - id: outlog
    parameters: {nint: 50}
External:
  - id: usermndisk
    parameters: {a: 1.0, b: 0.2, mass: 1.0}
"""
    sj, st = _both(tmp_path, "mn", txt)
    xf = _state(st, "test")[0]
    np.testing.assert_allclose(np.linalg.norm(xf[:, :2], axis=1), 1.0,
                               rtol=1e-3)
    for a, b in zip(_state(st, "test"), _state(sj, "test")):
        close(a, b, F64)


@pytest.fixture(scope="module")
def halodir(tmp_path_factory):
    d = tmp_path_factory.mktemp("exthalo")
    m = hernquist_model(rmin=1e-3, rmax=20.0)
    x, v, mass = sample_spherical_model(m, 1200, seed=9)
    write_ascii_bodies(d / "h.bods", (x, v, mass))
    np.savetxt(d / "ctr.dat", np.array([[0.0, 0.0, 0.0, 0.0],
                                        [1.0, 0.3, -0.2, 0.1]]))
    return d


HALO = """\
Global:
  dtime: 0.02
  nsteps: 3
  runtag: ebar
  compute_dtype: float64
  multistep: {M}
  maxMindt: 0.5
Components:
  - name: halo
    bodyfile: h.bods
    parameters: {PARAMS}
    force:
      id: sphereSL
      parameters: {lmax: 1, nmax: 4, modelname: hernquist}
External:
{EXT}Output:
  - id: outlog
    parameters: {nint: 1}
"""

EXTS = {
    "userellipsoid": ("  - id: userellipsoid\n    parameters: {a: [0.5, "
                      "0.25, 0.125], mass: 0.2, omega: 1.0, Ton: -1.0e+9}\n"),
    "userdisk": "  - id: userdisk\n    parameters: {a: 0.5, mass: 0.2}\n",
    "userbar": ("  - id: userbar\n    parameters: {amplitude: 0.1, "
                "length: 0.5, omega: 1.0, Ton: 0.0, DeltaT: 0.5}\n"),
    "usermw": "  - id: usermw\n",
    "userlogpot_ms": "  - id: userlogpot\n",
    "periodic_ms": "  - id: periodicBC\n    parameters: {L: 6.0}\n",
    "centerfile_ms": "  - id: usermndisk\n",
}


@pytest.mark.parametrize("case", list(EXTS))
def test_fields_in_run(halodir, case):
    """test_ellipsoid.py:119 and test_simulation.py:482 — a halo run with
    an external field through the YAML stanza, equal to exp_tpu's (state
    F64, OUTLOG TEXT8) and finite.  The _ms cases run under multistep
    (M = 2): a time-independent field, since exp_tpu's runner takes its
    big step's start time in float32 and a time-dependent field would
    differ from the port's f64 time at 1e-8; PeriodicBC's wrap after each
    drift; a centerfile with nEJaccel's frame correction."""
    ms = 2 if case.endswith("_ms") else 0
    params = ("{centerfile: ctr.dat, nEJaccel: 3}"
              if case == "centerfile_ms" else "{}")
    txt = HALO.replace("{M}", str(ms)).replace("{EXT}", EXTS[case]).replace(
        "{PARAMS}", params)
    sj, st = _both(halodir, case, txt, prime=not ms)
    for a, b in zip(_state(st, "halo"), _state(sj, "halo")):
        close(a, b, F64)
    lt = table(halodir / f"t_{case}" / "OUTLOG.ebar")
    close(lt, table(halodir / f"j_{case}" / "OUTLOG.ebar"), TEXT8,
          atol=1e-14)
    assert lt.shape[0] == 4 and np.isfinite(lt).all()
    if case == "periodic_ms":
        x = _state(st, "halo")[0]
        assert (x >= 0).all() and (x < 6.0).all()


def test_periodic_bc_slab(tmp_path):
    """test_slab.py:141 — a sheet under slabSL with PeriodicBC ppv: the
    thickness holds within 40% over 40 steps, and the state equals
    exp_tpu's (F64)."""
    from exp_tpu.cli.genslab import main as genslab

    genslab(["-N", "4000", "-o", str(tmp_path / "s.bods"), "--z0", "0.02",
             "-s", "2"])
    txt = """\
Global:
  dtime: 0.005
  nsteps: 40
  runtag: slab0
  compute_dtype: float64
Components:
  - name: slab
    bodyfile: s.bods
    force:
      id: slabSL
      parameters: {nmaxx: 2, nmaxy: 2, nmaxz: 6, zmax: 0.12, hslab: 0.02}
Output:
  - id: outlog
    parameters: {nint: 20}
External:
  - id: periodicBC
    parameters: {L: 1.0, btype: ppv}
"""
    pj, pt = configs(tmp_path, "sl", txt)
    sj, st = JSim.from_file(pj), TSim.from_file(pt, device="cpu")
    for s in (sj, st):
        s.prime()
    z0 = _state(st, "slab")[0][:, 2]
    for s in (sj, st):
        s.run()
    z1 = _state(st, "slab")[0][:, 2]
    rms0, rms1 = np.sqrt((z0 ** 2).mean()), np.sqrt((z1 ** 2).mean())
    assert 0.6 * rms0 < rms1 < 1.6 * rms0
    for a, b in zip(_state(st, "slab"), _state(sj, "slab")):
        close(a, b, F64)
    xy = _state(st, "slab")[0][:, :2]
    assert (xy >= 0).all() and (xy < 1.0).all()


def test_operators_in_driver(tmp_path):
    """test_more_forces.py:266 — scatterMFP (seeded) scatters the same
    rows to the same velocities as exp_tpu's (F64) and keeps the speeds;
    generateRelaxation writes the same .relx file."""
    rng = np.random.default_rng(7)
    n = 200
    write_ascii_bodies(tmp_path / "s.bods",
                       (rng.normal(0, 0.5, (n, 3)), rng.normal(0, 0.3, (n, 3)),
                        np.full(n, 1.0 / n)))
    txt = """\
Global:
  dtime: 0.01
  nsteps: 6
  runtag: scat0
  compute_dtype: float64
Components:
  - name: gas
    bodyfile: s.bods
    force: {id: noforce, parameters: {}}
Output:
  - id: outlog
    parameters: {nint: 3}
External:
  - id: scatterMFP
    parameters: {tau: 0.02, rmax: 4.0, seed: 2}
  - id: generateRelaxation
    parameters: {}
"""
    pj, pt = configs(tmp_path, "op", txt)
    sj, st = JSim.from_file(pj), TSim.from_file(pt, device="cpu")
    for s in (sj, st):
        s.prime()
    speeds0 = np.sort(np.linalg.norm(_state(st, "gas")[1], axis=1))
    for s in (sj, st):
        s.run()
    op = st.operators[0]
    assert op.nscattered > 0 and op.nscattered == sj.operators[0].nscattered
    np.testing.assert_allclose(
        np.sort(np.linalg.norm(_state(st, "gas")[1], axis=1)), speeds0,
        rtol=1e-6)
    for a, b in zip(_state(st, "gas"), _state(sj, "gas")):
        close(a, b, F64)
    rt = (tmp_path / "t_op" / "scat0.relx").read_text().splitlines()
    rj = (tmp_path / "j_op" / "scat0.relx").read_text().splitlines()
    assert len(rt) == len(rj) >= 2 and not rt[-1].startswith("#")
    for a, b in zip(rt[1:], rj[1:]):
        ta, tb = a.split(), b.split()
        assert ta[1] == tb[1]
        np.testing.assert_allclose([float(v) for v in ta[::2]],
                                   [float(v) for v in tb[::2]], rtol=1e-5)
