"""The port's multistep integrator (exp_tpu_torch/nbody/multistep.py) against
exp_tpu's, on tests/test_multistep.py's setup (Hernquist, lmax 2, nmax 8,
numr 800, 4,000 particles, f64): the level tables, the two exactness gates
(all-finest == flat at dtime/2^M, all-coarsest == flat), adaptive energy
conservation, and the port's runner against the JAX runner on one mesh
device, particle by particle.

Both runners use the 'gather' SphereSL backend, whose f64 arithmetic is the
same in both packages (tests/test_torch_sphere_force.py holds it to 1e-12),
so a difference between the runs is the runner's, not the force's."""

import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.experimental.compilation_cache import compilation_cache
from threadpoolctl import threadpool_limits

from exp_tpu.basis.model import hernquist_model
from exp_tpu.basis.slgrid import build_sph_sl_tables
from exp_tpu.forces.spherical import SphereSL as JSphereSL
from exp_tpu.ic.eddington import sample_spherical_model
from exp_tpu.nbody.multistep import CompFeats as JCompFeats
from exp_tpu.nbody.multistep import MultistepRunner as JRunner
from exp_tpu.nbody.multistep import assign_levels as j_assign_levels
from exp_tpu.nbody.multistep import dtreq_fn as j_dtreq_fn
from exp_tpu.nbody.multistep import mfirst_of as j_mfirst_of
from exp_tpu.nbody.particles import ParticleSystem as JParticleSystem

from exp_tpu_torch.convert import buckets_from_numpy, sph_tables_from_numpy
from exp_tpu_torch.forces.spherical import SphereSL
from exp_tpu_torch.nbody.multistep import (CompFeats, LevelBuckets,
                                           MultistepRunner, assign_levels,
                                           bucketize, dtreq_fn,
                                           flatten_buckets, mfirst_of)
from exp_tpu_torch.nbody.particles import ParticleSystem
from exp_tpu_torch.nbody.step import energies, init_force_state, make_kdk_step


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


F64 = torch.float64
DYN = {"dynfracV": 0.01, "dynfracA": 0.03}
FIELDS = ("x", "v", "mass", "acc", "pot", "level", "indx", "scale")
# per-particle states and coefficients of the two runners: the same f64
# arithmetic summed in another order, ~1e-15 relative a step
RTOL = 1e-10


@pytest.fixture(scope="module")
def setup():
    m = hernquist_model(rmin=1e-4, rmax=20.0)
    t = build_sph_sl_tables(m, lmax=2, nmax=8, numr=800, cmap=1, rmap=1.0)
    tp = sph_tables_from_numpy(dataclasses.asdict(t))
    force = SphereSL.from_tables(tp, dtype=F64, backend="gather",
                                 device="cpu")
    x, v, mass = sample_spherical_model(m, 4000, seed=5)
    return t, force, x, v, mass


def _flat(x, v, mass):
    return ParticleSystem.from_arrays(x, v, mass, dtype=F64, device="cpu")


def _by_indx(bs):
    """Every field of the live rows of a component's buckets (either
    package's), ordered by particle identity."""
    f = {k: np.concatenate([np.asarray(getattr(b, k)) for b in bs])
         for k in FIELDS}
    live = f["mass"] > 0
    order = np.argsort(f["indx"][live], kind="stable")
    return {k: a[live][order] for k, a in f.items()}


def _close(a, b, what):
    scale = float(np.abs(b).max())
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def test_mfirst_and_level_tables():
    """tests/test_multistep.py:35-45's tables, and the port's functions
    against the JAX ones."""
    assert [mfirst_of(ms, 2) for ms in range(4)] == [0, 2, 1, 2]
    assert [mfirst_of(ms, 3) for ms in range(8)] == [0, 3, 2, 3, 1, 3, 2, 3]
    assert all(mfirst_of(ms, M) == j_mfirst_of(ms, M)
               for M in range(6) for ms in range(2 ** M))
    dtreq = np.asarray([1.0, 0.5, 0.09, 0.024, 1e-6])
    lev = assign_levels(torch.tensor(dtreq), torch.zeros(5, dtype=torch.int32),
                        dtime=0.1, M=3)
    assert lev.tolist() == [0, 0, 0, 2, 3] and lev.dtype == torch.int32
    rng = np.random.default_rng(1)
    d = 10.0 ** rng.uniform(-6, 0, 500)
    old = rng.integers(0, 5, 500).astype(np.int32)
    for shift in (0, 1):
        want = np.asarray(j_assign_levels(jnp.asarray(d), jnp.asarray(old),
                                          0.1, 4, shift))
        got = assign_levels(torch.tensor(d), torch.tensor(old), 0.1, 4,
                            shift).numpy()
        np.testing.assert_array_equal(got, want)


def _levels_forced(force, x, v, mass, M, level, runner):
    """A runner's state with every particle at `level`, bypassing the
    adaptive init (tests/test_multistep.py:59-77)."""
    ps = replace(_flat(x, v, mass),
                 level=torch.full((len(mass),), level, dtype=torch.int32))
    lb = bucketize(ps, M)
    runner.caps = {"c": lb.caps}
    return runner._init({"c": lb.buckets})


def _ms_run(force, x, v, mass, dtime, M, nbig, level):
    runner = MultistepRunner({"c": force}, {"c": ["c"]}, dtime, M,
                             accum_dtype=F64)
    st, regs, _, diag = _levels_forced(force, x, v, mass, M, level, runner)
    for _ in range(nbig):
        st, regs, _, diag = runner.bigstep(st, regs)
    return st, diag["c"]


def _flat_run(force, x, v, mass, dt, nsteps):
    ps, _, d = init_force_state(force, _flat(x, v, mass), accum_dtype=F64)
    step = make_kdk_step(force, dt, accum_dtype=F64)
    for _ in range(nsteps):
        ps, _, d = step(ps)
    return ps, d


def test_all_finest_equals_flat(setup):
    """All particles at level M == flat stepping at dtime/2^M
    (tests/test_multistep.py:80-99): Etot to rel 1e-10, positions to rtol
    1e-8 / atol 1e-10."""
    _, force, x, v, mass = setup
    M, dtime, nbig = 2, 0.08, 3
    st, diag = _ms_run(force, x, v, mass, dtime, M, nbig, M)
    ps, d = _flat_run(force, x, v, mass, dtime / 2 ** M, nbig * 2 ** M)
    assert energies(diag)["Etot"] == pytest.approx(energies(d)["Etot"],
                                                   rel=1e-10)
    fl = flatten_buckets(st["c"])
    xs = fl.x[fl.mass > 0].numpy()
    xr = ps.x.numpy()
    np.testing.assert_allclose(xs[np.lexsort(xs.T)], xr[np.lexsort(xr.T)],
                               rtol=1e-8, atol=1e-10)


def test_all_coarsest_equals_flat(setup):
    """All particles at level 0 == flat stepping at dtime
    (tests/test_multistep.py:102-109)."""
    _, force, x, v, mass = setup
    M, dtime, nbig = 2, 0.02, 5
    _, diag = _ms_run(force, x, v, mass, dtime, M, nbig, 0)
    _, d = _flat_run(force, x, v, mass, dtime, nbig)
    assert energies(diag)["Etot"] == pytest.approx(energies(d)["Etot"],
                                                   rel=1e-10)


def test_adaptive_energy_conservation(setup):
    """Adaptive levels: at least 2 levels used and |dE/E| < 5e-3 after 8
    big steps at M=3 (tests/test_multistep.py:112-128)."""
    _, force, x, v, mass = setup
    runner = MultistepRunner({"c": force}, {"c": ["c"]}, 0.08, 3,
                             accum_dtype=F64)
    st, regs, _, d0 = runner.init_state({"c": _flat(x, v, mass)})
    e0 = energies(d0["c"])
    for _ in range(8):
        st, regs, _, diag = runner.bigstep(st, regs)
        st, regs = runner.relevel(st, regs)
    counts = runner.level_counts(st)["c"]
    assert sum(counts) == 4000
    assert sum(1 for c in counts if c > 0) >= 2, counts
    e = energies(diag["c"])
    assert abs(e["Etot"] - e0["Etot"]) / abs(e0["Etot"]) < 5e-3


@pytest.fixture(scope="module")
def both_runs(setup):
    """init_state + 2 x (bigstep + relevel) through the JAX runner and the
    port's, M=2, dtime 2e-3, the composite's dynparams, cap_headroom=2;
    snapshots after each phase, and the JAX state after init_state as the
    port's to carry across."""
    t, force, x, v, mass = setup
    fj = JSphereSL.from_tables(t, dtype=jnp.float64, backend="gather")
    mesh = Mesh(np.array(jax.devices()[:1]), ("p",))
    jr = JRunner({"h": fj}, {"h": ["h"]}, 2e-3, 2, mesh,
                 accum_dtype=jnp.float64, dynparams=DYN, cap_headroom=2)
    pr = MultistepRunner({"h": force}, {"h": ["h"]}, 2e-3, 2,
                         accum_dtype=F64, dynparams=DYN, cap_headroom=2)
    js, jregs, _, _ = jr.init_state(
        {"h": JParticleSystem.from_arrays(x, v, mass, dtype=jnp.float64)})
    ps, pregs, _, _ = pr.init_state({"h": _flat(x, v, mass)})
    out = {"jr": jr, "pr": pr, "j_init": js, "j_regs_init": jregs,
           "init": (_by_indx(js["h"]), _by_indx(ps["h"]),
                    jr.level_counts(js), pr.level_counts(ps))}
    for k in range(2):
        js, jregs, jc, _ = jr.bigstep(js, jregs)
        ps, pregs, pc, _ = pr.bigstep(ps, pregs)
        if k == 0:
            out["j_big1"] = (_by_indx(js["h"]), np.asarray(jc["h"]))
        js, jregs = jr.relevel(js, jregs)
        ps, pregs = pr.relevel(ps, pregs)
    out["final"] = (_by_indx(js["h"]), _by_indx(ps["h"]),
                    jr.level_counts(js), pr.level_counts(ps),
                    np.asarray(jc["h"]), pc["h"].numpy())
    out["regs"] = ([np.asarray(c) for c in jregs["h"][1]],
                   [c.numpy() for c in pregs["h"][1]])
    return out


def _compare_states(j, p, counts_j, counts_p, what):
    assert counts_p == counts_j, (what, counts_j, counts_p)
    np.testing.assert_array_equal(p["indx"], j["indx"])
    bad = np.nonzero(p["level"] != j["level"])[0]
    if bad.size:
        jps = replace(JParticleSystem.from_arrays(j["x"], j["v"], j["mass"],
                                                  dtype=jnp.float64),
                      acc=jnp.asarray(j["acc"]), pot=jnp.asarray(j["pot"]))
        r = np.log2(2e-3 / np.asarray(j_dtreq_fn(jps, **DYN))[bad])
        pytest.fail(f"{what}: {bad.size} particles change level; their "
                    f"log2(dtime/dtreq) lie {np.abs(r - np.round(r))} from "
                    "a level boundary")
    for k in ("x", "v", "acc", "pot", "mass"):
        _close(p[k], j[k], f"{what}: {k}")


def test_runner_matches_jax_after_init(both_runs):
    j, p, cj, cp = both_runs["init"]
    _compare_states(j, p, cj, cp, "init_state")


def test_runner_matches_jax_after_two_bigsteps(both_runs):
    """Level counts exactly; x, v, acc, pot, level per particle and the
    assembled coefficients of the last substep to 1e-10; the registers the
    last relevel rebuilt likewise."""
    j, p, cj, cp, cfj, cfp = both_runs["final"]
    _compare_states(j, p, cj, cp, "2 x (bigstep + relevel)")
    _close(cfp, cfj, "coefficients")
    for a, b in zip(*reversed(both_runs["regs"])):
        _close(a, b, "registers")


def test_bigstep_from_carried_state(both_runs, setup):
    """One big step of the port from the JAX runner's state after
    init_state, carried across with convert.buckets_from_numpy, against
    the JAX runner's first big step."""
    _, force, _, _, _ = setup
    js, jregs = both_runs["j_init"], both_runs["j_regs_init"]
    st, regs = buckets_from_numpy(js["h"], jregs["h"], device="cpu")
    assert st[0].indx.dtype == torch.int32 and st[0].x.dtype == F64
    pr = MultistepRunner({"h": force}, {"h": ["h"]}, 2e-3, 2,
                         accum_dtype=F64, dynparams=DYN, cap_headroom=2)
    st, regs, coef, _ = pr.bigstep({"h": st}, {"h": regs})
    j, cj = both_runs["j_big1"]
    p = _by_indx(st["h"])
    for k in ("x", "v", "acc", "pot"):
        _close(p[k], j[k], f"carried state: {k}")
    _close(coef["h"].numpy(), cj, "carried state: coefficients")


# (features, tolerance): the rtrunc cutoff about the instantaneous COM of
# a sample moved off the origin at the runners' 1e-10; the adiabatic mass
# ramp at 1e-6, because the JAX runner passes t0 to its jitted substeps as
# float32, so its ramp factor carries f32 rounding (measured: acc and the
# coefficients 2.6e-8 from the port's f64 ramp after 2 big steps).
FEATURES = [({"rtrunc": 3.0, "com_system": True}, RTOL),
            ({"adiabatic": True, "ton": 0.001, "twid": 0.002}, 1e-6)]


@pytest.mark.parametrize("kw,tol", FEATURES, ids=["rtrunc-com", "adiabatic"])
def test_runner_features_match_jax(setup, kw, tol):
    """CompFeats' rtrunc, com_system and adiabatic through both runners:
    init_state + 2 x (bigstep + relevel), level counts exactly, x, v and acc
    per particle and the coefficients to `tol`."""
    t, force, x, v, mass = setup
    x = x + np.array([0.05, -0.02, 0.01])
    fj = JSphereSL.from_tables(t, dtype=jnp.float64, backend="gather")
    mesh = Mesh(np.array(jax.devices()[:1]), ("p",))
    jr = JRunner({"h": fj}, {"h": ["h"]}, 2e-3, 2, mesh,
                 accum_dtype=jnp.float64, dynparams=DYN, cap_headroom=2,
                 feats={"h": JCompFeats(**kw)})
    pr = MultistepRunner({"h": force}, {"h": ["h"]}, 2e-3, 2, accum_dtype=F64,
                         dynparams=DYN, cap_headroom=2,
                         feats={"h": CompFeats(**kw)})
    js, jregs, _, _ = jr.init_state(
        {"h": JParticleSystem.from_arrays(x, v, mass, dtype=jnp.float64)})
    ps, pregs, _, _ = pr.init_state({"h": _flat(x, v, mass)})
    for _ in range(2):
        js, jregs, jc, _ = jr.bigstep(js, jregs)
        ps, pregs, pc, _ = pr.bigstep(ps, pregs)
        js, jregs = jr.relevel(js, jregs)
        ps, pregs = pr.relevel(ps, pregs)
    assert pr.level_counts(ps) == jr.level_counts(js)
    j, p = _by_indx(js["h"]), _by_indx(ps["h"])
    np.testing.assert_array_equal(p["level"], j["level"])
    cj = np.asarray(jc["h"])
    print(kw, {k: float(np.abs(p[k] - j[k]).max() / np.abs(j[k]).max())
               for k in ("x", "v", "acc")}, "coefficients",
          float(np.abs(pc["h"].numpy() - cj).max() / np.abs(cj).max()))
    for k in ("x", "v", "acc"):
        scale = float(np.abs(j[k]).max())
        np.testing.assert_allclose(p[k], j[k], rtol=tol, atol=tol * scale,
                                   err_msg=k)
    np.testing.assert_allclose(pc["h"].numpy(), cj, rtol=tol,
                               atol=tol * float(np.abs(cj).max()))


def _run(force, x, v, mass, nbig=2, **kw):
    r = MultistepRunner({"h": force}, {"h": ["h"]}, 2e-3, 2, accum_dtype=F64,
                        dynparams=DYN, cap_headroom=2, **kw)
    st, regs, coef, _ = r.init_state({"h": _flat(x, v, mass)})
    for _ in range(nbig):
        st, regs, coef, _ = r.bigstep(st, regs)
        st, regs = r.relevel(st, regs)
    return st, coef


def _equal(a, b):
    for ba, bb in zip(a["h"], b["h"]):
        for f in FIELDS:
            va, vb = getattr(ba, f), getattr(bb, f)
            assert va.dtype == vb.dtype and torch.equal(va, vb), f


def test_rebucket_styles_bit_exact(setup):
    """'sortfull' and 'sortgather' give the same state bit for bit
    (tests/test_multistep.py:166-190); 'incremental' is refused."""
    _, force, x, v, mass = setup
    a, _ = _run(force, x, v, mass, rebucket_style="sortfull")
    b, _ = _run(force, x, v, mass, rebucket_style="sortgather")
    _equal(a, b)
    with pytest.raises(NotImplementedError, match="incremental"):
        MultistepRunner({"h": force}, {"h": ["h"]}, 2e-3, 2,
                        rebucket_style="incremental")
    with pytest.raises(ValueError, match="rebucket_style"):
        MultistepRunner({"h": force}, {"h": ["h"]}, 2e-3, 2,
                        rebucket_style="other")


def test_fused_bit_exact(setup):
    """fused=True runs the same eager loop: the same state and
    coefficients bit for bit."""
    _, force, x, v, mass = setup
    a, ca = _run(force, x, v, mass, fused=False)
    b, cb = _run(force, x, v, mass, fused=True)
    _equal(a, b)
    assert torch.equal(ca["h"], cb["h"])


def test_dts_scale_criterion():
    """The dts criterion (tests/test_multistep.py:259-285; the body-file
    ingest is ROADMAP item 10), against the JAX dtreq_fn."""
    n = 4
    ps = ParticleSystem.from_arrays(
        np.zeros((n, 3)), np.tile([2.0, 0.0, 0.0], (n, 1)), np.ones(n),
        dtype=F64, scale=[-1.0, 0.0, 0.1, 40.0], device="cpu")
    ps.acc = torch.tensor([[0.1, 0.0, 0.0]] * n, dtype=F64)
    ps.pot = torch.full((n,), -1.0, dtype=F64)
    dt = dtreq_fn(ps).numpy()
    np.testing.assert_allclose(dt, [0.15, 0.15, 0.05, 0.15], rtol=1e-6)
    np.testing.assert_allclose(dtreq_fn(ps, dynfracS=0.5)[2], 0.025,
                               rtol=1e-6)
    jps = replace(JParticleSystem.from_arrays(
        np.zeros((n, 3)), np.tile([2.0, 0.0, 0.0], (n, 1)), np.ones(n),
        dtype=jnp.float64, scale=[-1.0, 0.0, 0.1, 40.0]),
        acc=jnp.tile(jnp.asarray([0.1, 0.0, 0.0]), (n, 1)),
        pot=jnp.full(n, -1.0))
    for kw in ({}, {"dynfracS": 0.5}):
        np.testing.assert_array_equal(dtreq_fn(ps, **kw).numpy(),
                                      np.asarray(j_dtreq_fn(jps, **kw)))


def _live_indx(st):
    return np.sort(np.concatenate([b.indx[b.mass > 0].numpy()
                                   for bs in st.values() for b in bs]))


def test_indx_stays_int32_and_overflow_falls_back(setup):
    """Every particle at level 0 with tight pow2 capacities: the first
    relevel overflows the finer buckets and takes the fallback, which grows
    the capacities and loses nobody; indx and level stay int32 through
    init, big steps, the fast relevel and the fallback."""
    _, force, x, v, mass = setup
    r = MultistepRunner({"c": force}, {"c": ["c"]}, 2e-3, 2, accum_dtype=F64,
                        dynparams=DYN)
    st, regs, _, _ = _levels_forced(force, x, v, mass, 2, 0, r)
    caps0 = r.caps["c"]
    ids0 = _live_indx(st)
    for k in range(3):
        st, regs, _, _ = r.bigstep(st, regs)
        st, regs = r.relevel(st, regs)
        assert all(b.indx.dtype == torch.int32 and b.level.dtype == torch.int32
                   for b in st["c"])
        np.testing.assert_array_equal(_live_indx(st), ids0)
        assert LevelBuckets(st["c"], r.caps["c"]).n_live == len(mass)
        if k == 0:
            assert r.n_fallbacks == 1 and r.n_rebuilds == 1
            assert any(c > c0 for c, c0 in zip(r.caps["c"], caps0))
    assert r._caps_sig(st) == (("c", r.caps["c"]),)
    assert r.overrun["c"][2] == len(mass)


def test_unported_features_raise(setup):
    """The incremental rebucket (item 9b.2) raises; external fields,
    position wrappers and the playback/Hall/restriction/pseudo extras are
    accepted (item 10b)."""
    from exp_tpu_torch.forces.external import PeriodicBC, UserLogPot

    _, force, x, v, mass = setup

    with pytest.raises(NotImplementedError, match="item 9b.2"):
        MultistepRunner({"h": force}, {"h": ["h"]}, 2e-3, 2,
                        rebucket_style="incremental")
    r = MultistepRunner({"h": force}, {"h": ["h"]}, 2e-3, 2,
                        externals=(UserLogPot(),),
                        wrappers=(PeriodicBC(L=100.0, btype="vvv"),))
    assert len(r.externals) == 1 and len(r.wrappers) == 1
    pb = force.coefficients(_flat(x, v, mass).x, _flat(x, v, mass).mass,
                            accum_dtype=F64)
    z3 = torch.zeros(3, dtype=F64)
    st, regs, coef, _ = r.init_state(
        {"h": _flat(x, v, mass)},
        extras_fn=lambda t: {"playback": {"h": pb}, "hall": {},
                             "restrict": {}, "pseudo": {"h": (z3, z3, z3)}})
    assert torch.equal(coef["h"], pb)
    st, regs, coef, _ = r.bigstep(st, regs, 0.0, extras_fn=lambda t: {
        "playback": {"h": pb}, "hall": {"h": torch.ones_like(pb)},
        "restrict": {"h": (torch.ones_like(pb), torch.zeros_like(pb))}})
    assert torch.equal(coef["h"], pb)
    assert all(torch.isfinite(b.x).all() for b in st["h"])
