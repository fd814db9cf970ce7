"""The port's multi-device runs (exp_tpu_torch/parallel/, ROADMAP item 12)
on the CPU: worlds of two ranks over gloo, each rank a process.  The
shared worlds, launchers and configs are in tests/torch_world.py; the
driver's runs against exp_tpu's and the extras cases are in
tests/test_torch_distributed_*.py, so that the test workers share them.

* row_block, pad_global_count and ps_from_local partition as exp_tpu's do
  (tests/test_distributed.py:127).
* A 2-rank world's coefficients equal one rank's to 1e-12 (f64) for the
  sphere, the cylinder, the cube, the slab, shells and twocenter, and the
  direct force's ring equals the one-rank sum: the analogue of
  tests/test_spherical_force.py:129-154.  The SL, EOF and slab tables are
  built on rank 0 and broadcast.
* The 2-rank KDK step against exp_tpu's single-process run on its 8-device
  mesh, tests/test_distributed.py:83-124's analogue at its tolerances.
* The sharded body read against the whole read, and the helpers on a
  one-rank world without a process group.
* What a world ran only on one rank before (ROADMAP item 12b): both host
  operators, the adaptive sphereSL rebuild and the writers OutAscii,
  OrbTrace, OutDiag, OutFrac, OutCalbr, OutHDF5 and OutVel under
  `run.py --ndev 2`, single-rate and at multistep 2, on a body count the
  world pads, against the port's one-rank run: every file to 1e-10 (f64),
  OutVel's f32 sums to 2e-5 of each dataset's largest value."""

import os

import numpy as np
import pytest
import torch
from torch_world import (EXTRAS_CONFIG, F64, LAUNCHES, SPHERE, USERBAR,
                         WORLD_CONFIG, WORLD_N, _h5_sets, _hernquist_bodies,
                         _launch, _spawn, one_cpu_thread)  # noqa: F401


@pytest.fixture(scope="module")
def coef_world(tmp_path_factory):
    return _spawn("coef", str(tmp_path_factory.mktemp("coef") / "c.npz"))


@pytest.mark.parametrize("name", ["sphere", "cylinder", "cube", "slab",
                                  "shells", "twocenter", "direct"])
def test_two_rank_coefficients_equal_one_rank(coef_world, name):
    """A 2-rank world's coefficients (the direct force: its ring's
    acceleration and potential) equal one rank's to 1e-12 of their
    scale: the same f64 sums split in two."""
    keys = sorted(k[:-2] for k in coef_world
                  if k.startswith(name) and k.endswith("_1"))
    assert keys
    for k in keys:
        c2, c1 = coef_world[k + "_2"], coef_world[k + "_1"]
        assert c2.shape == c1.shape and np.abs(c1).max() > 0
        np.testing.assert_allclose(c2, c1, rtol=1e-12,
                                   atol=1e-12 * np.abs(c1).max(), err_msg=k)



# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(1000, 8), (1001, 8), (7, 2), (3, 4)])
def test_row_block_partition(n, k):
    """pad_global_count and row_block give each rank of k the rows exp_tpu
    gives each of k devices (its shard slices), and ps_from_local's blocks
    concatenate to exp_tpu's global ParticleSystem: the same rows, the
    1-based global identities, indx 0 on the zero-mass padding rows."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from exp_tpu.parallel import particle_sharding
    from exp_tpu.parallel.distributed import pad_global_count as j_pad
    from exp_tpu.parallel.distributed import ps_from_local as j_ps
    from exp_tpu_torch.parallel.distributed import (World, pad_global_count,
                                                    ps_from_local, row_block)

    mesh = Mesh(np.array(jax.devices()[:k]), ("p",))
    ng = pad_global_count(n, World(size=k))
    assert ng == j_pad(n, mesh)
    imap = particle_sharding(mesh, ndim=1).devices_indices_map((ng,))
    spans = [(s[0].start or 0, ng if s[0].stop is None else s[0].stop)
             for s in (imap[d] for d in mesh.devices.flat)]
    rng = np.random.default_rng(n)
    x, v = rng.normal(size=(ng, 3)), rng.normal(size=(ng, 3))
    mass = np.where(np.arange(ng) < n, rng.uniform(0.5, 1.5, ng), 0.0)
    ref = j_ps(x, v, mass, mesh, ng, 0, dtype=jnp.float64)
    parts = []
    for r in range(k):
        w = World(rank=r, size=k)
        lo, hi = row_block(ng, w)
        assert (lo, hi) == spans[r]
        parts.append(ps_from_local(x[lo:hi], v[lo:hi], mass[lo:hi], w, ng,
                                   lo, dtype=F64))
    for f in ("x", "v", "mass", "indx", "scale"):
        got = np.concatenate([getattr(p, f).numpy() for p in parts])
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, f)), f)




def test_two_rank_kdk_matches_single_process(tmp_path):
    """tests/test_distributed.py:83-124 on the port: 2 ranks x 2,048 rows
    against exp_tpu's single-process run on its 8-device mesh, the
    coefficient trajectory to 1e-12 of its scale and the phase space to
    1e-12, the same rows in the same global order."""
    import jax.numpy as jnp

    from exp_tpu.basis.model import hernquist_model
    from exp_tpu.basis.slgrid import build_sph_sl_tables
    from exp_tpu.forces.spherical import SphereSL as JSphereSL
    from exp_tpu.nbody.particles import ParticleSystem as JPS
    from exp_tpu.nbody.step import init_force_state, make_kdk_step
    from exp_tpu.parallel import particle_mesh

    z = _spawn("kdk", str(tmp_path / "kdk.npz"))
    m = hernquist_model(rmin=1e-3, rmax=20.0)
    t = build_sph_sl_tables(m, lmax=2, nmax=6, numr=400, cmap=1, rmap=1.0)
    force = JSphereSL.from_tables(t, dtype=jnp.float64, backend="gather")
    mesh = particle_mesh(8)
    x, v, mass = _hernquist_bodies()
    ps = JPS.from_arrays(x, v, mass, dtype=jnp.float64, pad_to=8).shard(mesh)
    ps, coef0, _ = init_force_state(force, ps, mesh=mesh,
                                    accum_dtype=jnp.float64)
    step = make_kdk_step(force, 1e-3, mesh=mesh, accum_dtype=jnp.float64)
    coefs = [np.asarray(coef0)]
    for _ in range(5):
        ps, coef, _ = step(ps)
        coefs.append(np.asarray(coef))
    ref = np.stack(coefs)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(z["coefs"], ref, atol=1e-12 * scale,
                               rtol=1e-12)
    np.testing.assert_allclose(z["x"], np.asarray(ps.x), atol=1e-12)
    np.testing.assert_allclose(z["v"], np.asarray(ps.v), atol=1e-12)
    np.testing.assert_array_equal(z["indx"], np.asarray(ps.indx))
    assert np.isfinite(z["ke"]) and z["pe"] < 0



@pytest.mark.parametrize("fmt", ["ascii", "psp"])
def test_sharded_read_matches_whole_read(tmp_path, fmt):
    """read_bodies_distributed: each of 3 ranks reads only its row block of
    an ascii body file (its scale column too) or a PSP file; the blocks
    concatenate to the whole read padded to a multiple of 3 with
    zero-mass rows of indx 0 and scale -1."""
    from exp_tpu_torch.io.psp import PSPComponent, PSPDump, write_psp
    from exp_tpu_torch.nbody.particles import read_bodies
    from exp_tpu_torch.parallel.distributed import (World,
                                                    read_bodies_distributed)

    rng = np.random.default_rng(2)
    n = 301
    x, v = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    m, sc = rng.uniform(0.5, 1.5, n), rng.uniform(0.1, 1.0, n)
    path = tmp_path / "b.bods"
    if fmt == "ascii":
        with open(path, "w") as f:
            f.write(f"{n} 0 1\n")
            np.savetxt(f, np.column_stack([m, x, v, sc]), fmt="%.16e")
        kw = {"scale_dattr": 0}
    else:
        d = PSPDump(time=0.0)
        d.components.append(PSPComponent(name="h", info="name: h\n", mass=m,
                                         x=x, v=v, pot=np.zeros(n)))
        write_psp(str(path), d)
        kw = {}
    whole = read_bodies(str(path), dtype=F64, pad_to=3, device="cpu", **kw)
    parts = [read_bodies_distributed(str(path), World(rank=r, size=3),
                                     dtype=F64, **kw) for r in range(3)]
    assert [p.n for p in parts] == [101, 101, 101]
    for f in ("x", "v", "mass", "indx", "scale"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, f).numpy() for p in parts]),
            getattr(whole, f).numpy(), f)


def test_one_rank_helpers_and_cache_coordination():
    """The helpers on a one-rank world (or None) touch no process group:
    sums, gathers, broadcasts and builds return their input; is_primary;
    and world_coefficients: one rank's coefficients are the force's own,
    and a source force's rows come back as they are on any world (its
    ring, not a sum, brings the other ranks' rows)."""
    from exp_tpu_torch.forces.direct import DirectForce
    from exp_tpu_torch.parallel import distributed as pd
    from exp_tpu_torch.parallel.distributed import World

    t = torch.arange(6.0)
    for w in (None, World()):
        assert pd.all_reduce(t, w) is t
        assert pd.allgather_rows(t, w) == (t, [6])
        assert pd.broadcast_object({"a": 1}, w) == {"a": 1}
        assert pd.primary_build(w, lambda: 7) == 7
        np.testing.assert_array_equal(pd.sum_host([1, 2], w), [1, 2])
        assert pd.is_primary(w)
    assert not pd.is_primary(World(rank=1, size=2))

    class Pair:
        def coefficients(self, x, mass, accum_dtype=None):
            return (mass.sum(), (mass * x[:, 0]).sum())

    x, m = torch.ones(4, 3, dtype=F64), torch.full((4,), 0.5, dtype=F64)
    for w in (None, World()):
        c = pd.world_coefficients(Pair(), x, m, w)
        assert [float(u) for u in c] == [2.0, 2.0]
    xs, ms = pd.world_coefficients(DirectForce(), x, m, World(rank=1,
                                                              size=2))
    assert xs is x and ms is m


def test_outlog_difference_scales():
    """bench_multirank's OUTLOG comparison: a column over its largest
    value, the L columns of a block over its largest |L| (a disk's L(x)
    near 0 beside its L(z)), R and V absolutely."""
    from exp_tpu_torch.bench_multirank import outlog_difference

    ref = np.ones((3, 47))
    ref[:, 39:41], ref[:, 41] = 1e-6, 2e-3      # the disk's L(x), L(y), L(z)
    log = ref.copy()
    log[1, 39] += 1e-9
    assert outlog_difference(log, ref) == (pytest.approx(5e-7), 39, 0.0)
    log = ref.copy()
    log[2, 12] *= 1 + 1e-6                      # the global KE
    log[0, 4] += 3e-9                           # the global R(y)
    assert outlog_difference(log, ref) == (pytest.approx(1e-6), 12,
                                           pytest.approx(3e-9))


def test_one_device_paths_take_forces_without_group():
    """On one device the step, the runner's projection and the subsample
    projections call `coefficients` without `group`, so an object with
    the one-device signature (a test's stand-in force) still serves."""
    from exp_tpu_torch.nbody.multistep import CompFeats, _project
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.pca import subsample_coefficients
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    class Plain:
        def coefficients(self, x, mass, accum_dtype=None):
            return torch.stack([mass.sum(), (mass * x[:, 0]).sum()])

        def acceleration(self, coef, x):
            return -coef[0] * x, -coef[0] * (x * x).sum(1)

    rng = np.random.default_rng(0)
    ps = ParticleSystem.from_arrays(rng.normal(size=(8, 3)),
                                    rng.normal(size=(8, 3)), np.ones(8),
                                    dtype=F64, device="cpu")
    f = Plain()
    ps, c, _ = init_force_state(f, ps, accum_dtype=F64)
    ps, c, _ = make_kdk_step(f, 1e-3, accum_dtype=F64)(ps)
    assert float(c[0]) == 8.0
    assert subsample_coefficients(f, ps.x, ps.mass, nsamples=2).shape == (2,
                                                                          2)
    assert float(_project(f, CompFeats(), ps.x, ps.mass, 0.0, None,
                          F64)[0]) == 8.0



def test_userbar_multistep_run_is_finite(tmp_path):
    """EXTRAS_CONFIG's sphere run at multistep 2 with the userbar: the
    port's run is finite (its bar force is finite at the origin, where the
    buckets' zero-mass holes sit; exp_tpu's is NaN there and turns OUTLOG
    to NaN from the first big step: ROADMAP §3)."""
    from test_distributed import _driver_workdir

    from exp_tpu_torch.bench_extras import outlog_rows
    from exp_tpu_torch.nbody.simulation import Simulation

    d = _driver_workdir(str(tmp_path), "bar", nsteps=1)
    with open(os.path.join(d, "config.yml"), "w") as f:
        f.write(EXTRAS_CONFIG.format(M=2, P="EJ: 2, nEJkeep: 64, "
                                     "EJwindow: 4", F=SPHERE, C="",
                                     X=USERBAR, O=""))
    sim = Simulation.from_file(os.path.join(d, "config.yml"), device="cpu")
    sim.run()
    log = outlog_rows(os.path.join(d, "OUTLOG.xrun"))
    assert log.shape[0] == 5 and np.isfinite(log).all()
    holes = sum(int((b.mass == 0).sum()) for b in sim._ms_state["halo"])
    assert holes > 0            # the buckets hold zero-mass rows
    ps = sim._state["halo"]
    assert all(bool(torch.isfinite(t).all()) for t in (ps.x, ps.v, ps.acc))


def test_bench_multirank_sphere_world_on_cpu():
    """exp_tpu_torch/bench_multirank.py's sphere world on the CPU (gloo):
    a small sphere cell over 2 ranks against one rank, 3 steps of the
    pallas backend's plain versions in f32: the coefficients within 5e-6
    of max|c| (MD2's bound on the card), both ranks' equal, the energies
    finite."""
    from exp_tpu_torch import bench_multirank as bmr
    from exp_tpu_torch.bench_sphere import equilibrium_sample, sphere_tables

    x, v, m = equilibrium_sample(4096, seed=0)
    rep = bmr.sphere_world(sphere_tables(2, 6, numr=400), x, v, m, 2,
                           steps=3, device="cpu")
    assert rep["backend"] == "gloo" and rep["rows"] == [2048, 2048]
    assert rep["ranks_equal_coefs"] and rep["finite"]
    assert rep["coef_rel_err_max"] <= 5e-6, rep["coef_rel_err_max"]
    assert np.isfinite(rep["dE_rel"])




@pytest.mark.parametrize("M", [0, 2], ids=["single", "ms2"])
def test_two_rank_world_extras_match_one_rank(tmp_path, M):
    """ROADMAP item 12b: scatterMFP and generateRelaxation (applied between
    blocks of the single-rate path, on the global rows in the one-rank
    order: the same draws), two adaptive sphereSL rebuilds (dtime 0.03;
    rank 0 builds, the tables broadcast), and every writer the world
    refused, with the userbar (finite on the padding row at the origin and
    on the buckets' holes), through `run.py --cpu --ndev 2 --launches`
    against the one-rank run of the same config on the same 4,001 bodies
    (in this process).  Each file
    is written once; the text files, the relaxation log, the ascii dumps
    (the state at steps 0, 3 and 6, the last the final state) and
    OutHDF5's f64 snapshots equal the one-rank run's to 1e-10 of each
    column's largest value, with a floor of 1e-14 (OUTLOG's centre of
    mass cancels to ~1e-8); at multistep, where the ranks' buckets hold
    the rows in another order than one rank's, the dumps' rows are
    sorted first; OutVel's
    coefficients, f32 sums of each rank's rows added over the ranks, to
    2e-5 of each dataset's largest value (measured 1.3e-6, OutSamp's
    bound in tests/torch_world.py).  Each rank reports the rebuilds at t = 0.03 and 0.06."""
    import json

    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.bench_multirank import text_rows
    from exp_tpu_torch.ic.eddington import sample_spherical_model
    from exp_tpu_torch.nbody.simulation import Simulation
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    m = hernquist_model(rmin=1e-4, rmax=20.0, numr=800)
    x, v, mass = sample_spherical_model(m, WORLD_N, seed=23)
    dirs = {}
    for tag in ("one", "two"):
        d = tmp_path / tag
        d.mkdir()
        m.to_file(d / "halo.model")
        write_ascii_bodies(str(d / "halo.bods"), (x, v, mass))
        (d / "config.yml").write_text(WORLD_CONFIG.format(M=M))
        dirs[tag] = d
    Simulation.from_file(str(dirs["one"] / "config.yml"), device="cpu").run()
    log = _launch([(["--cpu", "--ndev", "2", "--launches", "config.yml"],
                    {})], str(dirs["two"]), launches=2)[0]
    reps = [json.loads(ln[len(LAUNCHES):]) for ln in log.splitlines()
            if ln.startswith(LAUNCHES)]
    assert sorted(r["rank"] for r in reps) == [0, 1]
    for r in reps:
        assert [b["time"] for b in r["rebuilds"]] == pytest.approx(
            [0.03, 0.06])
    one, two = dirs["one"], dirs["two"]
    files = sorted(f for f in os.listdir(one)
                   if not f.endswith((".yml", ".bods", ".model")))
    assert files == sorted(f for f in os.listdir(two)
                           if not f.endswith((".yml", ".bods", ".model")))
    assert {"wrun.relx", "ORBTRACE.wrun", "OUTDIAG.wrun", "OUTFRAC.wrun",
            "OUTCALBR.wrun", "OUT.wrun.h5", "outvel.halo.wrun.h5",
            "halo.wrun.00006.ascii"} <= set(files)
    for f in files:
        if f.endswith(".h5"):
            a, b = _h5_sets(one / f), _h5_sets(two / f)
            assert sorted(a) == sorted(b) and a, f
            for k in a:
                va, vb = np.asarray(a[k], float), np.asarray(b[k], float)
                tol = 2e-5 if f.startswith("outvel") else 1e-10
                if M and va.ndim and va.shape[0] == WORLD_N:
                    # a snapshot's rows, in each run's bucket order
                    continue
                np.testing.assert_allclose(
                    vb, va, rtol=0, atol=tol * max(np.abs(va).max(), 1e-30),
                    err_msg=f"{f}:{k}")
            if f == "OUT.wrun.h5" and M:
                for snap in {k.rsplit("/", 1)[0] for k in a}:
                    ra, rb = (np.column_stack([h[f"{snap}/{c}"].reshape(
                        WORLD_N, -1) for c in ("mass", "pos", "vel", "pot")])
                        for h in (a, b))
                    ra, rb = (r[np.lexsort(r.T[::-1])] for r in (ra, rb))
                    np.testing.assert_allclose(
                        rb, ra, rtol=0, atol=1e-10 * np.abs(ra).max())
            continue
        a, b = text_rows(str(one / f)), text_rows(str(two / f))
        if M and f == "wrun.relx":
            # the operators run between the blocks of the single-rate
            # path only (exp_tpu's driver): the header alone
            assert a.size == b.size == 0
            continue
        assert a.shape == b.shape and a.size, f
        assert np.isfinite(a).all(), f
        if M and f.endswith(".ascii"):
            a, b = (r[np.lexsort(r.T[::-1])] for r in (a, b))
        # 1e-10 of each column's largest value; OUTLOG's centre-of-mass
        # columns cancel to ~1e-8 of their terms: a floor of 1e-14
        bad = np.abs(b - a) > 1e-10 * np.abs(a).max(axis=0) + 1e-14
        assert not bad.any(), (f, float(np.abs(b - a).max()))
    if not M:
        rel = text_rows(str(one / "wrun.relx"))
        assert len(rel) == 5 and rel[-1, 1] > 0

