"""The port's multi-device runs (exp_tpu_torch/parallel/, ROADMAP item 12)
on the CPU: worlds of two ranks over gloo, each rank a process.

* row_block, pad_global_count and ps_from_local partition as exp_tpu's do
  (tests/test_distributed.py:127).
* A 2-rank world's coefficients equal one rank's to 1e-12 (f64) for the
  sphere, the cylinder, the cube, the slab, shells and twocenter, and the
  direct force's ring equals the one-rank sum: the analogue of
  tests/test_spherical_force.py:129-154.  The SL, EOF and slab tables are
  built on rank 0 and broadcast.
* The 2-rank KDK step against exp_tpu's single-process run on its 8-device
  mesh, tests/test_distributed.py:83-124's analogue at its tolerances.
* The 2-rank YAML driver (`python -m exp_tpu_torch.run --cpu
  --distributed`, DRIVER_CONFIG of tests/test_distributed.py:159-190)
  against exp_tpu's single-process driver, the analogue of :256-320:
  OUTLOG to rtol 1e-9, the coefficients to 1e-10 of their scale, the
  same levels file, every file written once, a restart from the world's
  own checkpoint; and `--ndev 2` prints the same OUTLOG.
* The sharded body read against the whole read, and the helpers on a
  one-rank world without a process group.
* What a world ran only on one rank before (ROADMAP item 12b): both host
  operators, the adaptive sphereSL rebuild and the writers OutAscii,
  OrbTrace, OutDiag, OutFrac, OutCalbr, OutHDF5 and OutVel under
  `run.py --ndev 2`, single-rate and at multistep 2, on a body count the
  world pads, against the port's one-rank run: every file to 1e-10 (f64),
  OutVel's f32 sums to 2e-5 of each dataset's largest value.

Each launched process has a timeout of TIMEOUT seconds and is killed, with
the processes it started, when it expires.  The sphere uses the 'gather'
backend in both packages (the same f64 arithmetic, as
tests/test_torch_multistep.py notes)."""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a launched process may take before it is killed
TIMEOUT = 300
N_COEF = 3001           # odd: the 2-rank split pads one zero-mass row
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """numpy's and scipy's BLAS and torch at one thread while this module
    runs: several test workers share the CPUs, and a BLAS call at eight
    spinning threads a worker runs tens of times slower there than alone.
    The old limits come back at the end of the module.  JAX's persistent
    compilation cache, a directory every worker reads and writes without
    a lock, is off meanwhile (ROADMAP §3, F1)."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache
    from threadpoolctl import threadpool_limits

    n, cache = torch.get_num_threads(), jax.config.jax_enable_compilation_cache
    torch.set_num_threads(1)
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)
    jax.config.update("jax_enable_compilation_cache", cache)
    compilation_cache.reset_cache()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# worlds of spawned ranks
# ---------------------------------------------------------------------------

def _spawn(job, out, nprocs=2):
    """`job` on each rank of a gloo world of `nprocs` spawned processes;
    rank 0 saves its result dict to `out` (npz).  The processes are killed
    after TIMEOUT seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_job, args=(_free_port(), out, job, nprocs),
                             nprocs=nprocs, join=False, start_method="spawn")
    end = time.time() + TIMEOUT
    try:
        while not ctx.join(timeout=max(1.0, end - time.time())):
            if time.time() > end:
                raise TimeoutError(f"{job}: the ranks ran past {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return dict(np.load(out))


def _rank_job(rank, port, out, job, nprocs):
    torch.set_num_threads(1)
    from exp_tpu_torch.parallel.distributed import (finalize_distributed,
                                                    init_distributed)

    world = init_distributed(coordinator=f"127.0.0.1:{port}",
                             num_processes=nprocs, process_id=rank,
                             device="cpu", backend="gloo", timeout=TIMEOUT)
    try:
        res = {"coef": _coef_job, "kdk": _kdk_job}[job](world)
        if rank == 0:
            np.savez(out, **res)
    finally:
        finalize_distributed()


def _block(a, world):
    """This rank's row block of a host array padded with zero rows to a
    multiple of the world size."""
    from exp_tpu_torch.parallel.distributed import pad_global_count, row_block

    n = a.shape[0]
    a = np.concatenate([a, np.zeros((pad_global_count(n, world) - n,)
                                    + a.shape[1:])])
    lo, hi = row_block(a.shape[0], world)
    return torch.tensor(a[lo:hi], dtype=F64)


def _coef_inputs():
    rng = np.random.default_rng(3)
    n = N_COEF
    return {
        "sph": (rng.normal(0.0, 0.5, (n, 3)), rng.uniform(0.5, 1.5, n) / n),
        "disk": (np.column_stack([rng.normal(0, 0.01, (n, 2)),
                                  rng.normal(0, 0.002, n)]),
                 rng.uniform(0.5, 1.5, n) / n),
        "box": (rng.uniform(0.0, 1.0, (n, 3)), rng.uniform(0.5, 1.5, n) / n),
        "sheet": (np.column_stack([rng.uniform(0, 1, (n, 2)),
                                   rng.normal(0, 0.01, n)]),
                  rng.uniform(0.5, 1.5, n) / n),
    }


def _coef_forces(world):
    from exp_tpu_torch.basis.empcyl import build_empcyl_tables
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.basis.slab import build_slab_tables
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
    from exp_tpu_torch.forces.cube import Cube
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.forces.shells import ShellsForce
    from exp_tpu_torch.forces.slab import SlabForce
    from exp_tpu_torch.forces.spherical import SphereSL
    from exp_tpu_torch.forces.twocenter import TwoCenterForce

    ts = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=2,
                             nmax=6, numr=400, cmap=1, rmap=1.0, world=world)
    sph = SphereSL.from_tables(ts, dtype=F64, backend="gather", device="cpu")
    tc = build_empcyl_tables(mmax=2, nmax=6, lmaxfid=16, nmaxfid=12,
                             acyl=0.01, hcyl=0.002, world=world)
    tsl = build_slab_tables(nmaxx=2, nmaxy=2, nmax=3, zmax=0.1, h=0.01,
                            numz=201, world=world)
    return {
        "sphere": ("sph", sph),
        "cylinder": ("disk", CylinderForce.from_tables(
            tc, dtype=F64, backend="xla", device="cpu")),
        "cube": ("box", Cube.create(nmaxx=3, nmaxy=3, nmaxz=3, dtype=F64,
                                    device="cpu")),
        "slab": ("sheet", SlabForce.from_tables(tsl, dtype=F64,
                                                device="cpu")),
        "shells": ("sph", ShellsForce(rmax=10.0, nbins=64)),
        "twocenter": ("sph", TwoCenterForce(
            inner=sph, outer=sph, c1=torch.tensor([0.1, 0.0, 0.0], dtype=F64),
            c2=torch.tensor([-0.05, 0.02, 0.0], dtype=F64))),
    }


def _coef_job(world):
    """Each force's coefficients from the ranks' row blocks summed over the
    world, and (rank 0) from all rows on one rank; the direct ring's
    acceleration of the ranks' targets, gathered, and the one-rank sum."""
    from exp_tpu_torch.forces.direct import DirectForce
    from exp_tpu_torch.parallel.distributed import (allgather_rows,
                                                    world_coefficients)

    inp = _coef_inputs()
    out = {}
    for name, (key, f) in _coef_forces(world).items():
        x, m = inp[key]
        c2 = world_coefficients(f, _block(x, world), _block(m, world),
                                world, accum_dtype=F64)
        c1 = f.coefficients(torch.tensor(x, dtype=F64),
                            torch.tensor(m, dtype=F64), accum_dtype=F64)
        for k, (a, b) in enumerate(zip(*(
                (c,) if torch.is_tensor(c) else c for c in (c2, c1)))):
            out[f"{name}{k}_2"] = torch.view_as_real(a).numpy() \
                if a.is_complex() else a.numpy()
            out[f"{name}{k}_1"] = torch.view_as_real(b).numpy() \
                if b.is_complex() else b.numpy()
    x, m = inp["sph"]
    f = DirectForce(eps=0.01, kernel="plummer")
    xl, ml = _block(x, world), _block(m, world)
    a2, p2 = f.acceleration(f.coefficients(xl, ml), xl, group=world)
    a2 = allgather_rows(torch.cat([a2, p2[:, None]], 1), world)[0]
    xa, ma = torch.tensor(x, dtype=F64), torch.tensor(m, dtype=F64)
    a1, p1 = f.acceleration((xa, ma), xa)
    out["direct0_2"] = a2[:N_COEF].numpy()
    out["direct0_1"] = torch.cat([a1, p1[:, None]], 1).numpy()
    return out


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


# ---------------------------------------------------------------------------
# the KDK step
# ---------------------------------------------------------------------------

def _hernquist_bodies(n=4096, seed=7):
    """tests/test_distributed.py:31's bodies."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.05, 0.95, n)
    r = u / (1 - u)
    ct = rng.uniform(-1, 1, n)
    st = np.sqrt(1 - ct * ct)
    ph = rng.uniform(0, 2 * np.pi, n)
    x = np.stack([r * st * np.cos(ph), r * st * np.sin(ph), r * ct], -1)
    v = rng.normal(0, 0.2, (n, 3))
    return x, v, np.full(n, 1.0 / n)


def _kdk_job(world):
    """tests/distributed_worker.py's run on the port: each rank steps its
    row block 5 times; the coefficient trajectory and the gathered state."""
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
    from exp_tpu_torch.forces.spherical import SphereSL
    from exp_tpu_torch.nbody.step import (energies, init_force_state,
                                          make_kdk_step)
    from exp_tpu_torch.parallel.distributed import (allgather_ps,
                                                    pad_global_count,
                                                    ps_from_local, row_block)

    t = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=2,
                            nmax=6, numr=400, cmap=1, rmap=1.0, world=world)
    force = SphereSL.from_tables(t, dtype=F64, backend="gather",
                                 device="cpu")
    x, v, mass = _hernquist_bodies()
    ng = pad_global_count(len(mass), world)
    lo, hi = row_block(ng, world)
    ps = ps_from_local(x[lo:hi], v[lo:hi], mass[lo:hi], world, ng, lo,
                       dtype=F64)
    ps, c0, _ = init_force_state(force, ps, accum_dtype=F64, world=world)
    step = make_kdk_step(force, 1e-3, accum_dtype=F64, world=world)
    coefs = [c0.numpy().copy()]
    for _ in range(5):
        ps, c, diag = step(ps)
        coefs.append(c.numpy().copy())
    g = allgather_ps(ps, world)
    e = energies(diag)
    return {"coefs": np.stack(coefs), "x": g.x, "v": g.v, "indx": g.indx,
            "ke": e["KE"], "pe": e["PE"]}


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


# ---------------------------------------------------------------------------
# the YAML driver
# ---------------------------------------------------------------------------

def _launch(cmd_sets, workdir):
    """Run each (argv, env) as a process from `workdir`, all at once; each
    is killed, with what it started, after TIMEOUT seconds.  Returns the
    outputs; fails on a non-zero exit."""
    procs = []
    for argv, env in cmd_sets:
        e = dict(os.environ)
        e.pop("PYTEST_CURRENT_TEST", None)
        e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
        e.update(env)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "exp_tpu_torch.run"] + argv, env=e,
            cwd=workdir, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True))
    end, logs = time.time() + TIMEOUT, []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, end - time.time()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-6000:]}"
    return logs


def _distributed(workdir, nproc=2):
    port = _free_port()
    return _launch([(["--cpu", "--distributed", "config.yml"],
                     {"EXP_COORDINATOR": f"127.0.0.1:{port}",
                      "EXP_NPROCS": str(nproc), "EXP_PROCID": str(r)})
                    for r in range(nproc)], workdir)


def test_two_rank_driver_matches_single_process(tmp_path):
    """tests/test_distributed.py:256-320 on the port: the YAML driver at
    multistep 2 through `python -m exp_tpu_torch.run --cpu --distributed`
    on 2 ranks (sharded ingest, big steps, relevels, OUTLOG, OutCoef,
    OutChkpt, OutMulti) against exp_tpu's single-process driver: OUTLOG
    to rtol 1e-9, the coefficients to 1e-10 of their scale, the same
    levels file, each file written once (rank 0 alone), and a restart of
    the world from its own checkpoint; `--ndev 2` prints the same
    OUTLOG."""
    from test_distributed import DRIVER_CONFIG, _driver_workdir, _outlog_rows

    from exp_tpu.io.coefs import open_coefs as j_open
    from exp_tpu.nbody.simulation import Simulation
    from exp_tpu_torch.io.coefs import open_coefs

    base = str(tmp_path)
    d2 = _driver_workdir(base, "world2", nsteps=6)
    d1 = _driver_workdir(base, "world1", nsteps=6)
    dn = _driver_workdir(base, "ndev2", nsteps=6)
    logs = _distributed(d2)
    assert sum("particle-steps/s" in log for log in logs) == 1
    _launch([(["--cpu", "--ndev", "2", "config.yml"], {})], dn)
    sim = Simulation.from_file(os.path.join(d1, "config.yml"))
    sim.prime()
    sim.run()

    log2 = _outlog_rows(os.path.join(d2, "OUTLOG.drun"))
    log1 = _outlog_rows(os.path.join(d1, "OUTLOG.drun"))
    assert log2.shape == log1.shape == (7, log1.shape[1])
    np.testing.assert_allclose(log2, log1, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(
        _outlog_rows(os.path.join(dn, "OUTLOG.drun")), log2)
    t2, c2 = open_coefs(os.path.join(d2, "outcoef.halo.drun.h5")).read_all()
    t1, c1 = j_open(os.path.join(d1, "outcoef.halo.drun.h5")).read_all()
    assert len(t2) == len(t1) == 7
    np.testing.assert_allclose(t2, t1, atol=1e-12)
    np.testing.assert_allclose(c2, c1, atol=1e-10 * np.max(np.abs(c1)))
    lv = [[ln for ln in open(os.path.join(d, "drun.levels"))
           if not ln.startswith("#")] for d in (d2, d1)]
    assert lv[0] == lv[1] and len(lv[0]) == 7
    assert os.path.exists(os.path.join(d2, "config.drun.yml"))
    assert os.path.exists(os.path.join(d2, "OUT.drun.chkpt"))

    with open(os.path.join(d2, "config.yml"), "w") as f:
        f.write(DRIVER_CONFIG.format(nsteps=3,
                                     extra="  infile: OUT.drun.chkpt"))
    _distributed(d2)
    log2b = _outlog_rows(os.path.join(d2, "OUTLOG.drun"))
    assert log2b.shape[0] == 11, log2b.shape
    assert log2b[-1, 0] > log2[-1, 0] + 0.02
    E = log2b[:, 15]
    assert abs(E[-1] - E[0]) / abs(E[0]) < 5e-3


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


EXTRAS_CONFIG = """\
Global:
  dtime: 0.01
  nsteps: 4
  runtag: xrun
  multistep: {M}
  maxMindt: 0.5
  compute_dtype: float64
  accum_dtype: float64
Components:
  - name: halo
    bodyfile: halo.bods
    parameters: {{{P}}}
    force:
{F}{C}External:
{X}Output:
  - id: outlog
    parameters: {{nint: 1}}
{O}"""

SPHERE = """\
      id: sphereSL
      parameters: {numr: 400, Lmax: 2, nmax: 6, rmapping: 1.0,
                   modelname: halo.model, NO_L1: true}
"""
TWOCENTER = """\
      id: twocenter
      parameters: {basis: sphereSL, cfac: 1.0, alpha: 2.0,
                   parameters: {numr: 400, Lmax: 2, nmax: 6, rmapping: 1.0,
                                modelname: halo.model}}
"""
SMBH = """\
  - name: smbh
    bodyfile: bh.bods
    force:
      id: direct
      parameters: {type: Plummer, soft: 0.01}
Interaction:
  - halo: smbh
  - smbh: halo
"""
USERBAR = ("  - id: userbar\n    parameters: {amplitude: 0.1, length: 0.5, "
           "omega: 1.0, Ton: 0.0, DeltaT: 0.5}\n")
OUTSAMP = ("  - id: outsamp\n    parameters: {nint: 2, name: halo, "
           "nsamples: 4}\n")
#: case: (multistep, halo parameters, force, more components, externals,
#: more outputs)
EXTRAS = {
    "sphere": (0, "EJ: 2, nEJkeep: 64, EJwindow: 4, npca: 2, nsamples: 4",
               SPHERE, "", USERBAR, OUTSAMP),
    "sphere_ms": (2, "EJ: 2, nEJkeep: 64, EJwindow: 4", SPHERE, "",
                  "  - id: userlogpot\n", ""),
    "twocenter": (0, "EJ: 2, nEJkeep: 64, EJwindow: 4", TWOCENTER, "",
                  "  - id: userlogpot\n", ""),
    "direct_ms": (2, "EJ: 2, nEJkeep: 64, EJwindow: 4", SPHERE, SMBH,
                  "  - id: userlogpot\n", ""),
}


@pytest.mark.parametrize("case", list(EXTRAS))
def test_two_rank_driver_extras_match_one_rank(tmp_path, case):
    """The extras under a world of two ranks, against the port's one-rank
    run of the same config, each with EJ centering (its most-bound set a
    global top k): single-rate with NO_L1, a userbar External field, Hall
    smoothing (npca; subsamples by global row) and OutSamp; at multistep 2
    with the time-free userlogpot (the userbar at multistep:
    test_userbar_multistep_run_is_finite, and in the worlds of
    test_two_rank_world_extras_match_one_rank); a twocenter force (its
    outer center the COM over the ranks); and a one-body
    direct component coupled both ways at multistep 2 (its ring).  OUTLOG
    and the orient log to rtol 1e-9, each written once; the OutSamp series
    to 2e-5 of each dataset's largest value: it accumulates in f32, as
    exp_tpu's OutSamp does, so two ranks' partials sum in another order
    (~1e-7 of max|c| on the means), and the variance takes differences of
    near-equal estimates (~6e-6 measured)."""
    import shutil

    from test_distributed import _driver_workdir

    from exp_tpu_torch.bench_extras import outlog_rows
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    M, params, force, comps, ext, outs = EXTRAS[case]
    src = _driver_workdir(str(tmp_path), "src", nsteps=1)
    dirs = {}
    for tag in ("one", "two"):
        d = tmp_path / tag
        d.mkdir()
        for f in ("halo.bods", "halo.model"):
            shutil.copy(os.path.join(src, f), d / f)
        # one body of mass 0.01 on a near-circular orbit at r = 0.5
        write_ascii_bodies(str(d / "bh.bods"), (
            np.array([[0.5, 0.0, 0.0]]), np.array([[0.0, 0.8, 0.0]]),
            np.array([0.01])))
        (d / "config.yml").write_text(EXTRAS_CONFIG.format(
            M=M, P=params, F=force, C=comps, X=ext, O=outs))
        dirs[tag] = str(d)
    _launch([(["--cpu", "config.yml"], {})], dirs["one"])
    _distributed(dirs["two"])
    a = outlog_rows(os.path.join(dirs["one"], "OUTLOG.xrun"))
    b = outlog_rows(os.path.join(dirs["two"], "OUTLOG.xrun"))
    assert a.shape == b.shape == (5, a.shape[1])
    assert np.isfinite(a).all()
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12)
    oa, ob = (np.loadtxt(os.path.join(d, "xrun.orient.halo"))
              for d in (dirs["one"], dirs["two"]))
    assert oa.shape == ob.shape and len(oa) == 4      # an update a step
    assert np.isfinite(oa).all()
    np.testing.assert_allclose(ob, oa, rtol=1e-9, atol=1e-12)
    if outs:
        import h5py

        with h5py.File(os.path.join(dirs["one"], "outsamp.halo.xrun.h5"),
                       "r") as fa, h5py.File(os.path.join(
                           dirs["two"], "outsamp.halo.xrun.h5"), "r") as fb:
            keys = []
            fa.visit(keys.append)
            assert keys
            for k in keys:
                if isinstance(fa[k], h5py.Dataset):
                    va = np.asarray(fa[k][...], np.float64)
                    np.testing.assert_allclose(
                        fb[k][...], va, rtol=0,
                        atol=2e-5 * max(np.abs(va).max(), 1e-30),
                        err_msg=k)


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


WORLD_CONFIG = """\
Global:
  dtime: 0.01
  nsteps: 6
  runtag: wrun
  multistep: {M}
  maxMindt: 0.5
  compute_dtype: float64
  accum_dtype: float64
Components:
  - name: halo
    bodyfile: halo.bods
    force:
      id: sphereSL
      parameters: {{numr: 400, Lmax: 2, nmax: 6, rmapping: 1.0,
                   modelname: halo.model, dtime: 0.03}}
External:
  - id: scatterMFP
    parameters: {{tau: 1.0, rmax: 10.0}}
  - id: generateRelaxation
  - id: userbar
    parameters: {{amplitude: 0.1, length: 0.5, omega: 1.0, Ton: 0.0,
                 DeltaT: 0.5}}
Output:
  - id: outlog
    parameters: {{nint: 1}}
  - id: outascii
    parameters: {{nint: 3}}
  - id: orbtrace
    parameters: {{nint: 1, norb: 5}}
  - id: outdiag
    parameters: {{nint: 2}}
  - id: outfrac
    parameters: {{nint: 2}}
  - id: outcalbr
    parameters: {{nint: 2}}
  - id: outhdf5
    parameters: {{nint: 3, real4: false}}
  - id: outvel
    parameters: {{nint: 3}}
"""
#: bodies of the world runs: odd, so that two ranks pad a zero-mass row
WORLD_N = 4001


def _h5_sets(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, d: out.__setitem__(k, np.asarray(d[...]))
                     if isinstance(d, h5py.Dataset) else None)
    return out


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
    bound above).  Each rank reports the rebuilds at t = 0.03 and 0.06."""
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
                    {})], str(dirs["two"]))[0]
    reps = [json.loads(ln.split("launches ", 1)[1])
            for ln in log.splitlines()
            if ln.startswith("[exp_tpu_torch] launches ")]
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

