"""Shared parts of the port's multi-rank tests on the CPU
(tests/test_torch_distributed*.py): worlds of spawned gloo ranks, the
launched driver processes, the configs they run, and the body of the
extras cases, which several files split among them so that the test
workers share them.

Each launched process has a timeout of TIMEOUT seconds and is killed, with
the processes it started, when it expires.  Launched drivers run with one
BLAS and OpenMP thread, as the test process does (`one_cpu_thread`):
several test workers share the CPUs, and a child that starts a thread on
every core beside them runs several times slower.  The sphere uses the
'gather' backend in both packages (the same f64 arithmetic, as
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
def one_cpu_thread():
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



# ---------------------------------------------------------------------------
# the YAML driver
# ---------------------------------------------------------------------------

#: the environment of a launched driver: one BLAS and OpenMP thread
CHILD_THREADS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
                 "MKL_NUM_THREADS": "1"}
#: the line `run.py --launches` prints for each rank
LAUNCHES = "[exp_tpu_torch] launches "


def _launch(cmd_sets, workdir, launches=0):
    """Run each (argv, env) as a process from `workdir`, all at once, with
    CHILD_THREADS; each is killed, with what it started, after TIMEOUT
    seconds.  Returns the outputs; fails on a non-zero exit and, with
    `launches`, where an output holds fewer than that many LAUNCHES lines
    (one a rank), with that process's whole merged output."""
    procs = []
    for argv, env in cmd_sets:
        e = dict(os.environ)
        e.pop("PYTEST_CURRENT_TEST", None)
        e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
        e.update(CHILD_THREADS)
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
        found = sum(ln.startswith(LAUNCHES) for ln in log.splitlines())
        assert found >= launches, (
            f"{found} of {launches} '{LAUNCHES.strip()}' lines; the whole "
            f"merged output:\n{log}")
    return logs


def _distributed(workdir, nproc=2):
    port = _free_port()
    return _launch([(["--cpu", "--distributed", "config.yml"],
                     {"EXP_COORDINATOR": f"127.0.0.1:{port}",
                      "EXP_NPROCS": str(nproc), "EXP_PROCID": str(r)})
                    for r in range(nproc)], workdir)



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



def driver_extras_match_one_rank(tmp_path, case):
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

