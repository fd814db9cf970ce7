"""Multi-rank runs against one rank (ROADMAP item 12): a world of k ranks,
one process each, against the same run on one rank.

    python -m exp_tpu_torch.bench_multirank sphere [--ranks K] [--n N]
        [--steps S] [--device cpu]
    python -m exp_tpu_torch.bench_multirank flagship [--ranks K]
        [--n-halo N] [--n-disk N] [--seed S] [--device cpu]
    python -m exp_tpu_torch.bench_multirank extras [--ranks K] [--n N]
        [--steps S] [--device cpu]

`sphere`: the sphere cell (bench_sphere's tables, its 2^20 equilibrium
sample by default) split into k row blocks, init + S KDK steps of dt 1e-3
on k spawned ranks, against the same steps on one rank: the coefficients
of every step (max|dc| / max|c|), the energies, each rank's launches and
its host-clock step time.  `flagship`: the flagship run config
(bench_extras.flagship_config with OutMulti's levels file) on the
composite's DiskHalo ICs through `python -m exp_tpu_torch.run` on one
rank and with `--ndev k`: OUTLOG's columns (each column's largest
difference over its largest value, the L columns over the largest |L|;
R and V, sums of +- terms near 0, absolutely), the level populations, the files written, each rank's
launches.  `extras` (ROADMAP item 12b): the sphere run config
(bench_extras.sphere_config on the sphere cell's sample) with both host
operators, an adaptive sphereSL rebuild every WX_REBUILD time units and
the writers OutAscii, OrbTrace, OutDiag, OutFrac and OutCalbr, through
`run.py --launches` on one rank and with `--ndev k`: each file's
differences (`file_difference`), each rank's launches and the launches at
each rebuild; `outvel_world` holds OutVel's gather (each rank's
projections summed over the ranks) against one rank's.  On cards a rank takes card r modulo the cards present, over
NCCL when every rank has a card of its own and gloo otherwise; with
`--device cpu`, gloo on the CPU.  Each launched world is killed after
TIMEOUT seconds.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

#: seconds a launched world may take before it is killed
TIMEOUT = 300
STEPS = 50
DT = 1e-3


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_world(fn, args, nprocs, timeout=TIMEOUT):
    """fn(rank, *args) on `nprocs` spawned processes, killed after
    `timeout` seconds; a failed rank raises here."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    end = time.time() + timeout
    try:
        while not ctx.join(timeout=max(1.0, end - time.time())):
            if time.time() > end:
                raise RuntimeError(f"the ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def run_cli(argv, timeout=TIMEOUT):
    """`python -m exp_tpu_torch.run argv` from the repository, its output;
    killed with its ranks after `timeout` seconds, raising on a non-zero
    exit."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen([sys.executable, "-m", "exp_tpu_torch.run"] + argv,
                         cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    if p.returncode != 0:
        raise RuntimeError(f"exp_tpu_torch.run {argv} exited "
                           f"{p.returncode}:\n{out[-4000:]}")
    return out


def world_devices(k, device=None):
    """The ranks' devices and backend: card r modulo the cards, NCCL when
    each rank has its own card; the CPU and gloo when `device` is cpu."""
    import torch

    if device is not None and str(device).startswith("cpu"):
        return ["cpu"] * k, "gloo"
    from exp_tpu_torch import resolve_device

    resolve_device(None)                 # raises without a card
    n = torch.cuda.device_count()
    return [f"cuda:{r % n}" for r in range(k)], ("nccl" if n >= k
                                                 else "gloo")


def sphere_rank(rank, port, wd, steps, devs, backend):
    """One rank of the sphere cell: its row block of the sample in
    `wd`/sample.npz under the tables in `wd`/tables.pkl, init + `steps`
    KDK steps; saves its coefficients every step, its energies, launches
    and host-clock step time to `wd`/rank<r>.npz."""
    import pickle

    import torch

    from exp_tpu_torch.bench_sphere import sphere_force
    from exp_tpu_torch.nbody.step import (energies, init_force_state,
                                          make_kdk_step)
    from exp_tpu_torch.ops import sphere_kernels as sk
    from exp_tpu_torch.parallel.distributed import (finalize_distributed,
                                                    init_distributed,
                                                    pad_global_count,
                                                    ps_from_local, row_block)

    world = init_distributed(coordinator=f"127.0.0.1:{port}",
                             num_processes=len(devs), process_id=rank,
                             device=devs[rank], backend=backend,
                             timeout=TIMEOUT)
    try:
        with open(os.path.join(wd, "tables.pkl"), "rb") as f:
            tables = pickle.load(f)
        z = np.load(os.path.join(wd, "sample.npz"))
        force = sphere_force(tables, world.device)
        ng = pad_global_count(len(z["m"]), world)
        lo, hi = row_block(ng, world)
        ps = ps_from_local(z["x"][lo:hi], z["v"][lo:hi], z["m"][lo:hi],
                           world, ng, lo)
        sk.reset_launch_counts()
        ps, c, diag = init_force_state(force, ps, world=world)
        e0 = energies(diag)
        step = make_kdk_step(force, DT, world=world)
        coefs = [c.clone()]
        if world.device.type == "cuda":
            torch.cuda.synchronize(world.device)
        t0 = time.perf_counter()
        for _ in range(steps):
            ps, c, diag = step(ps)
            coefs.append(c.clone())
        e1 = energies(diag)
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        finite = all(bool(torch.isfinite(a).all())
                     for a in (ps.x, ps.v, ps.acc, ps.pot))
        np.savez(os.path.join(wd, f"rank{rank}.npz"),
                 coefs=torch.stack(coefs).cpu().numpy(),
                 launches=json.dumps(dict(sk.launch_counts)),
                 e0=json.dumps(e0), e1=json.dumps(e1), finite=finite,
                 rows=ps.n, step_ms=step_ms)
    finally:
        finalize_distributed()


def sphere_world(tables, x, v, m, ranks, steps=STEPS, device=None,
                 ref=None, devs=None, backend=None):
    """The sphere cell over `ranks` spawned ranks against one rank's run of
    the same steps (`ref`: its (steps + 1, ...) coefficients, run here on
    the first rank's device when None).  `devs` and `backend` override
    world_devices' choice.  Returns the comparison."""
    import pickle

    import torch

    from exp_tpu_torch.bench_sphere import sphere_force
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    if devs is None:
        devs, backend = world_devices(ranks, device)
    one_ms = None
    if ref is None:
        force = sphere_force(tables, devs[0])
        ps, c, _ = init_force_state(
            force, ParticleSystem.from_arrays(x, v, m, device=devs[0]))
        ref = [c.clone()]
        step = make_kdk_step(force, DT)
        t0 = time.perf_counter()
        for _ in range(steps):
            ps, c, _ = step(ps)
            ref.append(c.clone())
        ref = torch.stack(ref).cpu().numpy()
        one_ms = (time.perf_counter() - t0) * 1e3 / steps
    with tempfile.TemporaryDirectory(prefix="bench_multirank_") as wd:
        with open(os.path.join(wd, "tables.pkl"), "wb") as f:
            pickle.dump(tables, f)
        np.savez(os.path.join(wd, "sample.npz"), x=x, v=v, m=m)
        t0 = time.perf_counter()
        spawn_world(sphere_rank, (free_port(), wd, steps, devs, backend),
                    ranks)
        sec = time.perf_counter() - t0
        z = [dict(np.load(os.path.join(wd, f"rank{r}.npz")))
             for r in range(ranks)]
    scale = np.abs(ref).max(axis=tuple(range(1, ref.ndim)))
    err = [float(np.abs(z[0]["coefs"][s] - ref[s]).max() / scale[s])
           for s in range(steps + 1)]
    e0, e1 = json.loads(str(z[0]["e0"])), json.loads(str(z[0]["e1"]))
    return {"ranks": ranks, "backend": backend, "devices": devs,
            "sec": sec, "coef_rel_err_max": max(err),
            "coef_rel_err_last": err[-1],
            "ranks_equal_coefs": all(np.array_equal(z[0]["coefs"],
                                                    zz["coefs"])
                                     for zz in z),
            "virial0": e0["2T/VC"], "virial1": e1["2T/VC"],
            "dE_rel": abs(e1["Etot"] - e0["Etot"]) / abs(e0["Etot"]),
            "launches": [json.loads(str(zz["launches"])) for zz in z],
            "rows": [int(zz["rows"]) for zz in z],
            "finite": all(bool(zz["finite"]) for zz in z),
            "step_ms_host": [float(zz["step_ms"]) for zz in z],
            "one_rank_step_ms_host": one_ms}


def flagship_run_config(outdir, nsteps=10, infile=None):
    """The flagship run config (bench_extras.flagship_config) with
    OutMulti's levels file every big step, and a restart's infile."""
    from exp_tpu_torch.bench_extras import flagship_config

    cfg = flagship_config(outdir, nsteps=nsteps)
    cfg["Output"].append({"id": "outmulti", "parameters": {"nint": 1}})
    if infile:
        cfg["Global"]["infile"] = infile
    return cfg


def outlog_difference(log, ref):
    """(the largest of each OUTLOG column's difference over its scale, that
    column, the largest R or V difference).  A column's scale is its
    largest value, but for the angular momentum columns, which share the
    largest |L| of their block: a sum's rounding is a share of its terms'
    size, and a disk's L(x) and L(y) are near-0 remainders of terms as
    large as its L(z).  R and V, sums of +- terms near 0, are held
    absolutely."""
    nsec = (ref.shape[1] - 17) // 15
    absc = list(range(3, 9)) + [17 + 15 * i + k for i in range(nsec)
                                for k in range(1, 7)]
    lvec = [[9, 10, 11]] + [[17 + 15 * i + k for k in (7, 8, 9)]
                            for i in range(nsec)]
    relc = [c for c in range(1, ref.shape[1]) if c not in absc]
    scale = np.abs(ref).max(0)
    for cols in lvec:
        scale[cols] = np.linalg.norm(ref[:, cols], axis=1).max()
    d = np.abs(log - ref)
    colrel = d[:, relc].max(0) / np.maximum(scale[relc], 1e-30)
    return (float(colrel.max()), relc[int(np.argmax(colrel))],
            float(d[:, absc].max()))


def level_share(path, ref_path):
    """The largest move of a level's population between two levels files,
    as a share of its component."""
    rows = [[ln.split() for ln in open(p) if not ln.startswith("#")]
            for p in (path, ref_path)]
    return max(float(np.abs(np.array(a[2:], float)
                            - np.array(b[2:], float)).max()
                     / np.array(b[2:], float).sum())
               for a, b in zip(*rows))


def flagship_world(wd, ranks, device=None, ref_tag=None):
    """The flagship run config on the body files in `wd` through `run.py
    --ndev ranks --launches`, against one rank's run (`ref_tag`: an outdir
    in `wd` already holding it; else run here).  Returns the comparison
    and the ranks' launch reports."""
    import yaml

    from exp_tpu_torch.bench_extras import outlog_rows

    cpu = ["--cpu"] if device is not None and str(device).startswith(
        "cpu") else []
    lines = {}
    for tag, extra in (("one", []), ("many", ["--ndev", str(ranks),
                                               "--launches"])):
        if tag == "one" and ref_tag is not None:
            continue
        cfg = os.path.join(wd, f"{tag}.yml")
        with open(cfg, "w") as f:
            yaml.safe_dump(flagship_run_config(tag), f)
        t0 = time.perf_counter()
        out = run_cli(cpu + extra + [cfg])
        lines[tag] = {"sec": time.perf_counter() - t0,
                      "run_line": [ln for ln in out.splitlines()
                                   if "steps in" in ln],
                      "reports": [json.loads(ln.split("launches ", 1)[1])
                                  for ln in out.splitlines() if ln.startswith(
                                      "[exp_tpu_torch] launches ")]}
    ref = ref_tag or "one"
    a = outlog_rows(os.path.join(wd, ref, "OUTLOG.flag"))
    b = outlog_rows(os.path.join(wd, "many", "OUTLOG.flag"))
    rel, col, ab = (outlog_difference(b, a) if a.shape == b.shape
                    else (float("inf"), -1, float("inf")))
    return {"ranks": ranks, "rows": [len(a), len(b)],
            "outlog_max_rel": rel, "outlog_worst_column": col,
            "outlog_max_abs_RV": ab,
            "level_share_max": level_share(
                os.path.join(wd, "many", "flag.levels"),
                os.path.join(wd, ref, "flag.levels")),
            "files": sorted(os.listdir(os.path.join(wd, "many"))),
            "runs": lines}


#: the extras run: KDK steps, the adaptive rebuild's interval (two rebuilds
#: in WX_STEPS steps of dt 1e-3), ScatterMFP's time scale, the writers'
#: intervals
WX_STEPS = 20
WX_REBUILD = 0.01
WX_TAU = 0.1
WX_NINT = 5


def extras_run_config(outdir, nsteps=WX_STEPS):
    """The extras run config: bench_extras.sphere_config (sphere.bods,
    halo.model, dt 1e-3, OUTLOG every step) with the halo's sphereSL
    rebuilt every WX_REBUILD, the External scatterMFP (tau WX_TAU, rmax
    10) and generateRelaxation, OutAscii once (the run's first output; a
    dump of 2^20 bodies takes ~9 s), OrbTrace every step, OutDiag, OutFrac
    and OutCalbr every WX_NINT steps."""
    from exp_tpu_torch.bench_extras import sphere_config

    cfg = sphere_config(outdir, "wx", DT, nsteps)
    cfg["Components"][0]["force"]["parameters"]["dtime"] = WX_REBUILD
    cfg["External"] = [{"id": "scatterMFP",
                        "parameters": {"tau": WX_TAU, "rmax": 10.0}},
                       {"id": "generateRelaxation"}]
    cfg["Output"] += [
        {"id": "outascii", "parameters": {"nint": nsteps + 1}},
        {"id": "orbtrace", "parameters": {"nint": 1, "norb": 5}},
        {"id": "outdiag", "parameters": {"nint": WX_NINT}},
        {"id": "outfrac", "parameters": {"nint": WX_NINT}},
        {"id": "outcalbr", "parameters": {"nint": WX_NINT}}]
    return cfg


def text_rows(path):
    """A text output's numeric rows: comment lines, OUTLOG's header, an
    ascii body file's count line and the component-name fields dropped;
    OUTLOG's wall-clock column (17) too."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".ascii"):
        # a body file: its count line, then 7 numbers a body
        return np.array(text.split(None, 3)[3].split(),
                        float).reshape(-1, 7)
    rows = []
    for ln in text.splitlines():
        f = ln.replace("|", " ").split()
        if ln.startswith("#") or "Time" in ln:
            continue
        rows.append([float(t) for t in f if t not in ("halo", "all")])
    a = np.array(rows)
    return np.delete(a, 17, 1) if os.path.basename(path).startswith(
        "OUTLOG") and a.size else a


def _energy_scale(path):
    """The largest |E| of OUTCALBR's energy bins (its header's centers)."""
    with open(path) as f:
        for ln in f:
            if ln.startswith("# E bin centers:"):
                return float(np.abs(np.array(ln.split(":")[1].split(),
                                             float)).max())
    raise ValueError(f"{path}: no energy bins")


def file_difference(path, ref_path):
    """Two text outputs of the same run compared column by column, each
    difference over its column's scale: "rel" of the value columns; "bin"
    of the columns that are statistics over a radial or energy bin's
    members (OUTDIAG's N, mass, KE and mean potential; OUTCALBR's rms
    changes and counts), which move when a body at a bin's edge lands in
    the other bin, as level_share's populations do; "abs_RV", OUTLOG's R
    and V held absolutely (outlog_difference, whose "rel" this is for
    OUTLOG).  A column's scale is its largest |value|, but for a count or
    a sum over a bin's members the total over the output's bins (the share
    of the component that moved), and for a difference of energies the
    energies differenced (a rounding is a share of its terms' size, as
    outlog_difference scales the L columns): relx's <|dE/E|> and
    max|dE/E| are relative already (scale 1), OUTCALBR's rms dE take the
    largest |E| of its bins.  inf everywhere when the shapes differ."""
    a, b = text_rows(ref_path), text_rows(path)
    out = {"rel": 0.0, "bin": 0.0, "abs_RV": 0.0}
    if a.shape != b.shape:
        return {k: float("inf") for k in out}
    if not a.size:
        return out
    name = os.path.basename(path)
    if name.startswith("OUTLOG"):
        out["rel"], _, out["abs_RV"] = outlog_difference(b, a)
        return out
    scale = np.broadcast_to(np.abs(a).max(axis=0), a.shape).copy()
    binc = []
    if name.endswith(".relx"):
        scale[:, 1:] = 1.0
    elif name.startswith("OUTCALBR"):
        binc = list(range(1, a.shape[1]))
        scale[:, 1::5] = _energy_scale(ref_path)
        scale[:, 5::5] = a[:, 5::5].sum(axis=1, keepdims=True)
    elif name.startswith("OUTDIAG"):
        binc = [2, 3, 4, 5]
        for t in np.unique(a[:, 0]):
            rows = a[:, 0] == t
            scale[rows, 2:5] = np.abs(a[rows, 2:5]).sum(axis=0)
    d = np.abs(b - a) / np.maximum(scale, 1e-30)
    keep = [c for c in range(a.shape[1]) if c not in binc]
    out["rel"] = float(d[:, keep].max())
    out["bin"] = float(d[:, binc].max()) if binc else 0.0
    return out


def extras_world(wd, ranks, device=None):
    """The extras run config on the bodies in `wd` (sphere.bods,
    halo.model) through `run.py --launches` on one rank and with `--ndev
    ranks`.  Returns each output file's difference, the files each run
    wrote and the ranks' launch reports (with the launches at each
    rebuild)."""
    import yaml

    cpu = ["--cpu"] if device is not None and str(device).startswith(
        "cpu") else []
    runs = {}
    for tag, extra in (("one", []), ("many", ["--ndev", str(ranks)])):
        cfg = os.path.join(wd, f"wx_{tag}.yml")
        with open(cfg, "w") as f:
            yaml.safe_dump(extras_run_config(f"wx_{tag}"), f)
        t0 = time.perf_counter()
        out = run_cli(cpu + extra + ["--launches", cfg])
        runs[tag] = {"sec": time.perf_counter() - t0,
                     "reports": [json.loads(ln.split("launches ", 1)[1])
                                 for ln in out.splitlines() if ln.startswith(
                                     "[exp_tpu_torch] launches ")]}
    one, many = (os.path.join(wd, f"wx_{t}") for t in ("one", "many"))
    files = {t: sorted(f for f in os.listdir(d) if not f.endswith(".yml"))
             for t, d in (("one", one), ("many", many))}
    return {"ranks": ranks, "files": files,
            "difference": {f: file_difference(os.path.join(many, f),
                                              os.path.join(one, f))
                           for f in files["one"] if f in files["many"]},
            "runs": runs}


def outvel_rank(rank, port, wd, devs, backend):
    """One rank of outvel_world: OutVel's gather on its row block of the
    sample in `wd`/sample.npz under the tables in `wd`/tables.pkl (a
    driver-like object holding the state, the force and the world);
    rank 0 saves the summed coefficients to `wd`/outvel.npz."""
    import pickle

    from exp_tpu_torch.bench_sphere import sphere_force
    from exp_tpu_torch.parallel.distributed import (finalize_distributed,
                                                    init_distributed,
                                                    pad_global_count,
                                                    ps_from_local, row_block)

    world = init_distributed(coordinator=f"127.0.0.1:{port}",
                             num_processes=len(devs), process_id=rank,
                             device=devs[rank], backend=backend,
                             timeout=TIMEOUT)
    try:
        with open(os.path.join(wd, "tables.pkl"), "rb") as f:
            tables = pickle.load(f)
        z = np.load(os.path.join(wd, "sample.npz"))
        ng = pad_global_count(len(z["m"]), world)
        lo, hi = row_block(ng, world)
        ps = ps_from_local(z["x"][lo:hi], z["v"][lo:hi], z["m"][lo:hi],
                           world, ng, lo)
        coefs = outvel_gather(sphere_force(tables, world.device), ps, wd,
                              world)
        if world.is_primary:
            np.savez(os.path.join(wd, "outvel.npz"), **coefs)
    finally:
        finalize_distributed()


def outvel_gather(force, ps, outdir, world=None):
    """OutVel's gather of the state `ps` (a driver-like object with the one
    component 'halo' under `force`, on `world`): its coefficients, summed
    over the ranks, without the HDF5 write."""
    from types import SimpleNamespace

    from exp_tpu_torch.nbody.output import OutVel

    sim = SimpleNamespace(components={"halo": SimpleNamespace(force=force)},
                          _state={"halo": ps}, outdir=outdir, runtag="wx",
                          world=world, is_primary=world is None
                          or world.is_primary)
    o = OutVel(sim, nint=1, name="halo")
    o.gather(sim)
    return o._coefs


def outvel_world(tables, x, v, m, ranks, devs=None, backend=None,
                 device=None):
    """OutVel's gather over `ranks` spawned ranks against one rank's on
    the first rank's device: each field's max|dc| over the size of its
    terms, and over the field's own max|c|, and the world's seconds.  The
    size of a velocity field's terms is the largest coefficient of the
    same projection with |v| in place of v: an equilibrium's velocity
    fields cancel to the sample's noise, so their own max|c| is not the
    scale of their sums' rounding (as outlog_difference scales the L
    columns by |L|); the density field's is its own max|c|."""
    import pickle

    from exp_tpu_torch.bench_sphere import sphere_force
    from exp_tpu_torch.nbody.particles import ParticleSystem

    if devs is None:
        devs, backend = world_devices(ranks, device)
    with tempfile.TemporaryDirectory(prefix="bench_multirank_") as wd:
        force = sphere_force(tables, devs[0])
        ref, size = (outvel_gather(force, ParticleSystem.from_arrays(
            x, u, m, device=devs[0]), wd) for u in (v, np.abs(v)))
        with open(os.path.join(wd, "tables.pkl"), "wb") as f:
            pickle.dump(tables, f)
        np.savez(os.path.join(wd, "sample.npz"), x=x, v=v, m=m)
        t0 = time.perf_counter()
        spawn_world(outvel_rank, (free_port(), wd, devs, backend), ranks)
        sec = time.perf_counter() - t0
        z = dict(np.load(os.path.join(wd, "outvel.npz")))

    def err(k, scale):
        return float(np.abs(z[k] - ref[k]).max()
                     / max(np.abs(scale[k]).max(), 1e-30))
    return {"ranks": ranks, "backend": backend, "sec": sec,
            "fields": sorted(ref),
            "rel_err": {k: err(k, size) for k in ref},
            "rel_err_own_max": {k: err(k, ref) for k in ref}}


def _main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("sphere", "flagship", "extras"))
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--n-halo", type=int, default=786_432)
    ap.add_argument("--n-disk", type=int, default=262_144)
    ap.add_argument("--seed", type=int, default=3,
                    help="`flagship`: the DiskHalo IC seed")
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    if a.mode == "extras":
        from exp_tpu_torch.basis.model import hernquist_model
        from exp_tpu_torch.bench_extras import write_model_exact
        from exp_tpu_torch.bench_sphere import equilibrium_sample
        from exp_tpu_torch.nbody.particles import write_ascii_bodies

        with tempfile.TemporaryDirectory(prefix="bench_multirank_") as wd:
            write_model_exact(hernquist_model(rmin=1e-3, rmax=20.0),
                              os.path.join(wd, "halo.model"))
            write_ascii_bodies(os.path.join(wd, "sphere.bods"),
                               equilibrium_sample(a.n, seed=0))
            res = extras_world(wd, a.ranks, a.device)
    elif a.mode == "sphere":
        from exp_tpu_torch.bench_sphere import (equilibrium_sample,
                                                sphere_tables)

        x, v, m = equilibrium_sample(a.n, seed=0)
        res = sphere_world(sphere_tables(4, 10), x, v, m, a.ranks, a.steps,
                           a.device)
    else:
        from exp_tpu_torch import bench_composite as bc
        from exp_tpu_torch.bench_extras import write_bodies

        dev = world_devices(1, a.device)[0][0]
        s = bc.prepare(a.n_halo, a.n_disk, dev, seed=a.seed)
        with tempfile.TemporaryDirectory(prefix="bench_multirank_") as wd:
            write_bodies(wd, s["ic"])
            res = flagship_world(wd, a.ranks, a.device)
    print(json.dumps(res))


if __name__ == "__main__":
    _main()
