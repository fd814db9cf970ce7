"""CLI runner: `python -m exp_tpu_torch.run config.yml` (port of
exp_tpu/run.py, the `exp` executable).

Equivalent of the reference's `mpirun exp config.yml` entry point
(src/expand.cc:169-188) — parses the YAML config, builds the simulation,
echoes the parsed parameters to config.<runtag>.yml, runs nsteps.  The run
is on the CUDA card unless `--cpu` or `--device cpu` is given; with no card
and neither flag it refuses.

Several ranks, one process per device (parallel/distributed.py):

    python -m exp_tpu_torch.run --ndev k config.yml
        spawns k local ranks (torch.multiprocessing, spawn), rank r on card
        r: NCCL when there are k cards, else gloo with the ranks sharing
        the cards round robin (NCCL refuses two ranks on one card);
        with --cpu, k ranks on the CPU over gloo
    EXP_COORDINATOR=host:port EXP_NPROCS=k EXP_PROCID=r \
        python -m exp_tpu_torch.run --distributed config.yml
        joins a world whose ranks were started apart (torch's env://
        variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK where the
        EXP_* ones are unset)

EXP_BACKEND=nccl|gloo overrides the choice of a --distributed rank.  A
rank that fails ends the run with a non-zero exit: a spawned world is
torn down, and a rank of a --distributed world waiting on a collective
fails at its timeout (EXP_TIMEOUT seconds, 900 by default).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _parser():
    ap = argparse.ArgumentParser(
        prog="exp_tpu_torch.run",
        description="BFE N-body run from a YAML config, on a CUDA card")
    ap.add_argument("config", help="YAML run configuration")
    ap.add_argument("-n", "--nsteps", type=int, default=None,
                    help="override Global.nsteps")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--ndev", type=int, default=None,
                    help="spawn this many local ranks, one per device")
    ap.add_argument("--wall", type=float, default=None,
                    help="wall-clock budget in seconds (checkpoint + stop)")
    ap.add_argument("--restart-cmd", default=None,
                    help="command launched after a wall-clock stop")
    ap.add_argument("--distributed", action="store_true",
                    help="join a multi-process world from EXP_COORDINATOR "
                         "/ EXP_NPROCS / EXP_PROCID (or torch's env://)")
    ap.add_argument("--launches", action="store_true",
                    help="print each rank's kernel launch counts and "
                         "bucket shapes at the end (one JSON line a rank)")
    ap.add_argument("-v", "--version", action="version",
                    version=_version_string())
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    if (args.ndev or 1) > 1:
        if args.distributed:
            ap.error("--ndev and --distributed exclude each other")
        _spawn(args, list(argv) if argv is not None else sys.argv[1:])
        return None
    world = None
    if args.distributed:
        from exp_tpu_torch.parallel.distributed import init_distributed

        world = init_distributed(device=device)
    try:
        return _run(args, device, world)
    finally:
        if world is not None:
            from exp_tpu_torch.parallel.distributed import (
                finalize_distributed)

            finalize_distributed()


def _spawn(args, argv):
    """k local ranks of this same command line, without --ndev."""
    import socket

    import torch
    import torch.multiprocessing as mp

    k = int(args.ndev)
    on_cpu = args.cpu or (args.device or "").startswith("cpu")
    ncard = 0 if on_cpu else torch.cuda.device_count()
    if not on_cpu and ncard == 0:
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "the ranks on the CPU")
    backend = "nccl" if ncard >= k else "gloo"
    if ncard and ncard < k:
        print(f"[exp_tpu_torch] --ndev {k} on {ncard} card(s): the ranks "
              f"share the cards round robin, over {backend}", flush=True)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    rest = [a for i, a in enumerate(argv) if a != "--ndev"
            and not a.startswith("--ndev=")
            and not (i > 0 and argv[i - 1] == "--ndev")]
    mp.spawn(_rank_main, args=(rest, k, port, ncard, backend), nprocs=k,
             join=True)


def _rank_main(rank, argv, k, port, ncard, backend):
    """One spawned rank: join the world, then the run of `argv`."""
    os.environ.update(EXP_COORDINATOR=f"127.0.0.1:{port}", EXP_NPROCS=str(k),
                      EXP_PROCID=str(rank))
    args = _parser().parse_args(argv)
    device = f"cuda:{rank % ncard}" if ncard else "cpu"
    from exp_tpu_torch.parallel.distributed import (finalize_distributed,
                                                    init_distributed)

    world = init_distributed(device=device, backend=backend)
    try:
        _run(args, device, world)
    finally:
        finalize_distributed()


def _run(args, device, world):
    """The run of one process: on `device`, or on this rank of `world`."""
    from exp_tpu_torch.nbody.output import restore_checkpoint
    from exp_tpu_torch.nbody.simulation import Simulation

    sim = Simulation.from_file(args.config, device=device, world=world)
    g = sim.config.glob
    # process niceness / address-space limit (reference NICE + rlimit,
    # parse.cc:100-102, expand.cc:132-142)
    if getattr(g, "NICE", 0) > 0:
        try:
            os.nice(g.NICE)
        except OSError as e:
            print(f"[exp_tpu_torch] NICE={g.NICE} failed: {e}")
    if getattr(g, "rlimit", 0):
        import resource

        lim = (resource.RLIM_INFINITY if g.rlimit < 0
               else int(g.rlimit) * 1024 ** 3)
        try:
            resource.setrlimit(resource.RLIMIT_AS, (lim, lim))
        except (ValueError, OSError) as e:
            print(f"[exp_tpu_torch] rlimit={g.rlimit} failed: {e}")
    if sim.is_primary:      # the parameter echo, once
        sim.config.dump(os.path.join(sim.outdir,
                                     f"config.{sim.runtag}.yml"))
    # CLI overrides take precedence over the Global runtime/restart_cmd keys
    if args.wall is not None:
        sim.wall_limit = args.wall
    if args.restart_cmd is not None:
        sim.restart_cmd = args.restart_cmd
    sim.install_signal_handlers()

    if sim.config.glob.infile:
        # checkpoints are written to outdir; accept a workdir-relative
        # path too (absolute paths pass through os.path.join unchanged)
        chk = os.path.join(sim.outdir, sim.config.glob.infile)
        if not os.path.exists(chk):
            alt = os.path.join(sim.workdir, sim.config.glob.infile)
            chk = alt if os.path.exists(alt) else chk
        if not os.path.exists(chk):
            raise FileNotFoundError(
                f"infile restart checkpoint not found: {chk} — refusing "
                f"to silently start a fresh run over the old outputs")
        as_new = bool(getattr(g, "restart_as_new", False))
        if sim.is_primary:
            print(f"[exp_tpu_torch] restoring from {chk}"
                  + (" (restart_as_new: t=0, fresh outputs)" if as_new
                     else ""))
        restore_checkpoint(sim, chk, as_new=as_new)

    t0 = time.time()
    sim.prime()
    n = sum(c.ps.n for c in sim.components.values())
    if world is not None:
        from exp_tpu_torch.parallel.distributed import sum_host

        n = int(sum_host([n], world)[0])
    where = (f"{sim.device}" if world is None else
             f"{world.size} rank{'s' * (world.size > 1)} ({world.backend}; "
             f"rank 0 on {sim.device})")
    if sim.is_primary:
        print(f"[exp_tpu_torch] primed in {time.time()-t0:.1f}s; "
              f"{n} particles on {where}")

    t0 = time.time()
    sim.run(args.nsteps)
    dtw = time.time() - t0
    nst = sim.nsteps if args.nsteps is None else args.nsteps
    if sim.is_primary:
        print(f"[exp_tpu_torch] {nst} steps in {dtw:.2f}s "
              f"({n*nst/max(dtw,1e-9):.3g} particle-steps/s)")
    if args.launches:
        # the line in one write: the ranks of a spawned world share their
        # parent's stdout, and a pipe keeps a write of up to 4096 bytes
        # whole, where print's two writes (the text, then the newline)
        # may interleave with another rank's
        sys.stdout.flush()
        sys.stdout.write(f"[exp_tpu_torch] launches "
                         f"{_launch_report(sim, world)}\n")
        sys.stdout.flush()
    return sim


def _launch_report(sim, world):
    """This rank's kernel launch counts since the process started, the
    counts when each adaptive basis rebuild ran, and, under multistep, its
    buckets' capacities and live counts, as JSON."""
    import json

    from exp_tpu_torch.ops import (cube_kernels, cyl_kernels, slab_kernels,
                                   sphere_kernels)

    rep = {"rank": 0 if world is None else world.rank,
           "launches": {k: v for mod in (sphere_kernels, cyl_kernels,
                                         cube_kernels, slab_kernels)
                        for k, v in mod.launch_counts.items()},
           "rebuilds": sim.rebuilds}
    if sim._ms_state is not None:
        rep["caps"] = {n: [int(b.x.shape[0]) for b in bs]
                       for n, bs in sim._ms_state.items()}
        rep["live"] = {n: [int((b.mass > 0).sum()) for b in bs]
                       for n, bs in sim._ms_state.items()}
    return json.dumps(rep)


def _version_string():
    return "exp_tpu_torch (the PyTorch + CUDA port of exp_tpu)"


if __name__ == "__main__":
    main()
