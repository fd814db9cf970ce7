"""CLI runner: `python -m exp_tpu_torch.run config.yml` (port of
exp_tpu/run.py, the `exp` executable).

Equivalent of the reference's `mpirun exp config.yml` entry point
(src/expand.cc:169-188) — parses the YAML config, builds the simulation,
echoes the parsed parameters to config.<runtag>.yml, runs nsteps.  The run
is on the CUDA card unless `--cpu` or `--device cpu` is given; with no card
and neither flag it refuses.  `--ndev` above 1 and `--distributed` (the
multi-device and multi-process runs) raise NotImplementedError (ROADMAP
item 12).
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
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
                    help="number of devices (one is ported)")
    ap.add_argument("--wall", type=float, default=None,
                    help="wall-clock budget in seconds (checkpoint + stop)")
    ap.add_argument("--restart-cmd", default=None,
                    help="command launched after a wall-clock stop")
    ap.add_argument("--distributed", action="store_true",
                    help="join a multi-process world (not ported)")
    ap.add_argument("-v", "--version", action="version",
                    version=_version_string())
    args = ap.parse_args(argv)

    if (args.ndev or 1) > 1 or args.distributed:
        raise NotImplementedError(
            "multi-device and multi-process runs are not ported "
            "(ROADMAP item 12)")
    device = "cpu" if args.cpu else args.device

    from exp_tpu_torch.nbody.output import restore_checkpoint
    from exp_tpu_torch.nbody.simulation import Simulation

    sim = Simulation.from_file(args.config, device=device)
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
    sim.config.dump(os.path.join(sim.outdir, f"config.{sim.runtag}.yml"))
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
        print(f"[exp_tpu_torch] restoring from {chk}"
              + (" (restart_as_new: t=0, fresh outputs)" if as_new else ""))
        restore_checkpoint(sim, chk, as_new=as_new)

    t0 = time.time()
    sim.prime()
    print(f"[exp_tpu_torch] primed in {time.time()-t0:.1f}s; "
          f"{sum(c.ps.n for c in sim.components.values())} particles on "
          f"{sim.device}")

    t0 = time.time()
    sim.run(args.nsteps)
    dtw = time.time() - t0
    n = sum(c.ps.n for c in sim.components.values())
    nst = sim.nsteps if args.nsteps is None else args.nsteps
    print(f"[exp_tpu_torch] {nst} steps in {dtw:.2f}s "
          f"({n*nst/max(dtw,1e-9):.3g} particle-steps/s)")
    return sim


def _version_string():
    return "exp_tpu_torch (the PyTorch + CUDA port of exp_tpu)"


if __name__ == "__main__":
    main()
