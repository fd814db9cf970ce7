"""The disk problem of the benches (port of bench_suite.py :147-180): EOF
cylinder tables (mmax=6, nmax=18, 256 x 128 grid, fiducial lmax 32 / nmax
24), the bench's exponential disk sample of 1,048,576 particles with its
rotation velocities, the KDK step timing loop, and a KDK run with its
energy and angular-momentum gates.

    python -m exp_tpu_torch.bench_disk bench [--n N] [--reps R]
    python -m exp_tpu_torch.bench_disk kdk [--n N] [--steps S] [--device D]
    python -m exp_tpu_torch.bench_disk profile [--n N] [--steps S]

`bench` prints one JSON line with the steady-state step time on a CUDA
device (a CPU run is refused: its time is no device metric).  `kdk` runs
init + S KDK steps at dt=1e-4 of the bench's sample on the named device
(the CPU takes the kernels' plain versions) and prints the energy drift,
the change of Lz and the virial ratios as one JSON line.  `profile` traces
S steady steps on the card with torch.profiler and prints the device time
by kernel and the device's busy share of the wall time.  Each builds the
EOF tables fresh on the host first (about half a minute on 8 cores).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from exp_tpu_torch import resolve_device
from exp_tpu_torch.bench_sphere import kdk_run, profile_force, timeit

N = 1_048_576
DT = 1e-4
MDISK = 0.05
ACYL, HCYL = 0.01, 0.002


def disk_tables(mmax=6, nmax=18, lmaxfid=32, nmaxfid=24, cachename=None):
    """EOF tables of the disk bench: the exponential sech^2 disk a=0.01,
    h=0.002 over the default 256 x 128 grid (built fresh unless
    `cachename` is given)."""
    from exp_tpu_torch.basis.empcyl import build_empcyl_tables

    return build_empcyl_tables(mmax=mmax, nmax=nmax, lmaxfid=lmaxfid,
                               nmaxfid=nmaxfid, acyl=ACYL, hcyl=HCYL,
                               cachename=cachename)


def disk_sample(n=N, seed=2):
    """The bench's disk: sample_exponential_disk(mass=0.05, seed=2) with
    rotation velocities from the Plummer-softened circular speed of the
    bench (so both packages draw identical populations)."""
    from exp_tpu_torch.ic.disk import disk_velocities, sample_exponential_disk

    x, mass = sample_exponential_disk(n, acyl=ACYL, hcyl=HCYL, mass=MDISK,
                                      seed=seed)
    v = disk_velocities(x, lambda R: np.sqrt(MDISK * R * R
                                             / (R * R + ACYL ** 2) ** 1.5),
                        acyl=ACYL)
    return x, v, mass


def disk_force(tables, device=None):
    """The bench's force: CylinderForce(backend='pallas') with its default
    ncx=64, 'spline' x interpolation and 'default' precision."""
    from exp_tpu_torch.forces.cylinder import CylinderForce

    return CylinderForce.from_tables(tables, dtype=torch.float32,
                                     backend="pallas", device=device)


def bench_disk(n=N, reps=20, tables=None, device=None):
    """EOF cylinder (pallas backend) KDK step throughput on a CUDA device."""
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_disk times the card: give it a CUDA device")
    t = tables if tables is not None else disk_tables()
    force = disk_force(t, device)
    x, v, mass = disk_sample(n)
    ps = ParticleSystem.from_arrays(x, v, mass, device=device)
    ps, _, _ = init_force_state(force, ps)
    step = make_kdk_step(force, DT)
    sec, spread = timeit(lambda: step(ps), torch.cuda.synchronize, reps)
    return {"metric": "disk_particle_steps_per_sec", "value": n / sec,
            "unit": "1/s", "step_ms": sec * 1e3, "n_particles": n,
            "mmax": t.mmax, "nmax": t.nmax, "spread_pct": spread * 100,
            "device": torch.cuda.get_device_name(device)}


def _main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("bench", "kdk", "profile"))
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    if a.mode == "bench":
        print(json.dumps(bench_disk(a.n, a.reps, device=a.device)))
        return
    device = resolve_device(a.device)
    force = disk_force(disk_tables(), device)
    x, v, mass = disk_sample(a.n)
    if a.mode == "profile":
        print(json.dumps(profile_force(force, x, v, mass, DT,
                                       min(a.steps, 20), device)))
        return
    out = kdk_run(force, x, v, mass, steps=a.steps, dt=DT, device=device)
    out["device"] = str(device)
    print(json.dumps(out))


if __name__ == "__main__":
    _main()
