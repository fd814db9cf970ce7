"""The periodic-cube problem of the benches (port of bench_suite.py
:317-338, config #4): the plane-wave Cube at nmax = 6 on each axis with
backend='pallas', a uniform unit-box sample of 4,194,304 particles
(sample_cube(seed=5), sigma = 1), dt = 1e-3; the KDK step timing loop, and
a KDK run with its energy and momentum gates.

    python -m exp_tpu_torch.bench_cube bench [--n N] [--reps R] [--backend B]
    python -m exp_tpu_torch.bench_cube kdk [--n N] [--steps S] [--device D]
    python -m exp_tpu_torch.bench_cube profile [--n N] [--steps S] [--backend B]

`bench` prints one JSON line with the steady-state step time on a CUDA
device (a CPU run is refused: its time is no device metric).  `kdk` runs
init + S KDK steps at dt=1e-3 of the perturbed sample (PERTURBED: sigma =
0.1 and a 50% density wave along x, on which the force does work) on the
named device (the CPU takes the kernels' plain versions) and prints the
energies, the energy drift, the momentum and the virial ratios as one JSON
line.  `profile` traces S steady steps of the bench's sample on the card
with torch.profiler and prints the device time by kernel and the device's
busy share of the wall time.  `--backend einsum` swaps the kernels for the
plain-torch einsum path, the default of a YAML run
(nbody/simulation.py `backend: einsum`), to record it beside them.
"""

from __future__ import annotations

import argparse
import json

import torch

from exp_tpu_torch import resolve_device
from exp_tpu_torch.bench_sphere import kdk_run, profile_force, timeit

N = 4_194_304
NMAX = 6
DT = 1e-3
SEED = 5
#: the perturbed sample of the KDK run: cold (sigma 0.1) with the density
#: 1 + 0.5 cos(2 pi x), so the single mode k = (1, 0, 0) dominates the field
PERTURBED = {"sigma": 0.1, "pert_k": (1, 0, 0), "pert_amp": 0.5}


def cube_sample(n=N, perturbed=False, seed=SEED):
    """The bench's sample, sample_cube(n, seed=5), or the perturbed one."""
    from exp_tpu_torch.ic.cubeics import sample_cube

    return sample_cube(n, seed=seed, **(PERTURBED if perturbed else {}))


def cube_force(device=None, backend="pallas", pallas_version=2):
    """The bench's force: Cube.create(6, 6, 6), f32, 'mixed' precision, on
    `device` (None: CUDA)."""
    from exp_tpu_torch.forces.cube import Cube

    return Cube.create(NMAX, NMAX, NMAX, dtype=torch.float32,
                       backend=backend, pallas_version=pallas_version,
                       device=device)


def bench_cube(n=N, reps=20, backend="pallas", device=None):
    """Cube KDK step throughput on a CUDA device."""
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_cube times the card: give it a CUDA device")
    force = cube_force(device, backend)
    x, v, mass = cube_sample(n)
    ps = ParticleSystem.from_arrays(x, v, mass, device=device)
    ps, _, _ = init_force_state(force, ps)
    step = make_kdk_step(force, DT)
    sec, spread = timeit(lambda: step(ps), torch.cuda.synchronize, reps)
    return {"metric": "cube_particle_steps_per_sec", "value": n / sec,
            "unit": "1/s", "step_ms": sec * 1e3, "n_particles": n,
            "nmax": NMAX, "backend": backend, "spread_pct": spread * 100,
            "device": torch.cuda.get_device_name(device)}


def _main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("bench", "kdk", "profile"))
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", choices=("pallas", "einsum"),
                    default="pallas")
    a = ap.parse_args()
    if a.mode == "bench":
        print(json.dumps(bench_cube(a.n, a.reps, a.backend, device=a.device)))
        return
    device = resolve_device(a.device)
    force = cube_force(device, a.backend)
    if a.mode == "profile":
        x, v, mass = cube_sample(a.n)
        out = profile_force(force, x, v, mass, DT, min(a.steps, 20), device)
        out["backend"] = a.backend
        print(json.dumps(out))
        return
    x, v, mass = cube_sample(a.n, perturbed=True)
    out = kdk_run(force, x, v, mass, steps=a.steps, dt=DT, device=device)
    out.update(device=str(device), backend=a.backend)
    print(json.dumps(out))


if __name__ == "__main__":
    _main()
