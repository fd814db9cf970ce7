"""The sphere problem of the benches (port of bench_suite.py :84-144):
Hernquist tables, the benches' Hernquist-like sample, the KDK step timing
loop, and an equilibrium KDK run with its energy and virial gates.

    python -m exp_tpu_torch.bench_sphere bench [--n N] [--reps R]
    python -m exp_tpu_torch.bench_sphere kdk [--n N] [--steps S] [--device D]
    python -m exp_tpu_torch.bench_sphere profile [--n N] [--steps S]

`bench` prints one JSON line with the steady-state step time on a CUDA
device (a CPU run is refused: its time is no device metric).  `kdk` runs
init + S KDK steps of an equilibrium Hernquist sample on the named device
(the CPU takes the kernels' plain versions) and prints the energy drift
and virial ratios as one JSON line.  `profile` traces S steady steps on
the card with torch.profiler and prints the device time by kernel and the
device's busy share of the wall time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from exp_tpu_torch import resolve_device


def sphere_tables(lmax=4, nmax=10, numr=2000, cachename=None):
    """Spherical SL tables of the sphere benches: Hernquist a=1 M=1 over
    [1e-3, 20], cmap=1, rmap=1 (built fresh unless `cachename` is given)."""
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables

    m = hernquist_model(rmin=1e-3, rmax=20.0)
    return build_sph_sl_tables(m, lmax=lmax, nmax=nmax, numr=numr, cmap=1,
                               rmap=1.0, cachename=cachename)


def hernquist_sample_np(n, seed=0):
    """The benches' Hernquist-like phase-space sample (bench_suite's, so
    both packages draw identical populations from one seed)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.02, 0.98, n)
    r = u / (1 - u)
    ct = rng.uniform(-1, 1, n)
    st = np.sqrt(1 - ct * ct)
    ph = rng.uniform(0, 2 * np.pi, n)
    x = np.stack([r * st * np.cos(ph), r * st * np.sin(ph), r * ct], -1)
    v = rng.normal(0, 0.3, (n, 3))
    mass = np.full(n, 1.0 / n)
    return x, v, mass


def timeit(step, sync, reps, groups=5):
    """Steady-state timing: one warm-up call, then `reps` calls split into
    `groups` synchronised groups.  Returns (median seconds per call over
    the groups, (max - min) / median of the groups)."""
    step()
    sync()
    g = max(1, min(groups, reps))
    per = [reps // g + (1 if i < reps % g else 0) for i in range(g)]
    times = []
    for cnt in per:
        t0 = time.perf_counter()
        for _ in range(cnt):
            step()
        sync()
        times.append((time.perf_counter() - t0) / cnt)
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med


def bench_sphere(n=1_048_576, reps=20, lmax=4, nmax=10, dt=1e-3,
                 tables=None, device=None):
    """SphereSL (pallas backend) KDK step throughput on a CUDA device."""
    from exp_tpu_torch.forces.spherical import SphereSL
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_sphere times the card: give it a CUDA "
                           "device")
    t = tables if tables is not None else sphere_tables(lmax, nmax)
    force = SphereSL.from_tables(t, dtype=torch.float32, backend="pallas",
                                 device=device)
    x, v, mass = hernquist_sample_np(n)
    ps = ParticleSystem.from_arrays(x, v, mass, device=device)
    ps, _, _ = init_force_state(force, ps)
    step = make_kdk_step(force, dt)
    sec, spread = timeit(lambda: step(ps), torch.cuda.synchronize, reps)
    return {"metric": "sphere_particle_steps_per_sec", "value": n / sec,
            "unit": "1/s", "step_ms": sec * 1e3, "n_particles": n,
            "lmax": lmax, "nmax": nmax, "spread_pct": spread * 100,
            "device": torch.cuda.get_device_name(device)}


def equilibrium_sample(n, seed=0):
    """An equilibrium (Eddington) sample of the tables' Hernquist model."""
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.ic.eddington import sample_spherical_model

    return sample_spherical_model(hernquist_model(rmin=1e-3, rmax=20.0), n,
                                  seed=seed)


def kdk_run(force, x, v, mass, steps=50, dt=1e-3, device=None):
    """init_force_state + `steps` KDK steps of (x, v, mass) under `force`.

    Returns the first and last energies, the relative drift of
    Etot = KE + PE, the virial ratio 2T/VC at both ends, and whether every
    value of the final state is finite."""
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import energies, init_force_state, make_kdk_step

    ps = ParticleSystem.from_arrays(x, v, mass, device=resolve_device(device))
    ps, _, diag = init_force_state(force, ps)
    e0 = energies(diag)
    step = make_kdk_step(force, dt)
    for _ in range(steps):
        ps, coef, diag = step(ps)
    e1 = energies(diag)
    finite = all(bool(torch.isfinite(a).all())
                 for a in (ps.x, ps.v, ps.acc, ps.pot, coef))
    return {"steps": steps, "dt": dt, "n": int(ps.n),
            "Etot0": e0["Etot"], "Etot1": e1["Etot"],
            "dE_rel": abs(e1["Etot"] - e0["Etot"]) / abs(e0["Etot"]),
            "virial0": e0["2T/VC"], "virial1": e1["2T/VC"], "finite": finite}


def profile_step(n=1_048_576, steps=10, tables=None, device=None):
    """Device time per step by kernel (ms) from torch.profiler over `steps`
    steady KDK steps of the benches' sample on a CUDA device, and the
    device-busy share: that device time over the step time measured
    without the profiler (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    from exp_tpu_torch.forces.spherical import SphereSL
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    device = resolve_device(device)
    t = tables if tables is not None else sphere_tables()
    force = SphereSL.from_tables(t, backend="pallas", device=device)
    x, v, mass = hernquist_sample_np(n)
    ps = ParticleSystem.from_arrays(x, v, mass, device=device)
    ps, _, _ = init_force_state(force, ps)
    step = make_kdk_step(force, 1e-3)
    for _ in range(10):
        step(ps)
    sec, _ = timeit(lambda: step(ps), torch.cuda.synchronize, 30)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(ps)
        torch.cuda.synchronize()
    by_kernel, launches = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3 / steps)
            launches += 1
    dev_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    return {"step_ms": sec * 1e3, "device_ms_per_step": dev_ms,
            "device_busy": dev_ms / (sec * 1e3),
            "device_launches_per_step": launches / steps,
            "top": [{"name": k[:90], "ms": ms} for k, ms in top[:15]]}


def _main():
    from exp_tpu_torch.forces.spherical import SphereSL

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("bench", "kdk", "profile"))
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    if a.mode == "bench":
        print(json.dumps(bench_sphere(a.n, a.reps, device=a.device)))
        return
    if a.mode == "profile":
        print(json.dumps(profile_step(a.n, min(a.steps, 20),
                                      device=a.device)))
        return
    device = resolve_device(a.device)
    force = SphereSL.from_tables(sphere_tables(), backend="pallas",
                                 device=device)
    x, v, mass = equilibrium_sample(a.n)
    out = kdk_run(force, x, v, mass, steps=a.steps, device=device)
    out["device"] = str(device)
    print(json.dumps(out))


if __name__ == "__main__":
    _main()
