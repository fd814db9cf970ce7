"""The periodic-slab problem: the geometry of exp_tpu's slab measurements
(doc/benchmarks.md:102-117, scripts/probe_slab_decomp.py:33-49) and of its
YAML defaults (nbody/simulation.py:168-187): build_slab_tables(nmaxx=4,
nmaxy=4, nmax=6, zmax=0.1, h=0.01, numz=401), method 'greens', type 'iso';
SlabForce with backend='pallas', nzc=126, pallas_interp='spline'; an
isothermal (Spitzer) sheet of 1,048,576 particles, sample_slab(n,
z0=0.01, seed=11), whose scale height equals the tables' h, so it is an
equilibrium of its own mean field; dt = 1e-3.  The KDK step timing loop,
and a KDK run with its energy, momentum and thickness gates.

    python -m exp_tpu_torch.bench_slab bench [--n N] [--reps R] [--backend B]
    python -m exp_tpu_torch.bench_slab kdk [--n N] [--steps S] [--device D]
    python -m exp_tpu_torch.bench_slab profile [--n N] [--steps S] [--backend B]

`bench` prints one JSON line with the steady-state step time on a CUDA
device (a CPU run is refused: its time is no device metric).  `kdk` runs
init + S KDK steps of the bench's sample on the named device (the CPU takes
the kernels' plain versions) and prints the energies, the energy drift, the
momentum, the sheet's rms thickness and the virial ratios as one JSON line.
`profile` traces S steady steps on the card with torch.profiler and prints
the device time by kernel and the device's busy share of the wall time.
`--backend einsum` swaps the kernels for the plain-torch einsum path, the
default of a YAML run (nbody/simulation.py:187 `backend: einsum`), to
record it beside them; its (N, 9, 9, 6) complex intermediates take about
4 GB each at 2^20 particles.
"""

from __future__ import annotations

import argparse
import json

import torch

from exp_tpu_torch import resolve_device
from exp_tpu_torch.bench_sphere import profile_force, timeit

N = 1_048_576
NMAXXY = 4
NMAX = 6
ZMAX = 0.1
H = 0.01
NUMZ = 401
NZC = 126
DT = 1e-3
Z0 = 0.01
SEED = 11


def slab_tables():
    """The bench's tables (Green's construction, isothermal profile),
    built on the host in about a second."""
    from exp_tpu_torch.basis.slab import build_slab_tables

    return build_slab_tables(nmaxx=NMAXXY, nmaxy=NMAXXY, nmax=NMAX, zmax=ZMAX,
                             h=H, numz=NUMZ)


def slab_sample(n=N, seed=SEED):
    """The bench's sample: genslab's sheet at z0 = h, (x, v, mass)."""
    from exp_tpu_torch.ic.slab import sample_slab

    return sample_slab(n, z0=Z0, seed=seed)


def slab_outside_sample(n, seed=SEED):
    """Half of the particles inside the slab, half at zmax < |z| <= 3 zmax
    of both signs (tests/test_slab_pallas.py:86-111), (x, mass): the
    sheet has none outside, so this sample times K10's vacuum branch."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h = n // 2
    z_out = rng.uniform(ZMAX, 3 * ZMAX, n - h) * rng.choice([-1, 1], n - h)
    z = np.concatenate([rng.normal(0, 0.02, h), z_out])
    x = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n), z], -1)
    return x, rng.uniform(0.5, 1.5, n) / n


def truncated_sheet(n, seed=0, h=H, zmax=ZMAX):
    """The sech^2(z/h) sheet truncated at |z| = zmax, uniform in (x, y),
    unit surface density: (x (n, 3), mass (n,)), drawn as
    tests/test_slab.py::_sample draws it.  Its mean field is
    g_z = -2 pi tanh(z/h) inside (to the truncation's 1 - tanh(zmax/h)),
    and -2 pi tanh(zmax/h) sign(z) outside."""
    import numpy as np

    rng = np.random.default_rng(seed)
    z = h * np.arctanh(rng.uniform(-1, 1, n) * np.tanh(zmax / h))
    x = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n), z], -1)
    return x, np.full(n, 1.0 / n)


def slab_force(tables=None, device=None, backend="pallas"):
    """The bench's force, f32, on `device` (None: CUDA)."""
    from exp_tpu_torch.forces.slab import SlabForce

    t = tables if tables is not None else slab_tables()
    return SlabForce.from_tables(t, dtype=torch.float32, backend=backend,
                                 nzc=NZC, pallas_interp="spline",
                                 device=device)


def bench_slab(n=N, reps=20, backend="pallas", tables=None, device=None):
    """Slab KDK step throughput on a CUDA device."""
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_slab times the card: give it a CUDA device")
    force = slab_force(tables, device, backend)
    x, v, mass = slab_sample(n)
    ps = ParticleSystem.from_arrays(x, v, mass, device=device)
    ps, _, _ = init_force_state(force, ps)
    step = make_kdk_step(force, DT)
    sec, spread = timeit(lambda: step(ps), torch.cuda.synchronize, reps)
    return {"metric": "slab_particle_steps_per_sec", "value": n / sec,
            "unit": "1/s", "step_ms": sec * 1e3, "n_particles": n,
            "nmaxx": NMAXXY, "nmaxy": NMAXXY, "nmax": NMAX,
            "backend": backend, "spread_pct": spread * 100,
            "device": torch.cuda.get_device_name(device)}


def _state(ps, diag):
    """Energies, momentum and the sheet's rms thickness of a state."""
    from exp_tpu_torch.nbody.step import energies

    mom = diag["mom"].double().cpu()
    zrms = float(torch.sqrt(torch.mean(ps.x[:, 2].double() ** 2)))
    return energies(diag), mom, zrms


def slab_run(force, x, v, mass, steps=50, dt=DT, device=None):
    """init_force_state + `steps` KDK steps of (x, v, mass) under `force`.

    Returns the first and last energies and the relative drift of
    Etot = KE + PE, the virial ratio 2T/VC at both ends (x . a of unwrapped
    periodic positions is no virial: reported only), the horizontal
    momentum (sum m v_x, sum m v_y) at both ends and the norm of its
    change, sum m v_z at both ends, the rms z at both ends and its
    relative change, and whether every value of the final state is
    finite."""
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    ps = ParticleSystem.from_arrays(x, v, mass, device=resolve_device(device))
    ps, _, diag = init_force_state(force, ps)
    e0, p0, z0 = _state(ps, diag)
    step = make_kdk_step(force, dt)
    for _ in range(steps):
        ps, coef, diag = step(ps)
    e1, p1, z1 = _state(ps, diag)
    finite = all(bool(torch.isfinite(a).all())
                 for a in (ps.x, ps.v, ps.acc, ps.pot, coef))
    return {"steps": steps, "dt": dt, "n": int(ps.n),
            "KE0": e0["KE"], "PE0": e0["PE"], "KE1": e1["KE"],
            "PE1": e1["PE"], "Etot0": e0["Etot"], "Etot1": e1["Etot"],
            "dE_rel": abs(e1["Etot"] - e0["Etot"]) / abs(e0["Etot"]),
            "virial0": e0["2T/VC"], "virial1": e1["2T/VC"],
            "Pxy0": p0[:2].tolist(), "Pxy1": p1[:2].tolist(),
            "dPxy": float((p1[:2] - p0[:2]).norm()),
            "Pz0": float(p0[2]), "Pz1": float(p1[2]),
            "zrms0": z0, "zrms1": z1, "dzrms_rel": abs(z1 / z0 - 1.0),
            "finite": finite}


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
        print(json.dumps(bench_slab(a.n, a.reps, a.backend, device=a.device)))
        return
    device = resolve_device(a.device)
    force = slab_force(device=device, backend=a.backend)
    x, v, mass = slab_sample(a.n)
    if a.mode == "profile":
        out = profile_force(force, x, v, mass, DT, min(a.steps, 20), device)
    else:
        out = slab_run(force, x, v, mass, steps=a.steps, device=device)
        out["device"] = str(device)
    out["backend"] = a.backend
    print(json.dumps(out))


if __name__ == "__main__":
    _main()
