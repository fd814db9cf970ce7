"""The f64 comparator (exp_tpu_torch/validate.py ReferenceSphereStep)
against the port's sphere step: the configurations of chip_smoke.py's
phase VR1 and the CPU runs its kernel bounds come from.

  (a) the port's f64 'gather' SphereSL (deriv 'lerp', the comparator's
      hat-difference radial derivative) on the device against the
      comparator on the host, at tests/test_reference_comparator.py's
      problem (Hernquist over [1e-4, 20], lmax 2, nmax 8, numr 1000, cmap
      1, 2,000 bodies of seed 21, dt 0.005): one step's coefficients,
      accelerations and potential, and the coefficient trajectory over
      A_STEPS KDK steps;
  (b) the same problem through backend 'pallas' with the settings nearest
      the comparator's equations: pallas_interp 'hat' (hats and the cell
      difference for the derivative), pallas_precision 'highest', and the
      hats on the table's own nodes (numr_c = numr: the comparator's
      linear interpolation and derivative, in f32); an f32 state,
      B_STEPS KDK steps (K1 'hat' and K2 'hat', B_STEPS + 1 launches each
      on the card; their plain versions on the CPU), the coefficients of
      every step against the comparator's trajectory;
  (c) the sphere cell's tables (lmax 4, nmax 10, numr 2000) under (b)'s
      settings: one projection of equilibrium_sample(C_N) (one K1) and one
      force evaluation of the comparator's coefficients (one K2) against
      the comparator's, on the float32-rounded rows both are given.  The
      comparator runs in chunks of CHUNK rows on a pool of host threads.

    python -m exp_tpu_torch.bench_validate a|b|c [--device D] [--threads T]

prints one JSON line of the case's errors and times.  chip_smoke.py's
bounds for (b) and (c) are three times the figures of this script's run on
the CPU (`--device cpu`: the kernels' plain versions), the rule of its
MF1 and IC2 bounds; (a)'s gates are the JAX test's.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: (a): the steps of the trajectory and its record interval
A_STEPS, A_EVERY = 300, 25
#: (b): the steps, each recorded
B_STEPS = 25
DT = 0.005
#: (c): rows of the sample, and the comparator's chunk
C_N = 1 << 20
CHUNK = 1 << 17
#: (b) and (c): the pallas settings nearest the comparator's equations
#: (with numr_c the tables' numr)
HAT = {"backend": "pallas", "pallas_interp": "hat",
       "pallas_precision": "highest"}


def problem():
    """tests/test_reference_comparator.py's tables and sample."""
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
    from exp_tpu_torch.ic.eddington import sample_spherical_model

    m = hernquist_model(rmin=1e-4, rmax=20.0)
    t = build_sph_sl_tables(m, lmax=2, nmax=8, numr=1000, cmap=1, rmap=1.0)
    x, v, mass = sample_spherical_model(m, 2000, seed=21)
    return t, x, v, mass


def _chunks(n, chunk):
    return [slice(i, min(n, i + chunk)) for i in range(0, n, chunk)]


def ref_coefficients(ref, x, mass, chunk=CHUNK):
    """The comparator's coefficients of (x, mass), summed in row order over
    chunks computed on host threads (the same sum at any thread count)."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        parts = list(ex.map(lambda s: ref.coefficients(x[s], mass[s]),
                            _chunks(len(mass), chunk)))
    return sum(parts)


def ref_acceleration(ref, coef, x, chunk=CHUNK):
    """The comparator's (acc, pot) at x, by row chunks on host threads."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        parts = list(ex.map(lambda s: ref.acceleration(coef, x[s]),
                            _chunks(len(x), chunk)))
    return (np.concatenate([a for a, _ in parts]),
            np.concatenate([p for _, p in parts]))


def _host(t):
    return t.detach().cpu().numpy().astype(np.float64)


def rel(a, b):
    """max|a - b| / max|b|."""
    return float(np.abs(a - b).max() / np.abs(b).max())


def excess(a, b, rtol):
    """max(|a - b| - rtol |b|): at most atol where assert_allclose(a, b,
    rtol, atol) passes."""
    return float((np.abs(a - b) - rtol * np.abs(b)).max())


def reference_run(t, x, v, mass, steps):
    """The comparator's KDK trajectory, every step recorded:
    {step: coef}."""
    from exp_tpu_torch.validate import ReferenceSphereStep

    traj, _ = ReferenceSphereStep(t).run(x, v, mass, DT, steps)
    return dict(traj)


def port_run(force, x, v, mass, steps, dtype, device, every=1):
    """The port's init_force_state + `steps` KDK steps: {step: coef} of
    every `every`-th step (host f64), and the seconds of the steps."""
    import torch

    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    ps = ParticleSystem.from_arrays(x, v, mass, dtype=dtype, device=device)
    ps, _, _ = init_force_state(force, ps, accum_dtype=dtype)
    step = make_kdk_step(force, DT, accum_dtype=dtype)
    out = {}
    t0 = time.perf_counter()
    for k in range(1, steps + 1):
        ps, coef, _ = step(ps)
        if k % every == 0:
            out[k] = _host(coef)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drift(port, ref):
    """{step: max|c - c_ref| / max over the trajectory of |c_ref|}."""
    scale = max(np.abs(c).max() for c in ref.values())
    return {k: float(np.abs(c - ref[k]).max() / scale)
            for k, c in port.items()}


def case_a(device, prob=None, ref_traj=None):
    """(a): the f64 gather step on `device` against the comparator."""
    import torch

    from exp_tpu_torch.forces.spherical import SphereSL
    from exp_tpu_torch.validate import ReferenceSphereStep

    t, x, v, mass = prob or problem()
    ref = ReferenceSphereStep(t)
    f64 = dict(dtype=torch.float64, device=device)
    force = SphereSL.from_tables(t, backend="gather", deriv="lerp", **f64)
    c = _host(force.coefficients(torch.as_tensor(x, **f64),
                                 torch.as_tensor(mass, **f64),
                                 accum_dtype=torch.float64))
    c_ref = ref.coefficients(x, mass)
    a, p = force.acceleration(torch.as_tensor(c_ref, **f64),
                              torch.as_tensor(x, **f64))
    a_ref, p_ref = ref.acceleration(c_ref, x)
    rep = {"step_coef_rel": rel(c, c_ref),
           "step_acc_excess": excess(_host(a), a_ref, 1e-10),
           "step_pot_excess": excess(_host(p), p_ref, 1e-10),
           "step_acc_maxabs": float(np.abs(_host(a) - a_ref).max()),
           "step_pot_maxabs": float(np.abs(_host(p) - p_ref).max())}
    if ref_traj is None:
        ref_traj = reference_run(t, x, v, mass, A_STEPS)
    port, sec = port_run(force, x, v, mass, A_STEPS, torch.float64, device,
                         every=A_EVERY)
    d = drift(port, {k: ref_traj[k] for k in port})
    rep.update({"drift": {str(k): e for k, e in d.items()},
                "drift_25": d[25], "drift_max": max(d.values()),
                "steps_sec": sec})
    return rep


def case_b(device, prob=None, ref_traj=None):
    """(b): the pallas 'hat' 'highest' step (f32 state) on `device`
    against the comparator's trajectory.  Returns the report and the
    force."""
    import torch

    from exp_tpu_torch.forces.spherical import SphereSL

    t, x, v, mass = prob or problem()
    force = SphereSL.from_tables(t, numr_c=t.numr, device=device, **HAT)
    if ref_traj is None:
        ref_traj = reference_run(t, x, v, mass, B_STEPS)
    port, sec = port_run(force, x, v, mass, B_STEPS, torch.float32, device)
    d = drift(port, {k: ref_traj[k] for k in range(1, B_STEPS + 1)})
    return {"drift_25": d[B_STEPS], "drift_max": max(d.values()),
            "steps_sec": sec}, force


def case_c(device, tables=None, x=None, mass=None):
    """(c): one K1 projection and one K2 force evaluation at the sphere
    cell's width against the comparator's.  Returns the report and the
    inputs the kernels saw (for timing)."""
    import torch

    from exp_tpu_torch.bench_sphere import equilibrium_sample, sphere_tables
    from exp_tpu_torch.forces.spherical import SphereSL
    from exp_tpu_torch.validate import ReferenceSphereStep

    tables = tables if tables is not None else sphere_tables(4, 10)
    if x is None:
        x, _, mass = equilibrium_sample(C_N, seed=0)
    force = SphereSL.from_tables(tables, numr_c=tables.numr, device=device,
                                 **HAT)
    f32 = dict(dtype=torch.float32, device=device)
    x32, m32 = torch.as_tensor(x, **f32), torch.as_tensor(mass, **f32)
    # the comparator takes the float32-rounded rows the kernels take
    xr, mr = _host(x32), _host(m32)
    ref = ReferenceSphereStep(tables)
    t0 = time.perf_counter()
    c_ref = ref_coefficients(ref, xr, mr)
    a_ref, p_ref = ref_acceleration(ref, c_ref, xr)
    ref_sec = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = force.coefficients(x32, m32)
    a, p = force.acceleration(torch.as_tensor(c_ref, **f32), x32)
    if device.type == "cuda":
        torch.cuda.synchronize()
    port_sec = time.perf_counter() - t0
    rep = {"n": len(xr), "coef_rel": rel(_host(c), c_ref),
           "acc_rel": rel(_host(a), a_ref), "pot_rel": rel(_host(p), p_ref),
           "coef_maxabs": float(np.abs(_host(c) - c_ref).max()),
           "acc_maxabs": float(np.abs(_host(a) - a_ref).max()),
           "pot_maxabs": float(np.abs(_host(p) - p_ref).max()),
           "comparator_sec": ref_sec, "port_sec": port_sec}
    return rep, (force, x32, m32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=("a", "b", "c"))
    ap.add_argument("--device", default=None)
    ap.add_argument("--threads", type=int, default=None)
    a = ap.parse_args(argv)
    import torch

    from exp_tpu_torch import resolve_device

    if a.threads:
        torch.set_num_threads(a.threads)
    dev = resolve_device(a.device)
    t0 = time.perf_counter()
    if a.case == "a":
        rep = case_a(dev)
    elif a.case == "b":
        rep, _ = case_b(dev)
    else:
        rep, _ = case_c(dev)
    print(json.dumps({"case": a.case, "device": str(dev), **rep,
                      "sec": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
