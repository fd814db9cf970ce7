#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The main path is the sphereSL KDK step of exp_tpu_torch: a Hernquist halo
under the spherical Sturm-Liouville basis (lmax=4, nmax=10, 2000 radial
nodes) with backend='pallas', which runs the port's two hand-written
kernels, K1 (sphere coefficients, csrc/sphere_coef.cu) and K2 (sphere
force, csrc/sphere_accel.cu), at 1,048,576 particles.  Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build both kernels from the sources with nvcc (sm_90a), in parallel;
  3. build the tables and the force on the card;
  4. each kernel against its plain PyTorch version on the same inputs (the
     benches' sample plus edge rows), with the stated tolerances;
  5. the main path: init + 50 KDK steps (dt=1e-3) of an equilibrium
     sample, with each kernel's launch count, finiteness, the virial ratio
     and the energy drift gated;
  6. timing: the steady-state step on the benches' sample, each kernel and
     its plain version with CUDA events, and each kernel's bound.

Prints one JSON line {"kernels": [...]} and, last, {"ok": true, "device":
...}.  Any failure raises and exits non-zero before the last line.  Needs
a CUDA device and the repository around it.
"""

import json
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 FLOP/s
# outside the tensor cores.  A bound is the larger of bytes / HBM rate and
# operations / FP32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

N = 1_048_576
STEPS = 50
DT = 1e-3
# |dEtot/Etot| bound over the 50 steps.  The same run through the plain
# versions on a CPU (python -m exp_tpu_torch.bench_sphere kdk --device cpu)
# gave 8.1e-7, which is at the rounding level of the f32 energy sums over
# 2^20 particles (eps * log2 N ~ 2.4e-6); 1e-5 leaves room for sums taken
# in another order on the card and fails a step that breaks conservation.
DRIFT_BOUND = 1e-5
VIRIAL_TOL = 0.05
COEF_RTOL = 1e-5          # max|dc| / max|c|, f32 sums in another order
ACC_RTOL, ACC_ATOL = 1e-4, 1e-6
POT_RTOL, POT_ATOL = 1e-5, 1e-7


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def edge_rows(n_bulk):
    """The origin, both poles, r > rmax, r < rmin and a zero-mass row."""
    import numpy as np

    x = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.7], [0.0, 0.0, -1.3],
                  [30.0, 0.0, 0.0], [0.0, -25.0, 10.0], [3e-4, 0.0, 1e-4],
                  [0.3, 0.2, 0.1]])
    m = np.full(7, 1.0 / n_bulk)
    m[-1] = 0.0
    return x, m


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over `reps` launches, by CUDA events,
    after two warm-up calls."""
    import torch

    fn()
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def k1_work(n, n_in, lmax, nmax, rows):
    """Bytes and FP32 operations K1 needs on these inputs (an FMA counts
    2).  Per particle: radius, xi map and mask (13), 1/r and u (4), the
    monomials (n_mono - 4 products), the nonzero entries of M . mono (an
    FMA each) and the mass weight (P), the 3 spline weights (24).  For the
    n_in particles inside the mass mask, 3 FMAs into each of P rows.  Then
    the reduction over particles is folded into that count, and the
    contraction with the table is P * rows * nmax FMAs."""
    from exp_tpu_torch.ops.solidharm import harmonic_matrix
    from exp_tpu_torch.ops.sphere_kernels import packed_rows

    P = (lmax + 1) ** 2
    n_mono = (lmax + 1) * (lmax + 2) * (lmax + 3) // 6
    nnz = int((harmonic_matrix(lmax, tuple(packed_rows(lmax))) != 0).sum())
    per = 13 + 4 + (n_mono - 4) + 2 * nnz + P + 24
    ops = n * per + n_in * 3 * P * 2 + P * rows * nmax * 2
    byts = (n * 16 + P * n_mono * 4 + rows * (lmax + 1) * nmax * 4
            + 2 * (lmax + 1) ** 2 * nmax * 4)
    return byts, ops


def k2_work(n, lmax, rows):
    """Bytes and FP32 operations K2 needs on these inputs (an FMA counts
    2).  Per particle: geometry (15), the pole clamp and P_lm recurrences
    (about 5 per entry), dP_lm (5 per entry), trig rows (6 per m), the 3
    spline weights (24), 2P rows x 3 FMAs of interpolation, the
    continuation (2 + L), 14 operations per packed row of the assembly
    (plus 6 for m > 0) and the Cartesian step (30)."""
    P = (lmax + 1) ** 2
    nlm = (lmax + 1) * (lmax + 2) // 2
    n_m = lmax * (lmax + 1) // 2 * 2             # packed rows with m > 0
    per = (15 + 5 * nlm + 5 * nlm + 6 * lmax + 24 + 2 * P * 3 * 2
           + 2 + lmax + 14 * P + 6 * n_m + 30)
    byts = n * (12 + 16) + 2 * P * rows * 4 + (lmax + 1) ** 2 * 4
    return byts, n * per


def bound_ms(byts, ops):
    t_b = byts / HBM_BYTES_PER_S
    t_o = ops / FP32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from exp_tpu_torch.bench_sphere import (bench_sphere, equilibrium_sample,
                                            hernquist_sample_np, kdk_run,
                                            sphere_tables)
    from exp_tpu_torch.forces.spherical import SphereSL
    from exp_tpu_torch.ops import _build
    from exp_tpu_torch.ops import sphere_kernels as sk

    # 1. the card
    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'already built'})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if line.startswith("nvcc "):
                print("  " + line)

    # 3. tables and the force
    t0 = time.perf_counter()
    tables = sphere_tables(lmax=4, nmax=10)
    force = SphereSL.from_tables(tables, backend="pallas", device=dev)
    prm = force._kernel_params()
    print(f"tables + force: {time.perf_counter() - t0:.1f} s", flush=True)

    # 4. kernels against their plain versions, at the main path's shapes
    xb, _, mb = hernquist_sample_np(N, seed=0)
    ex, em = edge_rows(N)
    x = torch.tensor(np.concatenate([xb, ex]), dtype=torch.float32,
                     device=dev)
    m = torch.tensor(np.concatenate([mb, em]), dtype=torch.float32,
                     device=dev)
    c = sk.sphere_coef(x, m, force.tabc_s, force.Mp, prm)
    c0 = sk.sphere_coef_plain(x, m, force.tabc_s, force.Mp, prm)
    torch.cuda.synchronize()
    k1_err = float((c - c0).abs().max())
    k1_rel = k1_err / float(c0.abs().max())
    print(f"K1 vs plain: max|dc| = {k1_err:.3e}, max|dc|/max|c| = "
          f"{k1_rel:.3e} (tolerance {COEF_RTOL:.0e})", flush=True)
    if not k1_rel <= COEF_RTOL:
        raise AssertionError(f"K1 disagrees with its plain version: {k1_rel}")

    twT = sk.contract_coef_table2(c0, force.tabc_s, force.tabd_s,
                                  force.prows)
    a, p = sk.sphere_accel(x, twT, force.fac32, prm)
    a0, p0 = sk.sphere_accel_plain(x, twT, force.fac32, prm)
    torch.cuda.synchronize()
    da, dp = (a - a0).abs(), (p - p0).abs()
    k2_err = max(float(da.max()), float(dp.max()))
    worst_a = int(torch.argmax((da - ACC_RTOL * a0.abs()).max(dim=1).values))
    worst_p = int(torch.argmax(dp - POT_RTOL * p0.abs()))
    print(f"K2 vs plain: max|da| = {float(da.max()):.3e} (|a| up to "
          f"{float(a0.abs().max()):.3e}), max|dpot| = {float(dp.max()):.3e}; "
          f"worst acc row {worst_a} r = "
          f"{float(x[worst_a].norm()):.4g} rho = "
          f"{float(x[worst_a, :2].norm()):.3e}; tolerance acc rtol "
          f"{ACC_RTOL:.0e} atol {ACC_ATOL:.0e}, pot rtol {POT_RTOL:.0e} "
          f"atol {POT_ATOL:.0e}", flush=True)
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    ok_a = bool((da <= ACC_ATOL + ACC_RTOL * a0.abs()).all())
    ok_p = bool((dp <= POT_ATOL + POT_RTOL * p0.abs()).all())
    if not (finite and ok_a and ok_p):
        raise AssertionError(
            f"K2 disagrees with its plain version (finite={finite}, "
            f"acc ok={ok_a}, pot ok={ok_p}; worst pot row {worst_p})")

    # 5. the main path: init + STEPS KDK steps of an equilibrium sample
    t0 = time.perf_counter()
    xe, ve, me = equilibrium_sample(N, seed=0)
    print(f"equilibrium sample of {N}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    sk.reset_launch_counts()
    run = kdk_run(force, xe, ve, me, steps=STEPS, dt=DT, device=dev)
    torch.cuda.synchronize()
    launches = dict(sk.launch_counts)
    print("main path: " + json.dumps({**run, "launches": launches}),
          flush=True)
    if not run["finite"]:
        raise AssertionError("non-finite state after the KDK run")
    for name, cnt in launches.items():
        if cnt != STEPS + 1:
            raise AssertionError(f"{name} launched {cnt} times, expected "
                                 f"{STEPS + 1}")
    for key in ("virial0", "virial1"):
        if not abs(run[key] - 1.0) <= VIRIAL_TOL:
            raise AssertionError(f"2T/VC {key} = {run[key]}")
    if not run["dE_rel"] < DRIFT_BOUND:
        raise AssertionError(f"|dEtot/Etot| = {run['dE_rel']} over "
                             f"{STEPS} steps exceeds {DRIFT_BOUND}")

    # 6. timing
    bench = bench_sphere(n=N, reps=30, tables=tables, device=dev)
    print("step: " + json.dumps(bench), flush=True)

    n_in = int(((x.norm(dim=1) + 1e-10 >= prm.rmin)
                & (x.norm(dim=1) + 1e-10 <= prm.rmax) & (m > 0)).sum())
    b1, o1 = k1_work(x.shape[0], n_in, 4, 10, prm.rows)
    b2, o2 = k2_work(x.shape[0], 4, prm.rows)
    rows = []
    for name, src, line, fn, plain, err, (byts, ops) in (
            ("sphere_coef", "exp_tpu_torch/csrc/sphere_coef.cu",
             "exp_tpu/ops/pallas_sphere.py:521",
             lambda: sk.sphere_coef(x, m, force.tabc_s, force.Mp, prm),
             lambda: sk.sphere_coef_plain(x, m, force.tabc_s, force.Mp, prm),
             k1_err, (b1, o1)),
            ("sphere_accel", "exp_tpu_torch/csrc/sphere_accel.cu",
             "exp_tpu/ops/pallas_sphere.py:398",
             lambda: sk.sphere_accel(x, twT, force.fac32, prm),
             lambda: sk.sphere_accel_plain(x, twT, force.fac32, prm),
             k2_err, (b2, o2))):
        bms, by = bound_ms(byts, ops)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "launches": launches[name], "max_abs_err": err,
            "ms": cuda_ms(fn, 50), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "bytes": byts, "operations": ops})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
