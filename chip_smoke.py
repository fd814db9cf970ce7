#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Two paths of exp_tpu_torch, each at 1,048,576 particles with
backend='pallas', run the port's four hand-written kernels:

  the sphere path: the sphereSL KDK step of a Hernquist halo under the
    spherical Sturm-Liouville basis (lmax=4, nmax=10, 2000 radial nodes),
    through K1 (sphere coefficients, csrc/sphere_coef.cu) and K2 (sphere
    force, csrc/sphere_accel.cu);
  the disk path: the EOF cylinder KDK step of the disk bench (mmax=6,
    nmax=18, 256 x 128 EOF tables, ncx=64 'spline'), through K4 (cylinder
    coefficients, csrc/cyl_coef.cu) and K5 (cylinder force,
    csrc/cyl_accel.cu).

Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from the sources with nvcc (sm_90a), in parallel;
  3. build the sphere tables and the force on the card;
  4. K1 and K2 against their plain PyTorch versions on the same inputs (the
     benches' sample plus edge rows), with the stated tolerances;
  5. the sphere path: init + 50 KDK steps (dt=1e-3) of an equilibrium
     sample, with each kernel's launch count, finiteness, the virial ratio
     and the energy drift gated;
  6. sphere timing: the steady-state step on the benches' sample, each
     kernel and its plain version with CUDA events, and each bound;
  D1. build the disk bench's EOF tables on the host and the force on the
     card;
  D2. K4 and K5 against their plain versions on the disk bench's sample
     plus edge rows, with the stated tolerances;
  D3. the disk path: init + 50 KDK steps (dt=1e-4) of the bench's sample
     and velocities, with each kernel's launch count, finiteness, the
     energy drift and the change of Lz gated (2T/VC is reported: the
     sample is not an equilibrium of its own field);
  D4. disk timing, as in phase 6.

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

# The disk path (bench_suite.bench_disk's configuration).
DISK_STEPS = 50
DISK_DT = 1e-4
# |dEtot/Etot| bound over the 50 disk steps.  The same run through the
# plain versions on a CPU (python -m exp_tpu_torch.bench_disk kdk --device
# cpu) gave 6.89e-5: the disk sample is not an equilibrium of its own
# field, and the coarse-grid force is not the exact gradient of the
# interpolated potential, so Etot moves by that much in 50 steps at
# dt=1e-4.  Sums taken in another order on the card move each end's Etot
# by about eps * log2 N ~ 2.4e-6 of it, so the card should land within
# ~5e-6 of the CPU's drift; 1e-4 leaves room for that and fails a step
# whose force breaks conservation by half as much again.
DISK_DRIFT_BOUND = 1e-4
# |dLz/Lz| bound over the same run.  The CPU gave 2.0e-7: the sample's
# non-axisymmetric noise exerts almost no torque in 50 steps.  Each Lz is
# an f32 sum over 2^20 particles, good to ~eps * log2 N ~ 2.4e-6 in another
# order of summation, so the change read on the card may be up to ~5e-6;
# 1e-5 leaves room for that and fails a force with a spurious torque.
DISK_LZ_BOUND = 1e-5
# K4: G and the coefficients, max|d| / max|value|: f32 sums of 2^20
# particles in a varying order (shared-memory atomics, then the chunk
# partials in a fixed order), the same bound as K1.
CYL_COEF_RTOL = 1e-5
# K5: the same arithmetic as the plain version but for nvcc's FMA
# contraction (1 ulp a step) in the interpolation and the assembly, so
# rtol 1e-4 on acc and 1e-5 on pot as for K2.  Components that cancel to
# near 0 (F_z at the midplane, F_phi) are held to an atol of 1e-6 (acc) and
# 1e-7 (pot) of the field's largest value.
CYL_ACC_RTOL, CYL_ACC_ATOL_REL = 1e-4, 1e-6
CYL_POT_RTOL, CYL_POT_ATOL_REL = 1e-5, 1e-7


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


def disk_edge_rows(n_bulk):
    """For the disk tables (rmax_grid = 0.2, inner x edge R = 1e-5): the
    origin, the z axis, r > rmax_grid in the plane and off it, |z| at and
    near ymax, R at the inner and outer x edge, and a zero-mass row."""
    import numpy as np

    x = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.05], [0.3, 0.0, 0.0],
                  [0.15, 0.1, 0.12], [0.0, 0.0, 0.25], [0.001, 0.0, 0.1999],
                  [0.002, 0.001, -0.1995], [1e-5, 0.0, 0.0],
                  [0.0, -3e-6, 1e-6], [0.1999, 0.0, 0.0], [0.01, 0.01, 0.0]])
    m = np.full(len(x), 0.05 / n_bulk)
    m[-1] = 0.0
    return x, m


def _cyl_point_ops(mmax, kx):
    """FP32 operations of the per-particle set-up both cylinder kernels
    share: R and r (10), cos/sin phi (2), the x and y maps and clamps (19),
    kx x weights (11 each) and 2 y weights (6 each), the trig rows by angle
    addition (6 per m)."""
    return 10 + 2 + 19 + 11 * kx + 12 + 6 * mmax


def k4_work(n, n_in, mmax, xrows, ncy, kx):
    """Bytes and FP32 operations the function of K4 needs at least on these
    inputs (an FMA counts 2), not the kernel's own arithmetic: the mass
    mask for every particle (1); for the n_in particles with mass inside
    rmax_grid, the set-up (_cyl_point_ops), the 2 kx node weights wx_a wy_b
    once (1 each) and, for each of the 2(M+1) - 1 nonzero trig rows, w trig
    (1) and one FMA into G per node (2 kx nodes x 2).  Bytes: x and mass
    in, G out."""
    T = 2 * (mmax + 1)
    per_in = _cyl_point_ops(mmax, kx) + 2 * kx + (T - 1) * (1 + 2 * kx * 2)
    return n * 16 + xrows * T * ncy * 4, n + n_in * per_in


def k5_work(n, mmax, xrows, ncy, kx):
    """Bytes and FP32 operations the function of K5 needs at least on these
    inputs (an FMA counts 2), not the kernel's own arithmetic: the set-up
    (_cyl_point_ops), the mask and shrink (4), the 2 kx node weights wx_a
    wy_b once (1 each), then per table value one FMA per node (2 kx nodes x
    2) over 6(M+1) values, the assembly (17 per m: pot, F_R, F_z by 2 FMAs
    each and F_phi) and F_phi/R (1), the continuation or the Cartesian step
    (8).  Bytes: x in, acc and pot out, the contracted table once."""
    S = 6 * (mmax + 1)
    SP = (S + 3) // 4 * 4
    per = (_cyl_point_ops(mmax, kx) + 4 + 2 * kx + S * 2 * kx * 2
           + 17 * (mmax + 1) + 9)
    return n * (12 + 16) + xrows * ncy * SP * 4, n * per


def bound_ms(byts, ops):
    t_b = byts / HBM_BYTES_PER_S
    t_o = ops / FP32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def disk_path(dev):
    """Phases D1-D4 on the card; returns the kernels-line rows of K4, K5."""
    import numpy as np
    import torch

    from exp_tpu_torch.bench_disk import (bench_disk, disk_force,
                                          disk_sample, disk_tables)
    from exp_tpu_torch.bench_sphere import kdk_run
    from exp_tpu_torch.ops import cyl_kernels as ck
    from exp_tpu_torch.ops import sphere_kernels as sk

    # D1. the EOF tables on the host, the force on the card
    t0 = time.perf_counter()
    tables = disk_tables()
    print(f"D1 disk EOF tables (mmax={tables.mmax}, nmax={tables.nmax}, "
          f"{tables.numx} x {tables.numy}): "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    force = disk_force(tables, dev)
    prm = force._kernel_params()

    # D2. K4 and K5 against their plain versions at the path's shapes
    xb, vb, mb = disk_sample(N)
    ex, em = disk_edge_rows(N)
    x = torch.tensor(np.concatenate([xb, ex]), dtype=torch.float32,
                     device=dev)
    m = torch.tensor(np.concatenate([mb, em]), dtype=torch.float32,
                     device=dev)
    G = ck.cyl_coef(x, m, prm)
    G0 = ck.cyl_coef_plain(x, m, prm)
    c = ck.contract_coef_output(G, force.tab3)
    c0 = ck.contract_coef_output(G0, force.tab3)
    torch.cuda.synchronize()
    k4_err = float((G - G0).abs().max())
    g_rel = k4_err / float(G0.abs().max())
    c_rel = float((c - c0).abs().max()) / float(c0.abs().max())
    zero = float(ck.cyl_coef(x[-1:], m[-1:], prm).abs().max())
    print(f"D2 K4 vs plain: max|dG| = {k4_err:.3e}, max|dG|/max|G| = "
          f"{g_rel:.3e}, coefficients {c_rel:.3e} (tolerance "
          f"{CYL_COEF_RTOL:.0e}); zero-mass row gives {zero}", flush=True)
    if not (g_rel <= CYL_COEF_RTOL and c_rel <= CYL_COEF_RTOL
            and zero == 0.0):
        raise AssertionError(f"K4 disagrees with its plain version: G "
                             f"{g_rel}, coefficients {c_rel}, zero {zero}")

    Ct = ck.contract_coef_tables(c0, force.tab3, prm.xrows, prm.ncy)
    a, p = ck.cyl_accel(x, Ct, prm)
    a0, p0 = ck.cyl_accel_plain(x, Ct, prm)
    torch.cuda.synchronize()
    da, dp = (a - a0).abs(), (p - p0).abs()
    k5_err = max(float(da.max()), float(dp.max()))
    amax, pmax = float(a0.abs().max()), float(p0.abs().max())
    ok_a = da <= CYL_ACC_ATOL_REL * amax + CYL_ACC_RTOL * a0.abs()
    ok_p = dp <= CYL_POT_ATOL_REL * pmax + CYL_POT_RTOL * p0.abs()
    edge = slice(N, None)
    print(f"D2 K5 vs plain: max|da| = {float(da.max()):.3e} (|a| up to "
          f"{amax:.3e}), max|dpot| = {float(dp.max()):.3e} (|pot| up to "
          f"{pmax:.3e}); edge rows max|da| = {float(da[edge].max()):.3e}, "
          f"max|dpot| = {float(dp[edge].max()):.3e}; tolerance acc rtol "
          f"{CYL_ACC_RTOL:.0e} atol {CYL_ACC_ATOL_REL:.0e} max|a|, pot rtol "
          f"{CYL_POT_RTOL:.0e} atol {CYL_POT_ATOL_REL:.0e} max|pot|",
          flush=True)
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    if not (finite and bool(ok_a.all()) and bool(ok_p.all())):
        bad = int(torch.argmin(ok_a.all(dim=1).int() * ok_p.int()))
        raise AssertionError(
            f"K5 disagrees with its plain version (finite={finite}); first "
            f"bad row {bad} at {x[bad].tolist()}: acc {a[bad].tolist()} vs "
            f"{a0[bad].tolist()}, pot {float(p[bad])} vs {float(p0[bad])}")

    # D3. the disk path: init + DISK_STEPS KDK steps of the bench's sample
    sk.reset_launch_counts()
    ck.reset_launch_counts()
    run = kdk_run(force, xb, vb, mb, steps=DISK_STEPS, dt=DISK_DT,
                  device=dev)
    torch.cuda.synchronize()
    launches = {**sk.launch_counts, **ck.launch_counts}
    print("D3 disk path: " + json.dumps({**run, "launches": launches}),
          flush=True)
    if not run["finite"]:
        raise AssertionError("non-finite state after the disk KDK run")
    for name in ck.launch_counts:
        if launches[name] != DISK_STEPS + 1:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"on the disk path, expected "
                                 f"{DISK_STEPS + 1}")
    if not run["dE_rel"] < DISK_DRIFT_BOUND:
        raise AssertionError(f"disk |dEtot/Etot| = {run['dE_rel']} over "
                             f"{DISK_STEPS} steps exceeds {DISK_DRIFT_BOUND}")
    if not run["dLz_rel"] < DISK_LZ_BOUND:
        raise AssertionError(f"disk |dLz/Lz| = {run['dLz_rel']} over "
                             f"{DISK_STEPS} steps exceeds {DISK_LZ_BOUND}")

    # D4. timing
    bench = bench_disk(n=N, reps=30, tables=tables, device=dev)
    print("D4 disk step: " + json.dumps(bench), flush=True)
    kx = 3 if prm.interp == "spline" else 2
    r = x.norm(dim=1)
    n_in = int(((r <= prm.rmax_grid) & (m > 0)).sum())
    rows = []
    for name, src, line, fn, plain, err, (byts, ops) in (
            ("cyl_coef", "exp_tpu_torch/csrc/cyl_coef.cu",
             "exp_tpu/ops/pallas_cylinder.py:164",
             lambda: ck.cyl_coef(x, m, prm),
             lambda: ck.cyl_coef_plain(x, m, prm), k4_err,
             k4_work(x.shape[0], n_in, prm.mmax, prm.xrows, prm.ncy, kx)),
            ("cyl_accel", "exp_tpu_torch/csrc/cyl_accel.cu",
             "exp_tpu/ops/pallas_cylinder.py:257",
             lambda: ck.cyl_accel(x, Ct, prm),
             lambda: ck.cyl_accel_plain(x, Ct, prm), k5_err,
             k5_work(x.shape[0], prm.mmax, prm.xrows, prm.ncy, kx))):
        bms, by = bound_ms(byts, ops)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "launches": launches[name], "max_abs_err": err,
            "ms": cuda_ms(fn, 50), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "bytes": byts, "operations": ops})
    return rows


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
    rows += disk_path(dev)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
