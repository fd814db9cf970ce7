"""K1 (sphere coefficients, 'spline' and 'hat') and K4 (cylinder
coefficients) over the sizes of the composite's buckets.

    python exp_tpu_torch/bench_kernels.py [--root DIR] [--profiler-check]

The sweep cuts the sphere bench's Hernquist sample (sphereSL lmax 4, nmax
10, numr 2000, the benches' tables; K1 under pallas_interp 'spline' and
'hat') and the disk bench's exponential disk (mmax 6, ncx 64 'spline' on
the bench's 256 x 128 grid) to n = 224, 768, 5,120, 49,152, 196,608 and
1,048,576 rows, the last row of each a padding row (the origin, zero
mass) as in a multistep bucket, and times each kernel at each n: device
time a call by CUDA events around 20 calls queued behind a spin kernel
(`queued_ms`) and, by CUDA events, the mean time a launch over launches in
a row (at small n that is the host's enqueue).  It fits the device times
to a fixed cost a launch plus a cost a row, and prints one JSON line.
The kernels' time in the composite's big step is chip_smoke.py's phase
CM3.

`--root DIR` imports exp_tpu_torch from the checkout at DIR instead of
this one, so one command can time another commit's kernels on the same
card (run this file by its path).  `--profiler-check` prints, in place of
the sweep, queued_ms beside torch.profiler's device time at four sizes,
and how many profiles of a single call recorded no device op.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

SWEEP_SIZES = (224, 768, 5_120, 49_152, 196_608, 1_048_576)
# the spin that queued_ms puts before the calls it times: ~8 ms at 2 GHz
SPIN_CYCLES = 1 << 24


def bucket(x, m, n, cap=None):
    """Rows [0, n) of (x, m) with the last row a padding row (the origin,
    zero mass) when n > 1, then zero rows up to `cap` when given."""
    import torch

    xb, mb = x[:n].clone(), m[:n].clone()
    if n > 1:
        xb[-1], mb[-1] = 0.0, 0.0
    if cap is not None and cap > n:
        xb = torch.cat([xb, xb.new_zeros((cap - n, 3))])
        mb = torch.cat([mb, mb.new_zeros((cap - n,))])
    return xb.contiguous(), mb.contiguous()


def queued_ms(fn, reps, tries=4):
    """Device ms a call of fn(): CUDA events around `reps` calls that the
    host enqueues while the device runs a spin kernel (torch.cuda._sleep),
    so that the calls run back to back and the events time the device's
    work, not the host's enqueue; after one warm-up call.  The spin is made
    four times longer, up to `tries` times, until it outlasts the enqueue."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(tries):
        spin, e0, e1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
        t0 = time.perf_counter()
        spin.record()
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        # the spin began after t0, so it ended after every call was queued
        if host_ms < spin.elapsed_time(e0):
            return e0.elapsed_time(e1) / reps
        cycles *= 4
    raise RuntimeError(f"bench_kernels: the host took longer to enqueue "
                       f"{reps} calls than a spin of {cycles // 4} cycles")


def device_ops(fn, tries=3):
    """(device ms by op name, launches) of one call of fn() from
    torch.profiler (bench_composite.profile_call).  A profile that recorded
    no device op is taken again, up to `tries` times, then raises: fn
    always launches.  On an H100 a profile of a single short launch often
    records nothing (K1 or K4 on 224 rows: 69-98 times in 100), so time
    launches with queued_ms and profile dozens of launches or more."""
    from exp_tpu_torch.bench_composite import profile_call

    for _ in range(tries):
        by_op, launches = profile_call(fn)
        if by_op:
            return by_op, launches
    raise RuntimeError(f"bench_kernels: {tries} profiles recorded no device "
                       "op")


def event_ms(fn, reps):
    """Mean ms a call of fn() over `reps` calls in a row, by CUDA events,
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


def fit(ns, ms):
    """Least-squares line through (n, ms): (fixed ms a launch, ms a row)."""
    import numpy as np

    slope, icpt = np.polyfit(np.asarray(ns, float), np.asarray(ms, float), 1)
    return float(icpt), float(slope)


def samples(dev, sphere_tables, disk_tables, n_max=SWEEP_SIZES[-1]):
    """The sphere forces under 'spline' and 'hat' and the disk force
    (backend='pallas' on `dev`, on the benches' tables) and their benches'
    samples of n_max rows on the card: {"K1": (force, x, m), "K1hat": ...,
    "K4": ...}."""
    import torch

    from exp_tpu_torch.bench_disk import disk_force, disk_sample
    from exp_tpu_torch.bench_sphere import hernquist_sample_np, sphere_force

    out = {}
    xs, _, ms = hernquist_sample_np(n_max, seed=0)
    xd, _, md = disk_sample(n_max)
    for key, f, x, m in (
            ("K1", sphere_force(sphere_tables, dev), xs, ms),
            ("K1hat", sphere_force(sphere_tables, dev, interp="hat"), xs, ms),
            ("K4", disk_force(disk_tables, dev), xd, md)):
        out[key] = (f, torch.tensor(x, dtype=torch.float32, device=dev),
                    torch.tensor(m, dtype=torch.float32, device=dev))
    return out


def kernel_fns(forces):
    """{key: fn(x, m)}: the wrappers on `forces`'s tables (samples'
    layout)."""
    from exp_tpu_torch.ops import cyl_kernels as ck
    from exp_tpu_torch.ops import sphere_kernels as sk

    def k1(f):
        hp = f._kernel_params()
        return lambda x, m: sk.sphere_coef(x, m, f._radial_table(), f.Mp,
                                          hp)

    dp = forces["K4"][0]._kernel_params()
    return {"K1": k1(forces["K1"][0]), "K1hat": k1(forces["K1hat"][0]),
            "K4": lambda x, m: ck.cyl_coef(x, m, dp)}


def sweep(forces, sizes=SWEEP_SIZES, reps=20):
    """Each kernel at each size: {"rows": [{kernel, n, device_ms,
    event_ms, event_reps}], "fit": {kernel: {fixed_ms, ms_per_row}}}.
    device_ms by queued_ms over `reps` calls; event_ms over `reps` launches
    in a row (5 x reps below 2^16 rows, where a launch is short)."""
    fns = kernel_fns(forces)
    rows, fits = [], {}
    for key, fn in fns.items():
        _, x, m = forces[key]
        ts = []
        for n in sizes:
            xb, mb = bucket(x, m, n)
            call = lambda: fn(xb, mb)                      # noqa: E731
            dms = queued_ms(call, reps)
            er = reps * (5 if n < 65_536 else 1)
            rows.append({"kernel": key, "n": n, "device_ms": dms,
                         "event_ms": event_ms(call, er), "event_reps": er})
            ts.append(dms)
        icpt, slope = fit(sizes, ts)
        fits[key] = {"fixed_ms": icpt, "ms_per_row": slope}
    return {"rows": rows, "fit": fits}


def profiler_check(forces, sizes=(224, 5_120, 196_608, 1_048_576),
                   reps=20, tries=100):
    """Each kernel at each size: [{kernel, n, queued_ms, profiler_ms,
    empty_profiles, tries}], queued_ms and the profiler's device time a
    call over `reps` calls, and how many of `tries` profiles of one call
    recorded no device op."""
    from exp_tpu_torch.bench_composite import profile_call

    out = []
    for key, fn in kernel_fns(forces).items():
        _, x, m = forces[key]
        for n in sizes:
            xb, mb = bucket(x, m, n)
            call = lambda: fn(xb, mb)                      # noqa: E731
            by_op, _ = device_ops(lambda: [call() for _ in range(reps)])
            out.append({"kernel": key, "n": n,
                        "queued_ms": queued_ms(call, reps),
                        "profiler_ms": sum(by_op.values()) / reps,
                        "empty_profiles": sum(not profile_call(call)[0]
                                              for _ in range(tries)),
                        "tries": tries})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--profiler-check", action="store_true")
    a = ap.parse_args(argv)
    root = Path(a.root or Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device; it times the card",
              file=sys.stderr)
        return 1
    from exp_tpu_torch.bench_disk import disk_tables
    from exp_tpu_torch.bench_sphere import sphere_tables

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    tables = sphere_tables(lmax=4, nmax=10), disk_tables()
    forces = samples(dev, *tables)
    out = {"root": str(root), "device": torch.cuda.get_device_name(dev)}
    if a.profiler_check:
        out["profiler_check"] = profiler_check(forces)
    else:
        out["sweep"] = sweep(forces)
    out["sec"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
