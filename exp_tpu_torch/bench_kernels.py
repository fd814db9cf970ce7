"""K1 (sphere coefficients, 'spline' and 'hat'), K2 (sphere force,
'spline' and 'hat'), K4 (cylinder coefficients) and K5 (cylinder force)
over the sizes of the composite's buckets; K3 (recurrence coefficients),
K6 (poly force), P1 (the slab phase-stream probe), K7 and K8 (cube
coefficients and force), K9 and K10 (slab coefficients and force) when
named.

    python exp_tpu_torch/bench_kernels.py [--root DIR] [--kernels K2,K5]
                                          [--sizes 224,1048576]
                                          [--form small|large]
                                          [--profiler-check | --composite]

The sweep cuts the sphere bench's Hernquist sample (sphereSL lmax 4, nmax
10, numr 2000, the benches' tables; K1 and K2 under pallas_interp 'spline'
and 'hat') and the disk bench's exponential disk (mmax 6, ncx 64 'spline'
on the bench's 256 x 128 grid) to n = 224, 768, 5,120, 49,152, 196,608 and
1,048,576 rows, the last row of each a padding row (the origin, zero
mass) as in a multistep bucket, and times each kernel at each n: device
time a call by CUDA events around 20 calls queued behind a spin kernel
(`queued_ms`) and, by CUDA events, the mean time a launch over launches in
a row (at small n that is the host's enqueue).  The force kernels read the
tables of the whole sample's coefficients.  It fits the device times to a
fixed cost a launch plus a cost a row, and prints one JSON line.

`--root DIR` imports exp_tpu_torch from the checkout at DIR instead of
this one, so one command can time another commit's kernels on the same
card (run this file by its path).  `--kernels` times only the named
kernels (of K1, K1hat, K2, K2hat, K4, K5, and K2L10, K2 on lmax 10 tables,
and K5halo, K5 on the sphere's sample: rows beyond the table sphere, as
the composite's halo under the disk's force; K3 and K3hat, K3 on the
sphere's sample under 'spline' and 'hat', K3L10, K3 on the lmax 10
tables; P1s1 and P1s2, P1 stream1 and stream2 on the phase-stream probe's
sample cut to each size, its phase table made outside the timing; K7 and
K8, the cube kernels at nmax 6 on the cube bench's uniform sample, K8 on
the table of the whole sample's coefficients: time them with `--sizes
4194304`, the cube path's size; K6 and K6hat, K6 on the sphere's sample
and its lmax 4 tables under pallas_harmonics 'poly', 'spline' and 'hat',
Ms from poly_matrix_stack; K9, K9 on the slab bench's sheet, 'spline';
K10, K10 on that sheet, and K10lin under 'linear'; K10out, K10 on
bench_slab.slab_outside_sample, half of it beyond zmax (the first half
inside, so time it at its full 1,048,576 rows; a root older than that
sampler cannot time it); K10sort and K10tile, K10
on the sheet sorted by z, as a whole or within tiles of 1,024 rows, what
warp-coherent table rows would save: time them at 1,048,576 rows, as a
cut of the sorted sheet is its lowest rows).
`--sizes` replaces the sweep's sizes.  Each row carries a digest of the
kernel's output at that size (sha256 of its bytes), so that two
checkouts' bits can be compared.  `--form small` or `large`
launches K2 and K5 in their small- or large-bucket form at every n (the
plans' choice otherwise).  `--profiler-check` prints, in place of the
sweep, queued_ms beside torch.profiler's device time at four sizes, and
how many profiles of a single call recorded no device op.  `--composite`
runs, in place of the sweep, the checkout's `chip_smoke.py` phases
CM1-CM3 (the composite's big steps, each kernel's device time a big step
and a launch on each level's bucket).
"""

from __future__ import annotations

import argparse
import hashlib
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


KERNELS = ("K1", "K1hat", "K2", "K2hat", "K4", "K5")
# timed only when named: K2 on the lmax 10 tables, K5 on the halo's sample
# (the composite's halo under the disk's force: rows beyond the table
# sphere, whose nodes are few), K3 off the main path ('spline', 'hat',
# lmax 10) and P1 (stream1, stream2)
EXTRA = ("K2L10", "K5halo", "K3", "K3hat", "K3L10", "K6", "K6hat", "P1s1",
         "P1s2", "K7", "K8", "K9", "K10", "K10lin", "K10out", "K10sort",
         "K10tile")
# the csrc sources each kernel's timing builds (the force kernels' tables
# come from the coefficient kernels)
SOURCES = {"K1": ("sphere_coef",), "K1hat": ("sphere_coef",),
           "K2": ("sphere_coef", "sphere_accel"),
           "K2hat": ("sphere_coef", "sphere_accel"),
           "K2L10": ("sphere_coef_rec", "sphere_accel"),
           "K4": ("cyl_coef",), "K5": ("cyl_coef", "cyl_accel"),
           "K5halo": ("cyl_coef", "cyl_accel"),
           "K3": ("sphere_coef_rec",), "K3hat": ("sphere_coef_rec",),
           "K3L10": ("sphere_coef_rec",),
           "K6": ("sphere_coef", "sphere_accel_poly"),
           "K6hat": ("sphere_coef", "sphere_accel_poly"),
           "P1s1": ("slab_phasestream",), "P1s2": ("slab_phasestream",),
           "K7": ("cube_coef",), "K8": ("cube_coef", "cube_accel"),
           "K9": ("slab_coef",), **{k: ("slab_coef", "slab_accel") for k in
                                    ("K10", "K10lin", "K10out", "K10sort",
                                     "K10tile")}}
SPHERE_KEYS = {"K1", "K1hat", "K2", "K2hat", "K2L10", "K5halo", "K3",
               "K3hat", "K3L10", "K6", "K6hat"}
POLY_KEYS = {"K6": "spline", "K6hat": "hat"}
LMAX10_KEYS = {"K2L10", "K3L10"}
P1_KEYS = {"P1s1": False, "P1s2": True}        # key: split table
CUBE_KEYS = {"K7", "K8"}
SLAB_KEYS = {"K9", "K10", "K10lin", "K10out", "K10sort", "K10tile"}
# K10's samples: the bench's sheet ('spline'; 'linear' for K10lin), the
# outside sample (bench_slab.slab_outside_sample, half beyond zmax), and the
# sheet sorted by z, as a whole (K10sort) or within each K10_TILE rows
# (K10tile)
K10_KEYS = {"K10": "spline", "K10lin": "linear", "K10out": "spline",
            "K10sort": "spline", "K10tile": "spline"}
K10_TILE = 1024


def samples(dev, sphere_tables, disk_tables, n_max=SWEEP_SIZES[-1],
            keys=KERNELS, tables10=None):
    """The sphere forces under 'spline' and 'hat' and the disk force
    (backend='pallas' on `dev`, on the benches' tables; K2L10's and
    K3L10's on the lmax 10 `tables10`) and their benches' samples of n_max
    rows on the card, for the kernels `keys`: {"K1": (force, x, m),
    "K1hat": ..., "K2": the same as "K1", ..., "K5halo": the disk's force
    on the sphere's sample, "K3": the 'recurrence' force, ..., "K6": the
    'poly' force, "P1s1": (the probe's SlabKernelParams, its sample), "K7"
    and "K8": the cube bench's force and uniform sample, "K9": the slab
    bench's force and sheet}."""
    import torch

    from exp_tpu_torch.bench_disk import disk_force, disk_sample
    from exp_tpu_torch.bench_sphere import hernquist_sample_np, sphere_force

    out = {}
    if SPHERE_KEYS & set(keys):
        xs, _, ms = hernquist_sample_np(n_max, seed=0)
        xs, ms = (torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in (xs, ms))
        for interp, ks in (("spline", ("K1", "K2")), ("hat", ("K1hat", "K2hat"))):
            if set(ks) & set(keys):
                f = sphere_force(sphere_tables, dev, interp=interp)
                out.update({k: (f, xs, ms) for k in ks if k in keys})
        for key, interp in (("K3", "spline"), ("K3hat", "hat")):
            if key in keys:
                out[key] = (sphere_force(sphere_tables, dev, "recurrence",
                                         interp), xs, ms)
        for key in sorted(LMAX10_KEYS & set(keys)):
            out[key] = (sphere_force(tables10, dev), xs, ms)
        for key, interp in POLY_KEYS.items():
            if key in keys:
                out[key] = (sphere_force(sphere_tables, dev, "poly", interp),
                            xs, ms)
    if set(P1_KEYS) & set(keys):
        from exp_tpu_torch import probe_slab_phasestream as probe

        xp, mp = (torch.tensor(a, device=dev)
                  for a in probe.probe_sample(n_max))
        out.update({k: (probe.probe_params(), xp, mp) for k in P1_KEYS
                    if k in keys})
    if CUBE_KEYS & set(keys):
        from exp_tpu_torch.bench_cube import cube_force, cube_sample

        xc, _, mc = cube_sample(n_max)
        xc, mc = (torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in (xc, mc))
        f = cube_force(dev)
        out.update({k: (f, xc, mc) for k in CUBE_KEYS if k in keys})
    if SLAB_KEYS & set(keys):
        out.update(slab_samples(dev, n_max, SLAB_KEYS & set(keys)))
    if {"K4", "K5", "K5halo"} & set(keys):
        xd, _, md = disk_sample(n_max)
        f = disk_force(disk_tables, dev)
        xd, md = (torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in (xd, md))
        out.update({k: (f, xd, md) for k in ("K4", "K5") if k in keys})
        if "K5halo" in keys:
            out["K5halo"] = (f, xs, ms)
    return out


def slab_samples(dev, n_max, keys):
    """{key: (force, x, m)} of the slab keys (K9, K10 ...) on the slab
    bench's tables: the sheet of n_max rows, the outside sample, the sheet
    sorted by z (K10_KEYS)."""
    import numpy as np
    import torch

    from exp_tpu_torch.bench_slab import slab_force, slab_sample, slab_tables
    from exp_tpu_torch.forces.slab import SlabForce

    tables = slab_tables()
    forces = {}

    def force(interp):
        if interp not in forces:
            forces[interp] = SlabForce.from_tables(
                tables, backend="pallas", pallas_interp=interp, device=dev) \
                if interp != "spline" else slab_force(tables, dev)
        return forces[interp]

    xl, _, ml = slab_sample(n_max)
    out = {}
    for key in sorted(keys):
        x, m = xl, ml
        if key == "K10out":
            # imported here: a root older than the sampler still times the rest
            from exp_tpu_torch.bench_slab import slab_outside_sample

            x, m = slab_outside_sample(n_max)
        elif key == "K10sort":
            order = np.argsort(xl[:, 2], kind="stable")
            x, m = xl[order], ml[order]
        elif key == "K10tile":
            order = np.concatenate([
                s + np.argsort(xl[s:s + K10_TILE, 2], kind="stable")
                for s in range(0, n_max, K10_TILE)])
            x, m = xl[order], ml[order]
        out[key] = (force(K10_KEYS.get(key, "spline")),
                    *(torch.tensor(a, dtype=torch.float32, device=dev)
                      for a in (x, m)))
    return out


def kernel_fns(forces, form="default"):
    """{key: (fn(x, m), plain(x, m))}: each kernel's wrapper and its plain
    version on `forces`'s tables (samples' layout); the force kernels read
    the table of the coefficients of the whole sample.  `form` 'small' or
    'large' launches K2 and K5 in their small- or large-bucket form at any
    n ('default': the plan's choice)."""
    import torch

    from exp_tpu_torch.ops import cube_kernels as qk
    from exp_tpu_torch.ops import cyl_kernels as ck
    from exp_tpu_torch.ops import slab_kernels as lk
    from exp_tpu_torch.ops import sphere_kernels as sk

    def dev_args(x):
        props = torch.cuda.get_device_properties(x.device)
        return props.multi_processor_count, props.shared_memory_per_block_optin

    def k2(x, p):       # the wrapper's keywords (none: the plan's choice)
        if form == "default":
            return {}
        lanes = sk.k2_lanes(p.lmax) if form == "small" else 1
        return {"plan": sk.k2_plan(x.shape[0], p, *dev_args(x),
                                   threads=lanes)}

    def k5(x, p):
        if form == "default":
            return {}
        return {"plan": ck.accel_plan(x.shape[0], p, *dev_args(x),
                                      broadcast=form == "large")}

    def phase_table(p, split):    # the table of the last x it was given
        last = {}

        def table(x):
            if last.get("x") is not x:
                last.update(x=x, ph=lk.phase_table(x, p, split))
            return last["ph"]
        return table

    out = {}
    for key, (f, x, m) in forces.items():
        if key in P1_KEYS:
            t = phase_table(f, P1_KEYS[key])
            out[key] = (
                lambda x, m, p=f, t=t: lk.stream_coef(t(x), x, m, p),
                lambda x, m, p=f, t=t: lk.stream_coef_plain(t(x), x, m, p))
            continue
        p = f._kernel_params()
        if key == "K7":
            out[key] = (lambda x, m, p=p: qk.cube_coef(x, m, p),
                        lambda x, m, p=p: qk.cube_coef_plain(x, m, p))
        elif key == "K8":
            tab = qk.cube_force_table(f.coefficients(x, m) * f.norm, p)
            out[key] = (lambda x, m, p=p, t=tab: qk.cube_accel(x, t, p),
                        lambda x, m, p=p, t=tab: qk.cube_accel_plain(x, t, p))
        elif key in ("K3", "K3hat", "K3L10"):
            tab = f._radial_table()
            out[key] = (
                lambda x, m, f=f, p=p, tab=tab: sk.sphere_coef_rec(
                    x, m, tab, f.fac32, p),
                lambda x, m, f=f, p=p, tab=tab: sk.sphere_coef_rec_plain(
                    x, m, tab, f.fac32, p))
        elif key in ("K1", "K1hat"):
            tab = f._radial_table()
            out[key] = (
                lambda x, m, f=f, p=p, tab=tab: sk.sphere_coef(x, m, tab, f.Mp, p),
                lambda x, m, f=f, p=p, tab=tab: sk.sphere_coef_plain(
                    x, m, tab, f.Mp, p))
        elif key == "K9":
            out[key] = (lambda x, m, p=p: lk.slab_coef(x, m, p),
                        lambda x, m, p=p: lk.slab_coef_plain(x, m, p))
        elif key in K10_KEYS:
            c = f.coefficients(x, m)
            tab = lk.slab_force_table(c, f.zq_s, p)
            aux = lk.slab_force_aux(c, f.bnd_s, p)
            out[key] = (
                lambda x, m, p=p, t=tab, a=aux: lk.slab_accel(x, t, a, p),
                lambda x, m, p=p, t=tab, a=aux: lk.slab_accel_plain(x, t, a,
                                                                   p))
        elif key in ("K2", "K2hat", "K2L10", "K6", "K6hat"):
            # the contraction as SphereSL.acceleration makes it, spelled out
            # so that --root can time a checkout that predates accel_table
            c = f.coefficients(x, m)
            twT = (sk.contract_coef_table2(c, f.tabc_s, f.tabd_s, f.prows)
                   if p.interp == "spline"
                   else sk.contract_coef_table(c, f.tabc32, f.prows))
            if key in POLY_KEYS:
                out[key] = (
                    lambda x, m, f=f, p=p, t=twT: sk.sphere_accel_poly(
                        x, t, f.Ms, p),
                    lambda x, m, f=f, p=p, t=twT: sk.sphere_accel_poly_plain(
                        x, t, f.Ms, p))
                continue
            out[key] = (
                lambda x, m, f=f, p=p, t=twT: sk.sphere_accel(
                    x, t, f.fac32, p, **k2(x, p)),
                lambda x, m, f=f, p=p, t=twT: sk.sphere_accel_plain(
                    x, t, f.fac32, p))
        elif key == "K4":
            out[key] = (lambda x, m, p=p: ck.cyl_coef(x, m, p),
                        lambda x, m, p=p: ck.cyl_coef_plain(x, m, p))
        else:
            Ct = ck.contract_coef_tables(f.coefficients(x, m), f.tab3,
                                         p.xrows, p.ncy)
            out[key] = (lambda x, m, p=p, C=Ct: ck.cyl_accel(x, C, p,
                                                             **k5(x, p)),
                        lambda x, m, p=p, C=Ct: ck.cyl_accel_plain(x, C, p))
    return out


def digest(out):
    """sha256 (first 16 hex digits) of the bytes of a kernel's output: a
    tensor, or a tuple of them."""
    import torch

    outs = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for t in outs:
        t = torch.view_as_real(t) if t.is_complex() else t
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def sweep(forces, sizes=SWEEP_SIZES, reps=20, form="default"):
    """Each kernel at each size: {"rows": [{kernel, n, device_ms,
    event_ms, event_reps, digest}], "fit": {kernel: {fixed_ms,
    ms_per_row}}}.  device_ms by queued_ms over `reps` calls; event_ms over
    `reps` launches in a row (5 x reps below 2^16 rows, where a launch is
    short); digest of one call's output; `form` as kernel_fns takes it."""
    fns = kernel_fns(forces, form)
    rows, fits = [], {}
    for key, (fn, _) in fns.items():
        _, x, m = forces[key]
        ts = []
        for n in sizes:
            xb, mb = bucket(x, m, n)
            call = lambda: fn(xb, mb)                      # noqa: E731
            dms = queued_ms(call, reps)
            er = reps * (5 if n < 65_536 else 1)
            rows.append({"kernel": key, "n": n, "device_ms": dms,
                         "event_ms": event_ms(call, er), "event_reps": er,
                         "digest": digest(call())})
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
    for key, (fn, _) in kernel_fns(forces).items():
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


def composite(root, dev):
    """chip_smoke.py's composite phases CM1-CM3 of the checkout at `root`
    (its DiskHalo ICs, 10 big steps, each kernel against its plain version
    on every bucket and its device time a big step): {kernel row name:
    {launches, ms, bound_ms}}, the composite's kernel rows.  CM3 prints
    the big step and each kernel's lines as it goes."""
    import importlib.util

    from exp_tpu_torch.bench_disk import disk_tables
    from exp_tpu_torch.bench_sphere import sphere_tables

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_at_root", Path(root) / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rows = cs.composite_path(dev, sphere_tables(lmax=4, nmax=10),
                             disk_tables())
    return {r["name"]: {k: r[k] for k in ("launches", "ms", "bound_ms")}
            for r in rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--sizes", default=",".join(map(str, SWEEP_SIZES)))
    ap.add_argument("--form", default="default",
                    choices=("default", "small", "large"))
    ap.add_argument("--profiler-check", action="store_true")
    ap.add_argument("--composite", action="store_true")
    a = ap.parse_args(argv)
    keys = tuple(a.kernels.split(","))
    if not set(keys) <= set(KERNELS + EXTRA):
        ap.error(f"--kernels: choose from {','.join(KERNELS + EXTRA)}")
    sizes = tuple(int(v) for v in a.sizes.split(","))
    root = Path(a.root or Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device; it times the card",
              file=sys.stderr)
        return 1
    from exp_tpu_torch.bench_disk import disk_tables
    from exp_tpu_torch.bench_sphere import sphere_tables
    from exp_tpu_torch.ops import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    out = {"root": str(root), "device": torch.cuda.get_device_name(dev)}
    if a.composite:
        _build.build_all()
        out["composite"] = composite(root, dev)
    else:
        _build.build_all(sorted({s for k in keys for s in SOURCES[k]}))
        sph = sphere_tables(lmax=4, nmax=10) if SPHERE_KEYS & set(keys) \
            else None
        t10 = (sphere_tables(lmax=10, nmax=10) if LMAX10_KEYS & set(keys)
               else None)
        disk = disk_tables() if {"K4", "K5", "K5halo"} & set(keys) else None
        forces = samples(dev, sph, disk, n_max=max(sizes), keys=keys,
                         tables10=t10)
        if a.profiler_check:
            out["profiler_check"] = profiler_check(forces)
        else:
            out["sweep"] = sweep(forces, sizes=sizes, form=a.form)
    out["sec"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
