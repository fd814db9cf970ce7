"""The composite problem of the benches (port of bench_suite.py:183-314): a
786,432-particle Hernquist halo (sphereSL lmax 4, nmax 10, the sphere
benches' tables) and a 262,144-particle EOF exponential disk (mmax 6, nmax
18, the disk bench's tables), both with backend='pallas', from the DiskHalo
ICs (Mdisk 0.05, a 0.01, h 0.002, seed 3), coupled both ways and stepped by
the 4-level binary multistep (M=4, dtime 2e-3, dynfracV 0.01, dynfracA 0.03,
cap_headroom 2).  The ICs are built fresh (no disk cache).

    python -m exp_tpu_torch.bench_composite bench [--n-halo N] [--n-disk N]
        [--nbig B]
    python -m exp_tpu_torch.bench_composite kdk [--n-halo N] [--n-disk N]
        [--nbig B] [--device D] [--max-warmup W]
    python -m exp_tpu_torch.bench_composite profile [--n-halo N] [--n-disk N]
        [--nbig B]

Each mode builds the tables, the forces and the ICs, runs init_state and
the warmup (big step + relevel until the capacity signature has been
stable for 2 consecutive relevels, at most 8 big steps).  `bench` then
times B big steps and their relevels separately on a CUDA device (a CPU
run is refused: its time is no device metric) and prints one JSON line:
composite_particle_substeps_per_sec (the sum over components of c_l 2^l
over the big-step time, the multistep figure of merit), step_ms per big
step, relevel_ms, the level counts.  `kdk` runs B big steps with relevels
on the named device (the CPU takes the kernels' plain versions) and prints
the gates of chip_smoke.py's CM2 phase (with `--max-warmup 0` from
init_state on, the window of the YAML driver's run in R2): the virial
ratio of the ICs, the energy drift, the level populations' moves, the
capacity signature, the live count and identities, and each kernel's
launches from init_state on beside the count the schedule implies (a CPU
run launches none).
`profile` traces B big steps and B relevels in turn with torch.profiler
and prints the device time of each by category (the port's kernels, the
rebucket's sort and gathers, reductions, copies, elementwise glue) and by
operation, the launches and the device's busy share.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from exp_tpu_torch import resolve_device
from exp_tpu_torch.ops import (cube_kernels, cyl_kernels, slab_kernels,
                               sphere_kernels)

N_HALO, N_DISK = 786_432, 262_144
M = 4
DTIME = 2e-3
DYN = {"dynfracV": 0.01, "dynfracA": 0.03}
CAP_HEADROOM = 2
MDISK, ACYL, HCYL = 0.05, 0.01, 0.002
SEED = 3
MAX_WARMUP = 8
COUPLES = {"halo": ["halo", "disk"], "disk": ["halo", "disk"]}
KERNEL_MODULES = (sphere_kernels, cyl_kernels, cube_kernels, slab_kernels)


def composite_forces(device=None, sphere_tables=None, disk_tables=None):
    """The bench's halo and disk forces with backend='pallas': the sphere
    benches' tables (lmax 4, nmax 10) and the disk bench's EOF tables
    (mmax 6, nmax 18), built fresh unless given."""
    from exp_tpu_torch.bench_disk import disk_force
    from exp_tpu_torch.bench_disk import disk_tables as build_disk
    from exp_tpu_torch.bench_sphere import sphere_force
    from exp_tpu_torch.bench_sphere import sphere_tables as build_sphere

    device = resolve_device(device)
    ts = sphere_tables if sphere_tables is not None else build_sphere(4, 10)
    tc = disk_tables if disk_tables is not None else build_disk()
    return sphere_force(ts, device), disk_force(tc, device)


def composite_ics(halo_force, disk_force, n_halo=N_HALO, n_disk=N_DISK,
                  seed=SEED):
    """Self-consistent disk+halo ICs (ic/diskhalo.py), as host arrays: the
    halo DF in the combined potential and the disk's Jeans moments from the
    measured expansions, so the level populations are stationary.  Halo
    masses are clipped at 0, as bench_suite.composite_ics clips them."""
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.ic.diskhalo import diskhalo_ics

    ics = diskhalo_ics(hernquist_model(rmin=1e-3, rmax=20.0), n_halo=n_halo,
                       n_disk=n_disk, Mdisk=MDISK, acyl=ACYL, hcyl=HCYL,
                       halo_force=halo_force, disk_force=disk_force,
                       seed=seed)
    return {"xh": ics.x_halo, "vh": ics.v_halo,
            "mh": np.maximum(ics.m_halo, 0.0), "xd": ics.x_disk,
            "vd": ics.v_disk, "md": ics.m_disk}


def ics_virial(halo_force, disk_force, ic):
    """-2T/VC of the ICs in the measured fields of both components."""
    from exp_tpu_torch.ic.diskhalo import _f32, virial_ratio

    dev = next(halo_force.buffers()).device
    ch = halo_force.coefficients(_f32(ic["xh"], dev), _f32(ic["mh"], dev))
    cd = disk_force.coefficients(_f32(ic["xd"], dev), _f32(ic["md"], dev))
    return virial_ratio([(ic["xh"], ic["vh"], ic["mh"]),
                         (ic["xd"], ic["vd"], ic["md"])],
                        [(halo_force, ch), (disk_force, cd)])


def make_runner(halo_force, disk_force):
    """The bench's runner (bench_suite.py:258-261, fused as there: the port
    runs the same eager loop either way; a CUDA graph of the big step is
    ROADMAP's perf_opt item 9b.1)."""
    from exp_tpu_torch.nbody.multistep import MultistepRunner

    return MultistepRunner({"halo": halo_force, "disk": disk_force}, COUPLES,
                           DTIME, M, dynparams=DYN, cap_headroom=CAP_HEADROOM,
                           fused=True)


def flat_systems(ic, device):
    from exp_tpu_torch.nbody.particles import ParticleSystem

    return {"halo": ParticleSystem.from_arrays(ic["xh"], ic["vh"], ic["mh"],
                                               device=device),
            "disk": ParticleSystem.from_arrays(ic["xd"], ic["vd"], ic["md"],
                                               device=device)}


def warmup(runner, st, regs, max_warmup=MAX_WARMUP):
    """Big step + relevel until the capacity signature is unchanged for 2
    consecutive relevels, at most max_warmup big steps (bench_suite.py:
    271-285).  Returns (st, regs, diag, big steps run, stable)."""
    sig = runner._caps_sig(st)
    stable, n, diag = 0, 0, None
    while stable < 2 and n < max_warmup:
        st, regs, _, diag = runner.bigstep(st, regs)
        st, regs = runner.relevel(st, regs)
        n += 1
        s2 = runner._caps_sig(st)
        stable = stable + 1 if s2 == sig else 0
        sig = s2
    return st, regs, diag, n, stable >= 2


def etot(diag):
    """KE + PE summed over the components (PE = 1/2 sum m Phi_total)."""
    return sum(float(d["KE"]) + float(d["PE"]) for d in diag.values())


def live_ids(st):
    """The sorted identities of the live particles of every component."""
    ids = torch.cat([b.indx[b.mass > 0] for bs in st.values() for b in bs])
    return torch.sort(ids).values


def substeps_per_bigstep(counts):
    """Particle-substeps of one big step: level-l particles take 2^l."""
    return sum(c * 2 ** l for comp in counts.values()
               for l, c in enumerate(comp))


def expected_launches(runner, nbig_total):
    """The launches of K1, K4 (sphere_coef, cyl_coef) and K2, K5
    (sphere_accel, cyl_accel) that the schedule implies from init_state on:
    a big step projects level l 2^l times, 2^(M+1) - 1 projections a
    component, and kicks each level as often, each kick evaluating both
    forces on the bucket; init_state's two passes project every bucket and
    evaluate both forces on it; a relevel that rebuilt the registers
    projects every bucket again."""
    per, nb = 2 ** (runner.M + 1) - 1, runner.M + 1
    proj = per * nbig_total + (2 + runner.n_rebuilds) * nb
    acc = 2 * per * nbig_total + 2 * 2 * nb
    return {"sphere_coef": proj, "cyl_coef": proj, "sphere_accel": acc,
            "cyl_accel": acc}


def kernel_launches():
    """The launch counts of every kernel wrapper of the port."""
    return {k: v for mod in KERNEL_MODULES
            for k, v in mod.launch_counts.items()}


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    for mod in KERNEL_MODULES:
        mod.reset_launch_counts()


def composite_run(runner, st, regs, diag0, nbig):
    """`nbig` big steps with relevels after the warmup, with the gates of
    chip_smoke.py's CM2 phase measured: after every relevel the live count
    and the identities against the start, the capacity signature, and each
    level's move from its start as a share of its component (the largest
    over the run and the net one at its end, which tests/test_diskhalo.py
    gates); finiteness of the last state and coefficients; the energy drift
    from the warmup's last big step (diag0) to the last.  Returns (st,
    regs, report)."""
    ids0 = live_ids(st)
    sig0 = runner._caps_sig(st)
    c0 = runner.level_counts(st)

    def move(c):
        return max(abs(a - b) / sum(c0[n]) for n in c
                   for a, b in zip(c[n], c0[n]))

    e0 = etot(diag0)
    ids_same, sig_same, worst, c = True, True, 0.0, c0
    coef = diag = None
    for _ in range(nbig):
        st, regs, coef, diag = runner.bigstep(st, regs)
        st, regs = runner.relevel(st, regs)
        ids_same &= bool(torch.equal(live_ids(st), ids0))
        sig_same &= runner._caps_sig(st) == sig0
        c = runner.level_counts(st)
        worst = max(worst, move(c))
    finite = all(bool(torch.isfinite(t).all()) for bs in st.values()
                 for b in bs for t in (b.x, b.v, b.acc, b.pot)) and all(
        bool(torch.isfinite(c).all()) for c in coef.values())
    e1 = etot(diag)
    return st, regs, {
        "nbig": nbig, "Etot0": e0, "Etot1": e1,
        "dE_rel": abs(e1 - e0) / abs(e0), "finite": finite,
        "n_live": int(ids0.numel()), "ids_unchanged": ids_same,
        "caps_unchanged": sig_same, "level_move_max": worst,
        "level_move_net": move(c), "level_counts0": c0, "level_counts": c,
        "overrun": runner.overrun, "caps": runner.caps}


def prepare(n_halo=N_HALO, n_disk=N_DISK, device=None, forces=None,
            seed=SEED):
    """Forces and ICs (DiskHalo draw `seed`) with their virial ratio;
    returns a dict of them and the set-up times."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    halo, disk = forces if forces is not None else composite_forces(device)
    t1 = time.perf_counter()
    ic = composite_ics(halo, disk, n_halo, n_disk, seed)
    vr = ics_virial(halo, disk, ic)
    return {"halo": halo, "disk": disk, "ic": ic, "virial": vr,
            "device": device, "tables_sec": t1 - t0,
            "ics_sec": time.perf_counter() - t1}


def start(s, max_warmup=MAX_WARMUP):
    """The runner, init_state and the warmup (at most max_warmup big steps;
    with none, `diag` is init_state's) on prepare's forces and ICs; adds
    them to `s` and returns it."""
    t0 = time.perf_counter()
    runner = make_runner(s["halo"], s["disk"])
    st, regs, _, diag0 = runner.init_state(flat_systems(s["ic"],
                                                        s["device"]))
    st, regs, diag, nw, stable = warmup(runner, st, regs, max_warmup)
    diag = diag0 if diag is None else diag
    s.update(runner=runner, st=st, regs=regs, diag=diag, warmup_bigsteps=nw,
             warmup_stable=stable, init_warmup_sec=time.perf_counter() - t0)
    return s


def setup(n_halo=N_HALO, n_disk=N_DISK, device=None):
    """prepare, then start."""
    return start(prepare(n_halo, n_disk, device))


def time_bigsteps(runner, st, regs, nbig, t=0.0):
    """Host-clock times of `nbig` big steps and of their relevels, each
    ended by a synchronise; the simulation time runs from `t` by dtime a
    big step, as the YAML driver passes it.  Returns (st, regs, big-step
    seconds, relevel seconds)."""
    big, rel = [], []
    torch.cuda.synchronize()
    for _ in range(nbig):
        t0 = time.perf_counter()
        st, regs, _, _ = runner.bigstep(st, regs, t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, regs = runner.relevel(st, regs, t0=t + runner.dtime)
        t += runner.dtime
        torch.cuda.synchronize()
        big.append(t1 - t0)
        rel.append(time.perf_counter() - t1)
    return st, regs, big, rel


def bench_composite(n_halo=N_HALO, n_disk=N_DISK, nbig=3, device=None):
    """Composite multistep throughput on a CUDA device."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_composite times the card: give it a CUDA "
                           "device")
    s = setup(n_halo, n_disk, device)
    runner = s["runner"]
    st, regs, big, rel = time_bigsteps(runner, s["st"], s["regs"], nbig)
    sec = float(np.median(big))
    counts = runner.level_counts(st)
    return {"metric": "composite_particle_substeps_per_sec",
            "value": substeps_per_bigstep(counts) / sec, "unit": "1/s",
            "step_ms": sec * 1e3, "step_ms_all": [t * 1e3 for t in big],
            "relevel_ms": float(np.median(rel)) * 1e3,
            "relevel_ms_all": [t * 1e3 for t in rel],
            "n_particles": n_halo + n_disk, "multistep": M,
            "level_counts": counts, "warmup_bigsteps": s["warmup_bigsteps"],
            "warmup_stable": s["warmup_stable"], "virial": s["virial"],
            "device": torch.cuda.get_device_name(device)}


#: device-op categories of the profile, first match wins: the port's
#: kernels (K1, K2, K4, K5 and their reduction passes), the rebucket's sort
#: and gathers, PyTorch's reductions (diagnostics, counts), copies, and the
#: elementwise glue (kicks, drifts, the tableau, masks)
CATEGORIES = (("kernels", ("coef_accumulate", "coef_reduce", "accel_kernel")),
              ("sort", ("sort", "Sort")),
              ("gather", ("index", "gather", "Gather", "scatter", "nonzero")),
              ("reduce", ("reduce",)),
              ("copy", ("Memcpy", "Memset", "copy", "Copy", "Cat")),
              ("elementwise", ()))


def _category(name):
    return next(c for c, keys in CATEGORIES
                if not keys or any(k in name for k in keys))


def profile_call(fn):
    """Device ms of one call of fn() by op name, and its launches, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_op, launches = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_op[e.name] = (by_op.get(e.name, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
            launches += 1
    return by_op, launches


def _summary(by_op, launches, reps):
    """Per-call device ms, by category and by op (the largest), from sums
    over `reps` calls."""
    by_cat = {c: 0.0 for c, _ in CATEGORIES}
    for k, ms in by_op.items():
        by_cat[_category(k)] += ms / reps
    top = sorted(by_op.items(), key=lambda kv: -kv[1])
    return {"device_ms": sum(by_op.values()) / reps, "by_category": by_cat,
            "launches": launches / reps,
            "top": [{"name": k[:90], "ms": ms / reps} for k, ms in top[:12]]}


def profile_composite(n_halo=N_HALO, n_disk=N_DISK, nbig=2, device=None):
    """Device time per big step and per relevel by category and by
    operation from torch.profiler over `nbig` of each (in turn, one profile
    a call), and each one's device-busy share: its device time over its
    host-clock time measured without the profiler (the profiler slows the
    host)."""
    device = resolve_device(device)
    s = setup(n_halo, n_disk, device)
    runner = s["runner"]
    st, regs, big, rel = time_bigsteps(runner, s["st"], s["regs"], 3)
    box = {"st": st, "regs": regs}

    def bigstep():
        box["st"], box["regs"], _, _ = runner.bigstep(box["st"], box["regs"])

    def relevel():
        box["st"], box["regs"] = runner.relevel(box["st"], box["regs"])

    out = {"bigstep_ms": float(np.median(big)) * 1e3,
           "relevel_ms": float(np.median(rel)) * 1e3}
    acc = {"bigstep": ({}, 0), "relevel": ({}, 0)}
    for _ in range(nbig):
        for name, fn in (("bigstep", bigstep), ("relevel", relevel)):
            ops, n = profile_call(fn)
            tot, cnt = acc[name]
            for k, ms in ops.items():
                tot[k] = tot.get(k, 0.0) + ms
            acc[name] = (tot, cnt + n)
    for name, (tot, cnt) in acc.items():
        p = _summary(tot, cnt, nbig)
        p["busy"] = p["device_ms"] / out[f"{name}_ms"]
        out[name] = p
    out.update(level_counts=runner.level_counts(box["st"]),
               device=torch.cuda.get_device_name(device))
    return out


def _main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("bench", "kdk", "profile"))
    ap.add_argument("--n-halo", type=int, default=N_HALO)
    ap.add_argument("--n-disk", type=int, default=N_DISK)
    ap.add_argument("--nbig", type=int, default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--max-warmup", type=int, default=MAX_WARMUP)
    a = ap.parse_args()
    if a.mode == "bench":
        print(json.dumps(bench_composite(a.n_halo, a.n_disk, a.nbig or 3,
                                         a.device)))
        return
    if a.mode == "profile":
        print(json.dumps(profile_composite(a.n_halo, a.n_disk, a.nbig or 2,
                                           a.device)))
        return
    s = prepare(a.n_halo, a.n_disk, a.device)
    reset_launches()
    s = start(s, a.max_warmup)
    nbig = a.nbig or 10
    _, _, out = composite_run(s["runner"], s["st"], s["regs"], s["diag"],
                              nbig)
    runner = s["runner"]
    out.update(device=str(s["device"]), virial=s["virial"],
               n_halo=a.n_halo, n_disk=a.n_disk, M=M,
               warmup_bigsteps=s["warmup_bigsteps"],
               warmup_stable=s["warmup_stable"],
               relevel_rebuilds=runner.n_rebuilds,
               relevel_fallbacks=runner.n_fallbacks,
               launches=kernel_launches(),
               expected_launches=expected_launches(
                   runner, s["warmup_bigsteps"] + nbig),
               set_up_sec={k: s[k] for k in ("tables_sec", "ics_sec",
                                             "init_warmup_sec")})
    print(json.dumps(out))


if __name__ == "__main__":
    _main()
