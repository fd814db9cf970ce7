"""The composite's energy bars (port of scripts/direct_energy_check.py and
scripts/ab_relevel_composite.py): the true energy of a fixed subsample,
by a direct pair sum over every live particle, through the disk's bar
transient.

The represented-field energy of the disk+halo composite (OUTLOG's KE +
1/2 sum m phi_rep, phi_rep the truncated expansion) drifts by ~4e-2 in the
transient; the direct sum tells bookkeeping from physics.  At evenly
spaced big-step boundaries a fixed random subsample, chosen by persistent
id, has its potential recomputed by the unsoftened Newtonian pair sum over
every live particle (f32 on the device, the energy sums in f64 on the
host):

  E_rep     KE + 1/2 sum m phi_rep over every particle,
  E_sub_rep the same over the subsample,
  E_sub_dir the subsample's KE + 1/2 sum m phi_direct (the true energy),
  E_dir_est KE + (M_tot / M_sub) 1/2 sum_sub m phi_direct.

`ab` runs the relevel-cadence arms: A (dtime, relevel every big step),
B (dtime / 2, every big step) and C (dtime, every second big step) over
the same time, each gauged by the subsample's true energy at its start
and end, and its level populations at the end.

    python -m exp_tpu_torch.bench_energy direct [--n-halo N] [--n-disk N]
        [--nbig B] [--nsnap S] [--nsub K] [--dtime T] [--device D]
        [--out PATH]
    python -m exp_tpu_torch.bench_energy ab [--n-halo N] [--n-disk N]
        [--nbig B] [--nsub K] [--dtime T] [--device D] [--out PATH]
    python -m exp_tpu_torch.bench_energy spread [--seeds 3,4]
        [--perts 0,1e-6] [--n-halo N] [--n-disk N] [--nbig B] [--nsub K]
        [--device D]

`spread` runs `ab`'s A and B arms for each IC seed at each small relative
change of the step (run_spread), the spread that |dE_A - dE_B| is read
against.

Both build the composite of bench_composite.py (its forces, DiskHalo ICs,
M 4, dtime 2e-3, dynfracV 0.01, dynfracA 0.03) with cap_headroom 4, as
the scripts do: `direct` runs 500 big steps with NSNAP 6 and NSUB 65,536,
`ab` 100 big steps an arm.  Each writes the JSON of doc/direct_energy.json
or doc/ab_relevel_composite.json (keys and layout) and prints the gates of
tests/test_energy_artifacts.py that fail (`direct_gates`, `ab_gates`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from exp_tpu_torch import resolve_device

N_HALO, N_DISK = 786_432, 262_144
M = 4
DTIME = 2e-3
CAP_HEADROOM = 4
NBIG_DIRECT, NSNAP, NSUB = 500, 6, 65_536
NBIG_AB = 100
SUB_SEED = 11
#: the pair sum's temporaries at one time, as in forces/direct.py
TMP_BYTES = 1 << 30
#: source rows a chunk (the scripts' SCH)
SCH = 65_536
_FIELDS = ("x", "v", "mass", "pot", "indx")


def make_phi_direct(tmp_bytes: int = TMP_BYTES, sch: int = SCH):
    """phi(xt, xs, ms) = -sum_j m_j / |xt - xs_j| over the sources,
    unsoftened, self-pairs masked by r^2 > 0, all in f32 on the tensors'
    device.  Sources in chunks of `sch`, each chunk's sum added to a
    target's running total in order; targets in chunks that keep a chunk
    pair's temporaries (r^2 and the pair terms, with their masks: 6 f32
    words a pair) under `tmp_bytes`."""
    def phi_direct(xt, xs, ms):
        xt, xs, ms = (a.to(torch.float32) for a in (xt, xs, ms))
        ns = xs.shape[0]
        sc = max(1, min(sch, ns))
        tc = max(1, tmp_bytes // (sc * 6 * 4))
        out = []
        for xtc in xt.split(tc):
            acc = torch.zeros(xtc.shape[0], dtype=torch.float32,
                              device=xt.device)
            for xsc, msc in zip(xs.split(sc), ms.split(sc)):
                r2 = (xtc[:, 0:1] - xsc[None, :, 0]) ** 2
                r2 += (xtc[:, 1:2] - xsc[None, :, 1]) ** 2
                r2 += (xtc[:, 2:3] - xsc[None, :, 2]) ** 2
                inv = torch.where(r2 > 0.0,
                                  torch.rsqrt(torch.clamp(r2, min=1e-30)),
                                  torch.zeros((), dtype=r2.dtype,
                                              device=r2.device))
                acc = acc - (inv * msc[None, :]).sum(-1)
            out.append(acc)
        return torch.cat(out)

    return phi_direct


def snapshot(st):
    """Host phase space per component at a big-step boundary (every level
    closed its kick there)."""
    from exp_tpu_torch.nbody.multistep import flatten_buckets

    out = {}
    for n, bs in st.items():
        ps = flatten_buckets(bs)
        out[n] = {k: getattr(ps, k).detach().cpu().numpy() for k in _FIELDS}
    return out


def sources(snap, device):
    """Every live particle of every component as f32 sources on
    `device`."""
    xs = np.concatenate([d["x"][d["mass"] > 0] for d in snap.values()])
    ms = np.concatenate([d["mass"][d["mass"] > 0] for d in snap.values()])
    return (torch.as_tensor(xs, dtype=torch.float32, device=device),
            torch.as_tensor(ms, dtype=torch.float32, device=device))


def subsample_ids(n_halo, n_disk, nsub, halo_ids=None, disk_ids=None):
    """The fixed subsample by persistent id, split between the components
    in proportion to their counts (rng seed 11, as the scripts draw it;
    the ids are 1..n when not given)."""
    rng = np.random.default_rng(SUB_SEED)
    nsub_h = int(round(nsub * n_halo / (n_halo + n_disk)))
    hi = np.arange(1, n_halo + 1) if halo_ids is None else halo_ids
    di = np.arange(1, n_disk + 1) if disk_ids is None else disk_ids
    return {"halo": np.sort(rng.choice(hi, nsub_h, replace=False)),
            "disk": np.sort(rng.choice(di, nsub - nsub_h, replace=False))}


def _rows_of(d, ids):
    """Rows of the live particles of `d` with the given ids."""
    live = d["mass"] > 0
    idx = d["indx"][live]
    order = np.argsort(idx)
    return live, order[np.searchsorted(idx[order], ids)]


def energies(snap, sub_ids, phi_fn, src, device):
    """The energy row of one snapshot (direct_energy_check.py:174-201)."""
    KE = PE_rep = Mtot = 0.0
    sub_ke = sub_pe_rep = sub_pe_dir = sub_m = 0.0
    for n, d in snap.items():
        live, rows = _rows_of(d, sub_ids[n])
        m = d["mass"][live].astype(np.float64)
        v = d["v"][live].astype(np.float64)
        KE += float((0.5 * m * (v * v).sum(1)).sum())
        PE_rep += float(0.5 * (m * d["pot"][live]).sum())
        Mtot += float(m.sum())
        xt = torch.as_tensor(d["x"][live][rows], dtype=torch.float32,
                             device=device)
        phid = phi_fn(xt, *src).cpu().numpy().astype(np.float64)
        ms, vs = m[rows], v[rows]
        sub_ke += float((0.5 * ms * (vs * vs).sum(1)).sum())
        sub_pe_rep += float(0.5 * (ms * d["pot"][live][rows]).sum())
        sub_pe_dir += float(0.5 * (ms * phid).sum())
        sub_m += float(ms.sum())
    return {"KE": KE, "PE_rep": PE_rep, "Mtot": Mtot, "E_rep": KE + PE_rep,
            "E_sub_rep": sub_ke + sub_pe_rep,
            "E_sub_dir": sub_ke + sub_pe_dir,
            "E_dir_est": KE + (Mtot / sub_m) * sub_pe_dir, "sub_m": sub_m}


def sub_energies(snap, sub_ids, phi_fn, src, device):
    """Per particle of the subsample, per component in id order: its KE,
    its 1/2 m phi_direct, its 1/2 m phi_rep (f64) and its position."""
    out = {}
    for n, d in snap.items():
        live, rows = _rows_of(d, sub_ids[n])
        m = d["mass"][live].astype(np.float64)[rows]
        v = d["v"][live].astype(np.float64)[rows]
        x = d["x"][live][rows]
        phid = phi_fn(torch.as_tensor(x, dtype=torch.float32, device=device),
                      *src).cpu().numpy().astype(np.float64)
        out[n] = (0.5 * m * (v * v).sum(1), 0.5 * m * phid,
                  0.5 * m * d["pot"][live][rows].astype(np.float64), x)
    return out


def true_energy(snap, sub_ids, phi_fn, src, device):
    """The subsample's true and represented energies
    (ab_relevel_composite.py:101-131)."""
    E = E_rep = 0.0
    for ke, ped, per, _ in sub_energies(snap, sub_ids, phi_fn, src,
                                        device).values():
        E += float(ke.sum()) + float(ped.sum())
        E_rep += float(ke.sum()) + float(per.sum())
    return E, E_rep


def make_runner(halo, disk, dtime=DTIME, cap_headroom=CAP_HEADROOM, m=M):
    """The scripts' runner: the composite's, at cap_headroom 4."""
    from exp_tpu_torch.bench_composite import COUPLES, DYN
    from exp_tpu_torch.nbody.multistep import MultistepRunner

    return MultistepRunner({"halo": halo, "disk": disk}, COUPLES, dtime, m,
                           dynparams=DYN, cap_headroom=cap_headroom,
                           fused=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_direct(halo, disk, ic, device=None, nbig=NBIG_DIRECT, nsnap=NSNAP,
               nsub=NSUB, dtime=DTIME, m=M, tail=0, log=print):
    """The direct-sum energy check (direct_energy_check.py:main) on the
    given forces and ICs; returns the artifact's dict, with `pair_ms` (the
    host-clock ms of each snapshot's pair sums) beside it, and with `tail`
    > 0, `tail_rows`: the subsample's true energy at each of the last
    `tail` big steps (t, its change over the first row's), outside
    `rows`."""
    from exp_tpu_torch.bench_composite import flat_systems

    device = resolve_device(device)
    n_halo, n_disk = len(ic["mh"]), len(ic["md"])
    runner = make_runner(halo, disk, dtime, m=m)
    flat = flat_systems(ic, device)
    sub_ids = subsample_ids(n_halo, n_disk, nsub,
                            flat["halo"].indx.cpu().numpy(),
                            flat["disk"].indx.cpu().numpy())
    st, regs, _, _ = runner.init_state(flat)
    phi_fn = make_phi_direct()
    rows, pair_ms, tail_rows = [], [], []
    t0 = time.time()

    def tail_row(t):
        snap = snapshot(st)
        e, _ = true_energy(snap, sub_ids, phi_fn, sources(snap, device),
                           device)
        tail_rows.append([t, abs(e - rows[0]["E_sub_dir"])
                          / abs(rows[0]["E_sub_dir"])])

    def measure(t):
        snap = snapshot(st)
        src = sources(snap, device)
        _sync(device)
        tp = time.perf_counter()
        e = energies(snap, sub_ids, phi_fn, src, device)
        _sync(device)
        pair_ms.append((time.perf_counter() - tp) * 1e3)
        e["t"] = t
        rows.append(e)
        E0 = rows[0]

        def rel(k):
            return abs(e[k] - E0[k]) / abs(E0[k])

        log(f"t={t:.3f}  dE_rep/E={rel('E_rep'):.3e}  "
            f"dE_sub_dir/E={rel('E_sub_dir'):.3e}  "
            f"wall={time.time() - t0:.0f}s")

    measure(0.0)
    every = max(1, nbig // nsnap)
    for ib in range(1, nbig + 1):
        st, regs, _, _ = runner.bigstep(st, regs)
        st, regs = runner.relevel(st, regs)
        if ib % every == 0 or ib == nbig:
            measure(ib * dtime)
            if ib > nbig - tail:
                tail_rows.append([ib * dtime, abs(
                    rows[-1]["E_sub_dir"] - rows[0]["E_sub_dir"])
                    / abs(rows[0]["E_sub_dir"])])
        elif ib > nbig - tail:
            tail_row(ib * dtime)
    E0 = rows[0]

    def worst(k):
        return max(abs(r[k] - E0[k]) / abs(E0[k]) for r in rows)

    return {"n_halo": n_halo, "n_disk": n_disk, "multistep": m,
            "dtime": dtime, "nbig": nbig, "nsub": nsub,
            "max_dE_rep": worst("E_rep"),
            "max_dE_sub_rep": worst("E_sub_rep"),
            "max_dE_sub_dir": worst("E_sub_dir"),
            "max_dE_dir_est": worst("E_dir_est"), "rows": rows,
            "pair_ms": pair_ms, "wall_sec": time.time() - t0,
            "relevel_fallbacks": runner.n_fallbacks,
            **({"tail_rows": tail_rows} if tail else {})}


def run_arm(halo, disk, ic, device=None, dtime=DTIME, nbig=NBIG_AB,
            nrelevel=1, nsub=NSUB, m=M, runner=None, name="arm",
            ends=None, log=print):
    """One relevel-cadence arm (ab_relevel_composite.py:133-159): from the
    ICs, `nbig` big steps of `dtime` with a relevel every `nrelevel`; the
    subsample's true and represented energy at both ends and the level
    populations at the end.  `runner` (the A and C arms share one, as the
    script's do) defaults to a fresh one at `dtime`.  A dict `ends` gets
    the subsample's end-state sub_energies."""
    from exp_tpu_torch.bench_composite import flat_systems

    device = resolve_device(device)
    sub_ids = subsample_ids(len(ic["mh"]), len(ic["md"]), nsub)
    phi_fn = make_phi_direct()
    runner = runner or make_runner(halo, disk, dtime, m=m)
    t0 = time.time()
    st, regs, _, _ = runner.init_state(flat_systems(ic, device))
    snap = snapshot(st)
    E0, E0_rep = true_energy(snap, sub_ids, phi_fn, sources(snap, device),
                             device)
    for ib in range(1, nbig + 1):
        st, regs, _, _ = runner.bigstep(st, regs)
        if ib % nrelevel == 0:
            st, regs = runner.relevel(st, regs)
    snap = snapshot(st)
    sub = sub_energies(snap, sub_ids, phi_fn, sources(snap, device), device)
    E1 = E1_rep = 0.0
    for ke, ped, per, _ in sub.values():
        E1 += float(ke.sum()) + float(ped.sum())
        E1_rep += float(ke.sum()) + float(per.sum())
    if ends is not None:
        ends.update(sub)
    lc = runner.level_counts(st)
    out = {"dtime": dtime, "nbig": nbig, "nrelevel": nrelevel,
           "T": dtime * nbig, "E0": E0, "E1": E1,
           "dE_true": abs(E1 - E0) / abs(E0),
           "dE_rep": abs(E1_rep - E0_rep) / abs(E0_rep),
           "levels": lc, "wall_sec": time.time() - t0}
    log(f"{name}: dtime={dtime:g} nrelevel={nrelevel} "
        f"dE_true={out['dE_true']:.3e} dE_rep={out['dE_rep']:.3e} "
        f"levels={lc} ({out['wall_sec']:.0f}s)")
    return out


def run_ab(halo, disk, ic, device=None, nbig=NBIG_AB, nsub=NSUB, dtime=DTIME,
           m=M, log=print):
    """The relevel-cadence arms A, C (sharing a runner, as the script's
    do) and B (ab_relevel_composite.py:main); returns the artifact's
    dict."""
    kw = dict(nsub=nsub, m=m, log=log)
    runner_ac = make_runner(halo, disk, dtime, m=m)
    A = run_arm(halo, disk, ic, device, dtime, nbig, 1, runner=runner_ac,
                name="A", **kw)
    C = run_arm(halo, disk, ic, device, dtime, nbig, 2, runner=runner_ac,
                name="C", **kw)
    B = run_arm(halo, disk, ic, device, dtime / 2, 2 * nbig, 1, name="B",
                **kw)
    return {"n_halo": len(ic["mh"]), "n_disk": len(ic["md"]),
            "multistep": m, "nsub": nsub, "A": A, "B": B, "C": C,
            "ratio_AB_true": A["dE_true"] / max(B["dE_true"], 1e-300),
            "ratio_CA_true": C["dE_true"] / max(A["dE_true"], 1e-300)}


def _split(a, b):
    """Where E1_A - E1_B comes from: `a` and `b` are two arms' end-state
    sub_energies."""
    d = np.concatenate([a[n][0] + a[n][1] - b[n][0] - b[n][1] for n in a])
    dx = np.concatenate([np.linalg.norm(a[n][3].astype(np.float64)
                                        - b[n][3], axis=1) for n in a])
    top = np.sort(np.abs(d))[::-1]
    return {"E1_A_minus_B": float(d.sum()), "sum_abs": float(top.sum()),
            "top10_abs": float(top[:10].sum()),
            "top1000_abs": float(top[:1000].sum()),
            "by_comp": {n: {"KE": float((a[n][0] - b[n][0]).sum()),
                            "PE_dir": float((a[n][1] - b[n][1]).sum()),
                            "PE_rep": float((a[n][2] - b[n][2]).sum())}
                        for n in a},
            "dx_median": float(np.median(dx)),
            "dx_p99": float(np.quantile(dx, 0.99)),
            "dx_max": float(dx.max())}


def run_spread(halo, disk, ic, device=None, perts=(0.0, 1e-6), nbig=NBIG_AB,
               nsub=NSUB, dtime=DTIME, m=M, log=print):
    """EN2's dt pair, A (dtime (1 + p), `nbig` big steps) and B (half the
    step, twice the steps), at each relative change p of the step: how far
    a change far below either arm's moves dE_A, dE_B and |dE_A - dE_B|.
    At the first p, `split` says where E1_A - E1_B comes from: the sum of
    the subsample's particle terms |e_A - e_B| beside that of its 10 and
    1,000 largest, each component's KE and PE parts, and how far a
    particle's end positions in A and B lie apart."""
    kw = dict(nsub=nsub, m=m, log=log)
    out = []
    for i, p in enumerate(perts):
        ea, eb = ({}, {}) if i == 0 else (None, None)
        A = run_arm(halo, disk, ic, device, dtime * (1 + p), nbig, 1,
                    name=f"A p={p:g}", ends=ea, **kw)
        B = run_arm(halo, disk, ic, device, dtime * (1 + p) / 2, 2 * nbig,
                    1, name=f"B p={p:g}", ends=eb, **kw)
        row = {"pert": p, "dE_A": A["dE_true"], "dE_B": B["dE_true"],
               "abs_dE_A_minus_B": abs(A["dE_true"] - B["dE_true"]),
               "dE_rep_A": A["dE_rep"], "dE_rep_B": B["dE_rep"],
               "levels_A": A["levels"], "levels_B": B["levels"]}
        if i == 0:
            row["split"] = _split(ea, eb)
        log(json.dumps(row))
        out.append(row)
    return out


def direct_gates(d):
    """The gates of tests/test_energy_artifacts.py:42-66 on a direct
    artifact; returns the names of those that fail."""
    rows = d["rows"]
    E0 = rows[0]

    def rel(r, k):
        return abs(r[k] - E0[k]) / abs(E0[k])

    gates = {
        "n_total == 1048576": d["n_halo"] + d["n_disk"] == 1_048_576,
        "multistep == 4": d["multistep"] == 4,
        "nbig == 500": d["nbig"] == 500,
        "t from 0 to 1": rows[0]["t"] == 0.0
        and abs(rows[-1]["t"] - 1.0) <= 1e-6,
        "max_dE_rep > 3e-2": d["max_dE_rep"] > 3e-2,
        "max_dE_sub_rep > 3e-2": d["max_dE_sub_rep"] > 3e-2,
        "max_dE_sub_dir < 1e-2": d["max_dE_sub_dir"] < 1e-2,
        "last E_sub_dir < 1e-3": rel(rows[-1], "E_sub_dir") < 1e-3,
        "last E_sub_rep > 3e-2": rel(rows[-1], "E_sub_rep") > 3e-2,
        "max_dE_dir_est < 1e-2": d["max_dE_dir_est"] < 1e-2,
    }
    return [k for k, ok in gates.items() if not ok]


def ab_gates(d):
    """The gates of tests/test_energy_artifacts.py:69-87 on an ab artifact;
    returns the names of those that fail."""
    A, B, C = d["A"], d["B"], d["C"]

    def close(a, b):
        return abs(a - b) <= 1e-6 * abs(b)

    gates = {
        "n_total == 1048576": d["n_halo"] + d["n_disk"] == 1_048_576,
        "multistep == 4": d["multistep"] == 4,
        "same T": close(A["T"], B["T"]) and close(B["T"], C["T"]),
        "B dtime = A dtime / 2": close(B["dtime"], A["dtime"] / 2),
        "C nrelevel = 2 A nrelevel": C["nrelevel"] == 2 * A["nrelevel"],
        "|dE_A - dE_B| < 1e-4": abs(A["dE_true"] - B["dE_true"]) < 1e-4,
        "|dE_C - dE_A| < 1e-3": abs(C["dE_true"] - A["dE_true"]) < 1e-3,
    }
    for comp in ("halo", "disk"):
        la, lc = A["levels"][comp], C["levels"][comp]
        n = sum(la)
        gates[f"{comp} levels A vs C within 5%"] = all(
            abs(a - c) / n < 0.05 for a, c in zip(la, lc))
    return [k for k, ok in gates.items() if not ok]


def _main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("direct", "ab", "spread"))
    ap.add_argument("--n-halo", type=int, default=N_HALO)
    ap.add_argument("--n-disk", type=int, default=N_DISK)
    ap.add_argument("--nbig", type=int, default=None)
    ap.add_argument("--nsnap", type=int, default=NSNAP)
    ap.add_argument("--nsub", type=int, default=NSUB)
    ap.add_argument("--dtime", type=float, default=DTIME,
                    help="big-step time (the scripts' 2e-3; `ab`'s B arm "
                         "takes half of it)")
    ap.add_argument("--tail", type=int, default=0,
                    help="`direct`: also the true energy at each of the "
                         "last TAIL big steps")
    ap.add_argument("--seeds", default="3",
                    help="`spread`: comma-separated DiskHalo IC seeds")
    ap.add_argument("--perts", default="0,1e-6",
                    help="`spread`: comma-separated relative step changes")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None, help="JSON path (default: print)")
    a = ap.parse_args()
    from exp_tpu_torch.bench_composite import composite_forces, composite_ics

    device = resolve_device(a.device)
    halo, disk = composite_forces(device)
    if a.mode == "spread":
        res = {"n_halo": a.n_halo, "n_disk": a.n_disk, "nsub": a.nsub,
               "seeds": {}}
        for seed in (int(v) for v in a.seeds.split(",")):
            ic = composite_ics(halo, disk, a.n_halo, a.n_disk, seed=seed)
            res["seeds"][seed] = run_spread(
                halo, disk, ic, device,
                tuple(float(v) for v in a.perts.split(",")),
                nbig=a.nbig or NBIG_AB, nsub=a.nsub, dtime=a.dtime)
        print(json.dumps(res))
        return
    ic = composite_ics(halo, disk, a.n_halo, a.n_disk)
    if a.mode == "direct":
        res = run_direct(halo, disk, ic, device, nbig=a.nbig or NBIG_DIRECT,
                         nsnap=a.nsnap, nsub=a.nsub, dtime=a.dtime,
                         tail=a.tail)
        failed = direct_gates(res)
    else:
        res = run_ab(halo, disk, ic, device, nbig=a.nbig or NBIG_AB,
                     nsub=a.nsub, dtime=a.dtime)
        failed = ab_gates(res)
    if device.type == "cuda":
        res["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
    res["gates_failed"] = failed
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    _main()
