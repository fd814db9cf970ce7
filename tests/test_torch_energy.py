"""The port's energy bars (exp_tpu_torch/bench_energy.py, the port of
scripts/direct_energy_check.py and scripts/ab_relevel_composite.py):

* make_phi_direct against a NumPy f64 pair sum, self-pairs and zero-mass
  sources included, through its target and source chunks;
* `direct` and `ab` at 4,096 + 2,048 particles, 4 big steps, NSUB 1,024
  on small bases (sphere lmax 2, nmax 6; EOF mmax 2, nmax 6), writing the
  keys of doc/direct_energy.json and doc/ab_relevel_composite.json;
* the gate functions pass the committed artifacts and name the gates a
  small run fails (its size is not the flagship's)."""

import json
import os

import numpy as np
import pytest
import torch

from exp_tpu_torch import bench_energy as be

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """numpy's and scipy's BLAS and torch at one thread while this module
    runs: several test workers share the CPUs, and a BLAS call at eight
    spinning threads a worker runs tens of times slower there than alone.
    The old limits come back at the end of the module."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _doc(name):
    with open(os.path.join(REPO, "doc", name)) as f:
        return json.load(f)


def test_phi_direct_matches_numpy_f64():
    """phi = -sum m / r over 5,000 sources (500 of zero mass, one target on
    a source: its self-pair is masked) at 700 targets, in chunks of 300
    targets x 1,024 sources and whole, against f64: max|dphi| / max|phi|
    within 2e-6 (f32 terms and sums of ~5 chunk partials)."""
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(5000, 3))
    ms = rng.uniform(0.5, 1.5, 5000) / 5000
    ms[::10] = 0.0
    xt = np.concatenate([rng.normal(size=(699, 3)), xs[1:2]])
    xs32 = xs.astype(np.float32).astype(np.float64)
    xt32 = xt.astype(np.float32).astype(np.float64)
    ms32 = ms.astype(np.float32).astype(np.float64)
    d = xt32[:, None, :] - xs32[None, :, :]
    r = np.sqrt((d * d).sum(-1))
    with np.errstate(divide="ignore"):
        ref = -np.where(r > 0, ms32[None, :] / r, 0.0).sum(1)
    for fn in (be.make_phi_direct(tmp_bytes=300 * 1024 * 24, sch=1024),
               be.make_phi_direct()):
        phi = fn(torch.tensor(xt), torch.tensor(xs), torch.tensor(ms))
        assert phi.dtype == torch.float32 and phi.shape == (700,)
        err = np.abs(phi.numpy() - ref).max() / np.abs(ref).max()
        assert err < 2e-6, err


@pytest.fixture(scope="module")
def small():
    """The composite on small bases with the pallas backends (their plain
    versions here) and its DiskHalo ICs at 4,096 + 2,048."""
    from exp_tpu_torch.basis.empcyl import build_empcyl_tables
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
    from exp_tpu_torch.bench_composite import ACYL, HCYL, composite_ics
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.forces.spherical import SphereSL

    ts = build_sph_sl_tables(hernquist_model(rmin=1e-3, rmax=20.0), lmax=2,
                             nmax=6, numr=800, cmap=1, rmap=1.0)
    tc = build_empcyl_tables(mmax=2, nmax=6, lmaxfid=16, nmaxfid=12,
                             acyl=ACYL, hcyl=HCYL)
    halo = SphereSL.from_tables(ts, backend="pallas", device="cpu")
    disk = CylinderForce.from_tables(tc, backend="pallas", device="cpu")
    return halo, disk, composite_ics(halo, disk, 4096, 2048)


def test_direct_run_small(small):
    """`direct` at 4 big steps and 2 snapshots: the artifact's keys, rows
    at t = 0, 2 dtime and 4 dtime, finite energies, the subsample's
    represented and direct energies close at t = 0 (the same particles in
    a field whose truncation is small for a halo-dominated sample), and
    the shape gates named as failed."""
    halo, disk, ic = small
    d = be.run_direct(halo, disk, ic, "cpu", nbig=4, nsnap=2, nsub=1024,
                      log=lambda *a: None)
    ref = _doc("direct_energy.json")
    assert set(ref) <= set(d)
    assert set(ref["rows"][0]) == set(d["rows"][0])
    assert [r["t"] for r in d["rows"]] == pytest.approx([0.0, 4e-3, 8e-3])
    assert all(np.isfinite(v) for r in d["rows"] for v in r.values())
    r0 = d["rows"][0]
    assert abs(r0["E_sub_dir"] - r0["E_sub_rep"]) < 0.1 * abs(r0["E_sub_rep"])
    assert abs(r0["sub_m"] / r0["Mtot"] - 1024 / 6144) < 0.05
    failed = be.direct_gates(d)
    assert "n_total == 1048576" in failed and "nbig == 500" in failed


def test_ab_run_small(small):
    """`ab` at 4 big steps an arm (B 8 at dtime / 2): the artifact's keys,
    the arms' times and cadences, every particle in the level counts."""
    halo, disk, ic = small
    d = be.run_ab(halo, disk, ic, "cpu", nbig=4, nsub=1024,
                  log=lambda *a: None)
    ref = _doc("ab_relevel_composite.json")
    assert set(ref) <= set(d)
    for arm in "ABC":
        assert set(ref[arm]) == set(d[arm])
        assert np.isfinite(d[arm]["dE_true"])
        assert sum(d[arm]["levels"]["halo"]) == 4096
        assert sum(d[arm]["levels"]["disk"]) == 2048
    assert d["B"]["dtime"] == pytest.approx(d["A"]["dtime"] / 2)
    assert d["A"]["T"] == pytest.approx(d["B"]["T"])
    assert d["C"]["nrelevel"] == 2
    failed = be.ab_gates(d)
    assert failed[0] == "n_total == 1048576"
    assert "same T" not in failed and "B dtime = A dtime / 2" not in failed


def test_spread_and_tail_small(small):
    """`spread` at 2 big steps an arm and two step changes: a row for each
    with both arms' drifts, the first row's split of E1_A - E1_B into
    particle terms that add up to it; `direct` with a tail of 3: the true
    energy at each of the last 3 big steps, the last one the last row's."""
    halo, disk, ic = small
    rows = be.run_spread(halo, disk, ic, "cpu", perts=(0.0, 1e-6), nbig=2,
                         nsub=1024, log=lambda *a: None)
    assert [r["pert"] for r in rows] == [0.0, 1e-6]
    assert all(np.isfinite(r["dE_A"]) and np.isfinite(r["dE_B"])
               and r["abs_dE_A_minus_B"] == abs(r["dE_A"] - r["dE_B"])
               for r in rows)
    sp = rows[0]["split"]
    assert "split" not in rows[1]
    parts = sum(c["KE"] + c["PE_dir"] for c in sp["by_comp"].values())
    assert parts == pytest.approx(sp["E1_A_minus_B"], rel=1e-9, abs=1e-15)
    assert sp["top10_abs"] <= sp["top1000_abs"] <= sp["sum_abs"]
    assert 0.0 <= sp["dx_median"] <= sp["dx_p99"] <= sp["dx_max"]
    d = be.run_direct(halo, disk, ic, "cpu", nbig=4, nsnap=2, nsub=1024,
                      tail=3, log=lambda *a: None)
    assert [t for t, _ in d["tail_rows"]] == pytest.approx([4e-3, 6e-3,
                                                            8e-3])
    r0, r1 = d["rows"][0]["E_sub_dir"], d["rows"][-1]["E_sub_dir"]
    assert d["tail_rows"][-1][1] == pytest.approx(abs(r1 - r0) / abs(r0))
    assert len(d["rows"]) == 3


@pytest.mark.parametrize("name,gates", [
    ("direct_energy.json", be.direct_gates),
    ("ab_relevel_composite.json", be.ab_gates)])
def test_gates_pass_committed_artifacts(name, gates):
    """The gate functions hold tests/test_energy_artifacts.py's gates: the
    committed TPU artifacts pass them all, and a copy with one claim
    broken fails it."""
    d = _doc(name)
    assert gates(d) == []
    if name.startswith("direct"):
        bad = dict(d, max_dE_sub_dir=2e-2)
        assert gates(bad) == ["max_dE_sub_dir < 1e-2"]
    else:
        bad = dict(d, C=dict(d["C"], dE_true=d["A"]["dE_true"] + 2e-3))
        assert gates(bad) == ["|dE_C - dE_A| < 1e-3"]


@pytest.mark.slow
@pytest.mark.parametrize("n_halo,n_disk,pert", [
    (24_576, 8_192, 0.0), (49_152, 16_384, 0.0), (49_152, 16_384, 1e-6),
    (49_152, 16_384, 2e-6)], ids=["24k", "49k", "49k-dt1e-6", "49k-dt2e-6"])
def test_ab_dt_pair_matches_exp_tpu(n_halo, n_disk, pert):
    """EN2's dt pair (arms A: dtime 2e-3, B: 1e-3, T = 0.1, both times
    (1 + pert)) on both packages with the same ICs (the port's DiskHalo
    draw at n_halo + n_disk), the same tables and the same algorithm
    (sphere 'matmul', cylinder 'xla', f32; exp_tpu's runner fused on one
    device), a 2,048 subsample's true energy by an f64 direct sum on the
    host: each arm's true and represented drift agree between the packages
    to 2e-4, and so does the represented |A - B|, so the port's dt
    dependence is exp_tpu's.  The cases at dtime (1 + 1e-6) and
    (1 + 2e-6) show how far a perturbation far below either arm's step
    moves |A - B| in each package.  Slow (15 to 50 minutes a case); it
    prints the figures."""
    import dataclasses

    import jax.numpy as jnp

    from exp_tpu.basis.empcyl import EmpCylTables as JCyl
    from exp_tpu.basis.slgrid import SphSLTables as JSph
    from exp_tpu.forces.cylinder import CylinderForce as JCylF
    from exp_tpu.forces.spherical import SphereSL as JSphF
    from exp_tpu.nbody.multistep import LevelBuckets
    from exp_tpu.nbody.multistep import MultistepRunner as JRunner
    from exp_tpu.nbody.multistep import flatten_buckets as jflatten
    from exp_tpu.nbody.particles import ParticleSystem as JPS
    from exp_tpu.parallel import particle_mesh

    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch.bench_disk import disk_tables
    from exp_tpu_torch.bench_sphere import sphere_tables
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.forces.spherical import SphereSL
    from exp_tpu_torch.nbody.multistep import MultistepRunner

    ts, tc = sphere_tables(4, 10), disk_tables()
    halo, disk = bc.composite_forces("cpu", ts, tc)
    ic = {k: np.asarray(v, np.float32) for k, v in
          bc.composite_ics(halo, disk, n_halo, n_disk).items()}
    ids = be.subsample_ids(n_halo, n_disk, 2_048)

    def true_energy(snap):
        xs = np.concatenate([d["x"][d["mass"] > 0]
                             for d in snap.values()]).astype(np.float64)
        ms = np.concatenate([d["mass"][d["mass"] > 0]
                             for d in snap.values()]).astype(np.float64)
        e = er = 0.0
        for n, d in snap.items():
            live, rows = be._rows_of(d, ids[n])
            x = d["x"][live][rows].astype(np.float64)
            v = d["v"][live][rows].astype(np.float64)
            m = d["mass"][live][rows].astype(np.float64)
            phi = np.empty(len(x))
            for a in range(0, len(x), 256):
                dd = x[a:a + 256, None, :] - xs[None, :, :]
                r = np.sqrt((dd * dd).sum(-1))
                with np.errstate(divide="ignore"):
                    phi[a:a + 256] = -np.where(r > 0, ms[None, :] / r,
                                               0.0).sum(1)
            ke = float((0.5 * m * (v * v).sum(1)).sum())
            e += ke + float(0.5 * (m * phi).sum())
            er += ke + float(0.5 * (m * d["pot"][live][rows]).sum())
        return e, er

    ph = SphereSL.from_tables(ts, backend="matmul", device="cpu")
    pd_ = CylinderForce.from_tables(tc, backend="xla", device="cpu")
    jh = JSphF.from_tables(JSph(**dataclasses.asdict(ts)),
                           dtype=jnp.float32, backend="matmul")
    jd = JCylF.from_tables(JCyl(**dataclasses.asdict(tc)),
                           dtype=jnp.float32, backend="xla")
    mesh = particle_mesh(1)

    def arm(pkg, dt, nbig):
        if pkg == "port":
            r = MultistepRunner({"halo": ph, "disk": pd_}, bc.COUPLES, dt,
                                bc.M, dynparams=bc.DYN, cap_headroom=4)
            flat = bc.flat_systems(ic, "cpu")
            snap = be.snapshot
        else:
            r = JRunner({"halo": jh, "disk": jd}, bc.COUPLES, dt, bc.M,
                        mesh, dynparams=bc.DYN, cap_headroom=4, fused=True)
            flat = {n: JPS.from_arrays(ic["x" + k], ic["v" + k],
                                       ic["m" + k], dtype=jnp.float32)
                    for n, k in (("halo", "h"), ("disk", "d"))}

            def snap(st):
                return {n: {k: np.asarray(getattr(
                    jflatten(LevelBuckets(list(bs), None)), k))
                    for k in ("x", "v", "mass", "pot", "indx")}
                    for n, bs in st.items()}
        st, regs, _, _ = r.init_state(flat)
        e0, r0 = true_energy(snap(st))
        for _ in range(nbig):
            st, regs, _, _ = r.bigstep(st, regs)
            st, regs = r.relevel(st, regs)
        e1, r1 = true_energy(snap(st))
        return abs(e1 - e0) / abs(e0), abs(r1 - r0) / abs(r0)

    res = {(pkg, name): arm(pkg, dt, nb) for pkg in ("port", "exp_tpu")
           for name, dt, nb in (("A", 2e-3 * (1 + pert), 50),
                                ("B", 1e-3 * (1 + pert), 100))}
    print({f"{p} {a}": f"dE_true {t:.6e} dE_rep {r:.6e}"
           for (p, a), (t, r) in res.items()})
    print({f"{p} |A - B| true": abs(res[(p, "A")][0] - res[(p, "B")][0])
           for p in ("port", "exp_tpu")})
    for name in "AB":
        for k in range(2):
            assert abs(res[("port", name)][k]
                       - res[("exp_tpu", name)][k]) < 2e-4, (name, k, res)
    rep_ab = {p: abs(res[(p, "A")][1] - res[(p, "B")][1])
              for p in ("port", "exp_tpu")}
    assert abs(rep_ab["port"] - rep_ab["exp_tpu"]) < 2e-4, rep_ab
