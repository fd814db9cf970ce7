"""The remaining ICs on the card: the configurations of chip_smoke.py's
phases IC1-IC3 and the CPU runs their energy bounds come from.

  IC1 (gensph --qp): sample_qp_model of the sphere cell's Hernquist model
      (a 1, M 1 over [1e-3, 20]) at tests/test_qpdistf.py's grid (egrid
      14, kgrid 6, mgrid 56, nint 28; at QPDistF's defaults the fit's
      residual is 0.69 and a sample's 2T/VC 1.096, outside that test's
      0.06), 2^20 particles, its DF evaluated on the device; then KDK
      steps of dt 1e-3 under the sphere cell's basis (sphereSL lmax 4,
      nmax 10, numr 2000, pallas);
  IC2 (zangics): sample_zang_disk at 262,144 particles, defaults otherwise,
      under the flatdisk basis of model 'zang' at gendisk2d's widths and
      defaults (mmax 4, nmax 8, acyl 1, mass 1; 256 x 128 tables), pallas;
      20 KDK steps of dt ZANG_DT;
  IC3 (gendisk2d --nhalo): diskhalo2d_ics of a Hernquist halo of 786,432
      particles and an exponential razor-thin disk of 262,144 (the
      flagship composite's counts; tests/test_diskhalo2d.py's disk, acyl
      0.01, mass 0.05, Q 0, sig0 0.1) at gendisk2d's widths (sphereSL lmax
      4, nmax 10, numr 1000; flatdisk mmax 4, nmax 8), both pallas; then
      big steps at multistep 2 (the composite bench's dtime and dynamic
      fractions).

    python -m exp_tpu_torch.bench_ics kdk --case IC1|IC2 [--device D]
        [--n N] [--threads T]

`kdk` builds the case's force and sample on the device (the CPU takes the
kernels' plain versions) and runs its steps, printing one JSON line: the
sampling time, |dEtot/Etot| over the steps and 2T/VC at both ends.
chip_smoke.py's IC2 energy bound is three times this run's drift on the
CPU, the rule of its R2, CM2 and MF phases.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

#: IC1: the DF's grid (tests/test_qpdistf.py:18), particles, KDK steps
#: and dt (the sphere path's)
QP_GRID = {"egrid": 14, "kgrid": 6, "mgrid": 56, "nint": 28}
QP_N = 1 << 20
QP_STEPS = 50
QP_DT = 1e-3
#: IC2: particles, KDK steps and dt; the flatdisk basis's model and widths
ZANG_N = 262_144
ZANG_STEPS = 20
ZANG_DT = 1e-3
ZANG_MMAX, ZANG_NMAX = 4, 8
#: IC3: the flagship composite's counts, tests/test_diskhalo2d.py's disk,
#: gendisk2d's widths, the multistep depth and big steps
D2_N_HALO, D2_N_DISK = 786_432, 262_144
D2_MDISK, D2_ACYL = 0.05, 0.01
D2_LMAX, D2_NMAXH, D2_MMAX, D2_NMAXD = 4, 10, 4, 8
D2_M = 2
D2_NBIG = 4
D2_SEED = 5


def qp_halo(n=QP_N, device=None, seed=0):
    """IC1's sample: (x, v, m) and the DF's fit and sampling seconds."""
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.ic.qpdistf import QPDistF, sample_qp_model

    model = hernquist_model(rmin=1e-3, rmax=20.0)
    t0 = time.perf_counter()
    df = QPDistF(model, device=device, **QP_GRID)
    t1 = time.perf_counter()
    x, v, m = sample_qp_model(model, n, seed=seed, df=df)
    return (x, v, m), {"fit_sec": t1 - t0,
                       "sample_sec": time.perf_counter() - t1,
                       "resid": df.resid}


def zang_force(device=None, backend="pallas"):
    """IC2's flatdisk force (gendisk2d's model 'zang' at its widths)."""
    from exp_tpu_torch.basis.flatdisk import build_flatdisk_tables
    from exp_tpu_torch.forces.cylinder import CylinderForce

    t = build_flatdisk_tables(mmax=ZANG_MMAX, nmax=ZANG_NMAX, model="zang",
                              acyl=1.0, Mtot=1.0)
    return CylinderForce.from_tables(t, backend=backend, device=device)


def zang_disk(n=ZANG_N, seed=0):
    """IC2's sample (sample_zang_disk at its defaults)."""
    from exp_tpu_torch.ic.zang import sample_zang_disk

    return sample_zang_disk(n, seed=seed)


def disk2d_forces(device=None, backend="pallas"):
    """IC3's halo and disk forces at gendisk2d's widths (its table
    builds)."""
    from exp_tpu_torch.basis.flatdisk import build_flatdisk_tables
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
    from exp_tpu_torch.cli._common import load_model
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.forces.spherical import SphereSL

    ts = build_sph_sl_tables(load_model("hernquist"), lmax=D2_LMAX,
                             nmax=D2_NMAXH, numr=1000, cmap=1, rmap=1.0)
    td = build_flatdisk_tables(mmax=D2_MMAX, nmax=D2_NMAXD, model="expon",
                               acyl=D2_ACYL, Mtot=D2_MDISK)
    return (SphereSL.from_tables(ts, backend=backend, device=device),
            CylinderForce.from_tables(td, backend=backend, device=device))


def disk2d_ics(halo, disk, n_halo=D2_N_HALO, n_disk=D2_N_DISK,
               seed=D2_SEED):
    """IC3's ICs through `halo` and `disk` (gendisk2d --nhalo's pipeline):
    the DiskHaloICs and their -2T/VC in the measured fields."""
    from exp_tpu_torch.cli._common import load_model
    from exp_tpu_torch.ic.diskhalo import _f32, virial_ratio
    from exp_tpu_torch.ic.diskhalo2d import diskhalo2d_ics

    ics = diskhalo2d_ics(load_model("hernquist"), n_halo=n_halo,
                         n_disk=n_disk, Mdisk=D2_MDISK, acyl=D2_ACYL,
                         halo_force=halo, disk_force=disk, model="expon",
                         Q=0.0, sig0=0.1, seed=seed)
    dev = next(halo.buffers()).device
    mh = np.maximum(ics.m_halo, 0.0)
    ch = halo.coefficients(_f32(ics.x_halo, dev), _f32(mh, dev))
    cd = disk.coefficients(_f32(ics.x_disk, dev), _f32(ics.m_disk, dev))
    vr = virial_ratio([(ics.x_halo, ics.v_halo, mh),
                       (ics.x_disk, ics.v_disk, ics.m_disk)],
                      [(halo, ch), (disk, cd)])
    return ics, vr


def disk2d_runner(halo, disk):
    """IC3's runner: multistep D2_M, the composite bench's dtime, dynamic
    fractions and capacity headroom."""
    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch.nbody.multistep import MultistepRunner

    return MultistepRunner({"halo": halo, "disk": disk}, bc.COUPLES,
                           bc.DTIME, D2_M, dynparams=bc.DYN,
                           cap_headroom=bc.CAP_HEADROOM)


def kdk(force, x, v, m, steps, dt, device):
    """init + `steps` KDK steps: the state at the end and the energies
    (bench_sphere.kdk_run's quantities, the state kept)."""
    import torch

    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import (energies, init_force_state,
                                          make_kdk_step)

    ps = ParticleSystem.from_arrays(x, v, m, device=device)
    ps, _, diag = init_force_state(force, ps)
    e0 = energies(diag)
    step = make_kdk_step(force, dt)
    for _ in range(steps):
        ps, coef, diag = step(ps)
    e1 = energies(diag)
    finite = all(bool(torch.isfinite(a).all())
                 for a in (ps.x, ps.v, ps.acc, ps.pot, coef))
    return ps, {"steps": steps, "dt": dt, "n": int(ps.n),
                "dE_rel": abs(e1["Etot"] - e0["Etot"]) / abs(e0["Etot"]),
                "virial0": e0["2T/VC"], "virial1": e1["2T/VC"],
                "finite": finite}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("kdk",))
    ap.add_argument("--case", choices=("IC1", "IC2"), required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--threads", type=int, default=None)
    a = ap.parse_args(argv)
    import torch

    from exp_tpu_torch import resolve_device

    if a.threads:
        torch.set_num_threads(a.threads)
    dev = resolve_device(a.device)
    t0 = time.perf_counter()
    if a.case == "IC1":
        from exp_tpu_torch.bench_sphere import sphere_force, sphere_tables

        (x, v, m), info = qp_halo(a.n or QP_N, dev)
        force = sphere_force(sphere_tables(4, 10), dev)
        steps, dt = QP_STEPS, QP_DT
    else:
        force = zang_force(dev)
        x, v, m = zang_disk(a.n or ZANG_N)
        info = {}
        steps, dt = ZANG_STEPS, ZANG_DT
    t1 = time.perf_counter()
    _, rep = kdk(force, x, v, m, steps, dt, dev)
    print(json.dumps({"case": a.case, "device": str(dev), **info, **rep,
                      "setup_sec": t1 - t0,
                      "run_sec": time.perf_counter() - t1}))


if __name__ == "__main__":
    main()
