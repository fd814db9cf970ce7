"""The YAML driver's extras on the flagship composite's run config (the
composite bench's settings, bench_composite.py) and on the sphere bench's
run config: the configurations of chip_smoke.py's phases R1-R3 and E1-E3,
and the reference runs of E1 and E3 through the kernels' plain versions.

  E1: the flagship with the disk's component parameters EJ: 2, nEJkeep 256,
      EJwindow 16, nEJaccel 8 (the disk expanded about its tracked center,
      with the frame correction) and the halo's npca 5, nsamples 8,
      tk_type Hall;
  E2: the sphere run config (2^20 bodies, dt 1e-3) with the halo's force
      NO_L1: true and External userbar {amplitude 0.1, length 0.5, omega
      1.0, Ton 0.0, DeltaT 0.5};
  E3: the flagship with the halo's force self_consistent: false (a disk in
      a rigid halo).

    python -m exp_tpu_torch.bench_extras kdk --case E1|E3 [--device D]
        [--nbig B] [--threads T] [--n-halo N] [--n-disk N]

`kdk` builds the composite bench's forces and DiskHalo ICs on the device
(the CPU takes the kernels' plain versions), writes them as PSP body files
in a temporary directory, runs the driver on the case's config for B big
steps from t = 0 and prints one JSON line: OUTLOG's |dEtot/Etot| (the
global columns for E1, the disk's own for E3) and the set-up and run times.
chip_smoke.py's E1 and E3 energy bounds are three times this run's drift
on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
import time

import numpy as np

#: the disk's and the halo's component parameters of E1
E1_DISK = {"EJ": 2, "nEJkeep": 256, "EJwindow": 16, "nEJaccel": 8}
E1_HALO = {"npca": 5, "nsamples": 8, "tk_type": "Hall"}
#: E2's bar (External userbar)
E2_BAR = {"amplitude": 0.1, "length": 0.5, "omega": 1.0, "Ton": 0.0,
          "DeltaT": 0.5}
#: OUTLOG's columns (the wall clock dropped): the global KE and PE, and the
#: disk's (its section follows the halo's; 15 columns a component)
KE, PE = 12, 13
DISK_KE, DISK_PE = 17 + 15 + 10, 17 + 15 + 11


def write_model_exact(model, path):
    """A model file that reads back to the same f64 arrays (17 significant
    digits; SphericalModelTable.to_file keeps 13), so the driver builds the
    benches' tables bit for bit."""
    with open(path, "w") as f:
        f.write(f"! {model.comment}\n{len(model.r)}\n")
        np.savetxt(f, np.column_stack([model.r, model.rho, model.mass,
                                       model.pot]), fmt="%.17e")


def flagship_config(outdir, runtag="flag", nsteps=10):
    """The flagship composite's run config as the dict yaml.safe_load
    gives: the composite bench's settings (bench_composite.py; its runner
    accumulates coefficients in f32, so accum_dtype is float32), the halo's
    model in halo.model, both forces on the pallas backend, interactions
    both ways, OUTLOG every big step and PSP snapshots every 10.  The
    DiskHalo disk's inner orbits ask for steps below the finest level (the
    runner clamps them to it), more than the reference's default maxMindt
    of 5%, at which the driver would stop the run after its first big
    step: the bench's runner has no such stop, so the config raises
    maxMindt to 0.5."""
    from exp_tpu_torch import bench_composite as bc

    return {
        "Global": {"dtime": bc.DTIME, "nsteps": nsteps, "runtag": runtag,
                   "outdir": outdir, "multistep": bc.M,
                   "dynfracV": bc.DYN["dynfracV"],
                   "dynfracA": bc.DYN["dynfracA"],
                   "cap_headroom": bc.CAP_HEADROOM, "fused_bigstep": True,
                   "accum_dtype": "float32", "maxMindt": 0.5},
        "Components": [
            {"name": "halo", "bodyfile": "halo.psp",
             "force": {"id": "sphereSL", "parameters": {
                 "Lmax": 4, "nmax": 10, "numr": 2000, "rmapping": 1.0,
                 "modelname": "halo.model", "backend": "pallas"}}},
            {"name": "disk", "bodyfile": "disk.psp",
             "force": {"id": "cylinder", "parameters": {
                 "mmax": 6, "nmax": 18, "lmaxfid": 32, "nmaxfid": 24,
                 "ncylnx": 256, "ncylny": 128, "acyl": bc.ACYL,
                 "hcyl": bc.HCYL, "backend": "pallas"}}}],
        "Interaction": [{"halo": "disk"}, {"disk": "halo"}],
        "Output": [{"id": "outlog", "parameters": {"nint": 1}},
                   {"id": "outpsn", "parameters": {"nint": 10}}]}


def case_config(case, outdir, runtag, nsteps=10):
    """E1's or E3's run config: the flagship's with the case's extras."""
    cfg = copy.deepcopy(flagship_config(outdir, runtag, nsteps))
    comps = {c["name"]: c for c in cfg["Components"]}
    if case == "E1":
        comps["disk"]["parameters"] = dict(E1_DISK)
        comps["halo"]["parameters"] = dict(E1_HALO)
    elif case == "E3":
        comps["halo"]["force"]["parameters"]["self_consistent"] = False
    else:
        raise ValueError(f"case {case!r}: E1 or E3")
    return cfg


def sphere_config(outdir, runtag, dt, nsteps, extras=False):
    """The sphere bench's run config (R3) on sphere.bods; with `extras`,
    E2's: the halo's force NO_L1: true and the External userbar."""
    cfg = {"Global": {"dtime": dt, "nsteps": nsteps, "runtag": runtag,
                      "outdir": outdir},
           "Components": [{"name": "halo", "bodyfile": "sphere.bods",
                           "force": {"id": "sphereSL", "parameters": {
                               "Lmax": 4, "nmax": 10, "numr": 2000,
                               "rmapping": 1.0, "modelname": "halo.model",
                               "backend": "pallas"}}}],
           "Output": [{"id": "outlog", "parameters": {"nint": 1}}]}
    if extras:
        cfg["Components"][0]["force"]["parameters"]["NO_L1"] = True
        cfg["External"] = [{"id": "userbar", "parameters": dict(E2_BAR)}]
    return cfg


def write_bodies(wd, ic):
    """halo.model and the ICs' halo.psp, disk.psp in directory wd."""
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.io.psp import PSPComponent, PSPDump, write_psp

    write_model_exact(hernquist_model(rmin=1e-3, rmax=20.0),
                      os.path.join(wd, "halo.model"))
    for name, (x, v, m) in (("halo", (ic["xh"], ic["vh"], ic["mh"])),
                            ("disk", (ic["xd"], ic["vd"], ic["md"]))):
        d = PSPDump(time=0.0)
        d.components.append(PSPComponent(name=name, info=f"name: {name}\n",
                                         mass=m, x=x, v=v,
                                         pot=np.zeros(len(m))))
        write_psp(os.path.join(wd, f"{name}.psp"), d)


def outlog_rows(path):
    """OUTLOG's rows as floats, the wall-clock column (17) dropped."""
    rows = [r for r in open(path).read().splitlines()
            if not r.startswith("#") and "Time" not in r]
    return np.delete(np.array([[float(v) for v in r.split("|")]
                               for r in rows]), 17, 1)


def drift(log, case):
    """|dEtot/Etot| from OUTLOG's first row to its last: the global
    columns for E1, the disk's for E3 (the halo is rigid there)."""
    ke, pe = (KE, PE) if case == "E1" else (DISK_KE, DISK_PE)
    e = log[:, ke] + log[:, pe]
    return float(abs(e[-1] - e[0]) / abs(e[0]))


def _main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("kdk",))
    ap.add_argument("--case", choices=("E1", "E3"), required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--nbig", type=int, default=10)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--n-halo", type=int, default=None)
    ap.add_argument("--n-disk", type=int, default=None)
    a = ap.parse_args()
    import torch

    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch import resolve_device
    from exp_tpu_torch.config import RunConfig
    from exp_tpu_torch.nbody.simulation import Simulation

    if a.threads:
        torch.set_num_threads(a.threads)
    dev = resolve_device(a.device)
    t0 = time.perf_counter()
    halo, disk = bc.composite_forces(dev)
    ic = bc.composite_ics(halo, disk, n_halo=a.n_halo or bc.N_HALO,
                          n_disk=a.n_disk or bc.N_DISK)
    t_ics = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="bench_extras_") as wd:
        write_bodies(wd, ic)
        cfg = RunConfig.from_dict(case_config(a.case, "out", "ex", a.nbig),
                                  where=a.case)
        t0 = time.perf_counter()
        sim = Simulation(cfg, workdir=wd, device=dev)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        sim.run()
        t_run = time.perf_counter() - t0
        log = outlog_rows(os.path.join(wd, "out", "OUTLOG.ex"))
    print(json.dumps({
        "case": a.case, "device": str(dev), "nbig": a.nbig,
        "threads": torch.get_num_threads(), "rows": len(log),
        "dE_rel": drift(log, a.case), "finite": bool(np.isfinite(log).all()),
        "ics_sec": t_ics, "build_sec": t_build, "run_sec": t_run,
        "timers": sim.timers}))


if __name__ == "__main__":
    _main()
