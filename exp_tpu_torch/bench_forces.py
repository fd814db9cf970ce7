"""The remaining forces on the card: the run configs of chip_smoke.py's
phases MF1-MF3 and the CPU runs their energy bounds come from.

  hernq, CBsphere (MF1): the analytic bases over the sphere path's 2^20
      Hernquist sample (hernq) and a 2^20 Plummer sample (a 1, M 1, over
      [1e-3, 20]; CBsphere), lmax 4, nmax 10, numr 2000, rmax 50, backend
      pallas, through the single-rate driver for 50 steps of dt 1e-3;
  twocenter (MF2): tests/test_twocenter.py:39's lopsided system at 2^20 in
      its 4,000 : 6,000 ratio (a Hernquist cusp a 0.2, M 0.5 offset by 1.5
      inside an envelope a 2.0, M 1.0), inner and outer sphereSL at lmax 4,
      nmax 10, numr 2000 on a Hernquist model over [1e-4, 50], backend
      pallas, cfac 1, alpha 2, EJ: 2; single-rate 20 steps of dt 1e-3, and
      multistep 2 for 4 big steps;
  bh (MF3b): the sphere path's 2^20 halo under sphereSL (pallas) and a
      one-body `bh` (mass 0.01, on a circular orbit at r 0.05) under
      direct (plummer, soft 0.01), coupled both ways, multistep 4, dtime
      0.01, 4 big steps, maxMindt 0.5 (as the flagship's run config).

    python -m exp_tpu_torch.bench_forces ref --case hernq|CBsphere|bh
        [--device D] [--threads T]

`ref` runs the case through the driver on the device (the CPU takes the
kernels' plain versions) and prints one JSON line: OUTLOG's |dEtot/Etot|
from row 0 to the last (the halo's own columns for bh) and 2T/VC at both
ends.  chip_smoke.py's energy bounds for MF1 and MF3b are three times this
run's drift on the CPU, the rule of its R2 and CM2.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

N = 1 << 20
STEPS = 50
DT = 1e-3
#: MF2's single-rate steps and multistep big steps
TC_STEPS = 20
TC_NBIG = 4
#: MF3b's multistep depth, dtime and big steps
BH_M = 4
BH_DTIME = 0.01
BH_NBIG = 4
#: the lopsided system's cusp share (tests/test_twocenter.py: 4,000 of
#: 10,000) and the cusp's offset
TC_CUSP_SHARE = 0.4
TC_OFFSET = (1.5, 0.0, 0.0)
#: OUTLOG's columns once the wall clock (17) is dropped: the global KE, PE
#: and 2T/VC, and the first component's own KE, PE and 2T/VC (15 columns a
#: component after the 17 global ones)
KE, PE, VIRIAL = 12, 13, 16
C0_KE, C0_PE, C0_VIRIAL = 17 + 10, 17 + 11, 17 + 14


def _sphere_params(model):
    return {"Lmax": 4, "nmax": 10, "numr": 2000, "rmapping": 1.0,
            "modelname": model, "backend": "pallas"}


def analytic_config(kind, outdir, runtag, nsteps=STEPS):
    """MF1's run config: one component `halo` on halo.psp under `kind`
    (hernq or CBsphere), OUTLOG every step."""
    return {"Global": {"dtime": DT, "nsteps": nsteps, "runtag": runtag,
                       "outdir": outdir},
            "Components": [{"name": "halo", "bodyfile": "halo.psp",
                            "force": {"id": kind, "parameters": {
                                "Lmax": 4, "nmax": 10, "numr": 2000,
                                "rmax": 50.0, "backend": "pallas"}}}],
            "Output": [{"id": "outlog", "parameters": {"nint": 1}}]}


def twocenter_config(outdir, runtag, multistep, nsteps):
    """MF2's run config: one component `sys` on sys.psp with EJ: 2 under
    twocenter over two pallas sphereSL expansions of tc.model."""
    return {"Global": {"dtime": DT, "nsteps": nsteps, "runtag": runtag,
                       "outdir": outdir, "multistep": multistep},
            "Components": [{"name": "sys", "bodyfile": "sys.psp",
                            "parameters": {"EJ": 2},
                            "force": {"id": "twocenter", "parameters": {
                                "basis": "sphereSL", "cfac": 1.0,
                                "alpha": 2.0,
                                "parameters": _sphere_params("tc.model")}}}],
            "Output": [{"id": "outlog", "parameters": {"nint": 1}}]}


def bh_config(outdir, runtag, nbig=BH_NBIG):
    """MF3b's run config: `halo` (sphereSL, pallas) and `bh` (direct),
    each feeling the other, at multistep BH_M."""
    return {"Global": {"dtime": BH_DTIME, "nsteps": nbig, "runtag": runtag,
                       "outdir": outdir, "multistep": BH_M,
                       "maxMindt": 0.5},
            "Components": [
                {"name": "halo", "bodyfile": "halo.psp",
                 "force": {"id": "sphereSL",
                           "parameters": _sphere_params("halo.model")}},
                {"name": "bh", "bodyfile": "bh.psp",
                 "force": {"id": "direct", "parameters": {
                     "type": "Plummer", "soft": 0.01}}}],
            "Interaction": [{"halo": "bh"}, {"bh": "halo"}],
            "Output": [{"id": "outlog", "parameters": {"nint": 1}}]}


def plummer_sample(n, seed=0):
    """An equilibrium sample of the Plummer model (a 1, M 1) over
    [1e-3, 20]."""
    from exp_tpu_torch.basis.model import plummer_model
    from exp_tpu_torch.ic.eddington import sample_spherical_model

    return sample_spherical_model(plummer_model(rmin=1e-3, rmax=20.0), n,
                                  seed=seed)


def lopsided_sample(n):
    """tests/test_twocenter.py:39's cusp + envelope at n bodies in its
    4,000 : 6,000 ratio (seeds 7 and 8): (x, v, mass, offset, com)."""
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.ic.eddington import sample_spherical_model

    nc = int(round(n * TC_CUSP_SHARE))
    mc = hernquist_model(a=0.2, M=0.5, rmin=1e-4, rmax=4.0, numr=600)
    xc, vc, mass_c = sample_spherical_model(mc, nc, seed=7)
    me = hernquist_model(a=2.0, M=1.0, rmin=1e-3, rmax=40.0, numr=800)
    xe, ve, mass_e = sample_spherical_model(me, n - nc, seed=8)
    off = np.array(TC_OFFSET)
    x = np.concatenate([xc + off, xe])
    mass = np.concatenate([mass_c, mass_e])
    com = (mass[:, None] * x).sum(0) / mass.sum()
    return x, np.concatenate([vc, ve]), mass, off, com


def bh_body():
    """The `bh` body: mass 0.01 at (0.05, 0, 0) with the halo model's
    circular speed there, (M(<r) / r)^(1/2), along y."""
    from exp_tpu_torch.basis.model import hernquist_model

    r = 0.05
    vc = float(np.sqrt(hernquist_model(rmin=1e-3, rmax=20.0).get_mass(r)
                       / r))
    return (np.array([[r, 0.0, 0.0]]), np.array([[0.0, vc, 0.0]]),
            np.array([0.01]))


def write_psp_bodies(path, name, x, v, mass):
    from exp_tpu_torch.io.psp import PSPComponent, PSPDump, write_psp

    d = PSPDump(time=0.0)
    d.components.append(PSPComponent(name=name, info=f"name: {name}\n",
                                     mass=mass, x=x, v=v,
                                     pot=np.zeros(len(mass))))
    write_psp(path, d)


def write_case_files(case, wd, sample=None):
    """The model and body files of a case in directory wd; `sample` (x, v,
    mass) replaces the case's own draw of its main component."""
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.bench_extras import write_model_exact
    from exp_tpu_torch.bench_sphere import equilibrium_sample

    if case == "twocenter":
        write_model_exact(hernquist_model(rmin=1e-4, rmax=50.0, numr=1000),
                          os.path.join(wd, "tc.model"))
        x, v, m = sample if sample is not None else lopsided_sample(N)[:3]
        write_psp_bodies(os.path.join(wd, "sys.psp"), "sys", x, v, m)
        return
    if sample is None:
        sample = (plummer_sample(N) if case == "CBsphere"
                  else equilibrium_sample(N, seed=0))
    write_psp_bodies(os.path.join(wd, "halo.psp"), "halo", *sample)
    if case == "bh":
        write_model_exact(hernquist_model(rmin=1e-3, rmax=20.0),
                          os.path.join(wd, "halo.model"))
        write_psp_bodies(os.path.join(wd, "bh.psp"), "bh", *bh_body())


def case_config(case, outdir, runtag):
    if case in ("hernq", "CBsphere"):
        return analytic_config(case, outdir, runtag)
    if case == "bh":
        return bh_config(outdir, runtag)
    raise ValueError(f"case {case!r}: hernq, CBsphere or bh")


def outlog_report(path, case):
    """|dEtot/Etot| from OUTLOG's first row to its last (the halo's own
    columns for bh) and 2T/VC at both ends."""
    from exp_tpu_torch.bench_extras import outlog_rows

    log = outlog_rows(path)
    ke, pe, vir = (C0_KE, C0_PE, C0_VIRIAL) if case == "bh" else (
        KE, PE, VIRIAL)
    e = log[:, ke] + log[:, pe]
    return log, {"rows": len(log), "Etot0": float(e[0]),
                 "Etot1": float(e[-1]),
                 "dE_rel": float(abs(e[-1] - e[0]) / abs(e[0])),
                 "virial0": float(log[0, vir]), "virial1": float(log[-1, vir]),
                 "finite": bool(np.isfinite(log).all())}


def _main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("ref",))
    ap.add_argument("--case", choices=("hernq", "CBsphere", "bh"),
                    required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--threads", type=int, default=None)
    a = ap.parse_args()
    import torch

    from exp_tpu_torch import resolve_device
    from exp_tpu_torch.config import RunConfig
    from exp_tpu_torch.nbody.simulation import Simulation

    if a.threads:
        torch.set_num_threads(a.threads)
    dev = resolve_device(a.device)
    with tempfile.TemporaryDirectory(prefix="bench_forces_") as wd:
        t0 = time.perf_counter()
        write_case_files(a.case, wd)
        t_ics = time.perf_counter() - t0
        cfg = RunConfig.from_dict(case_config(a.case, "out", "mf"),
                                  where=a.case)
        t0 = time.perf_counter()
        sim = Simulation(cfg, workdir=wd, device=dev)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        if sim.M == 0:
            sim.prime()
        sim.run()
        t_run = time.perf_counter() - t0
        _, rep = outlog_report(os.path.join(wd, "out", "OUTLOG.mf"), a.case)
    print(json.dumps({"case": a.case, "device": str(dev),
                      "threads": torch.get_num_threads(), **rep,
                      "ics_sec": t_ics, "build_sec": t_build,
                      "run_sec": t_run}))


if __name__ == "__main__":
    _main()
