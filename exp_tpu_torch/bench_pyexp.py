"""The pyEXP drop-in on the card: the configuration of chip_smoke.py's phase
PX1 and the CPU run its orbit-energy bound comes from.

  PX1's basis: pyEXP.basis.Basis.factory of the sphere cell's stanza
      (sphereSL over the Hernquist model file, a 1, M 1 on [1e-3, 20];
      Lmax 4, nmax 10, numr 2000, cmap 1, rmapping 1.0, backend pallas),
      the stanza of chip_smoke.py's AN1;
  its orbits: the first ORBITS bodies of phase 5's equilibrium sample
      (bench_sphere.equilibrium_sample(2^20, seed 0)), integrated by
      pyEXP.basis.IntegrateOrbits for STEPS leapfrog steps of DT in the
      frozen field of that sample's coefficients (SingleTimeAccel at t 0),
      exp_tpu's host leapfrog with one field evaluation a step (K2 under
      pallas on the card, its plain version on the CPU).

    python -m exp_tpu_torch.bench_pyexp orbits [--device D] [--threads T]

`orbits` builds the basis and the sample's coefficients on the device and
integrates the orbits, printing one JSON line: the mean and largest
|dE/E| of the orbits (E = v^2/2 + the expansion's potential, at both ends
of the float32 orbits IntegrateOrbits returns) and the time a step.
chip_smoke.py's PX1 bound is three times this run's mean on the CPU, the
rule of its R2, CM2, MF and IC phases.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

N = 1_048_576
ORBITS = 1024
STEPS = 500
DT = 1e-3
STANZA = ("id: sphereSL\nparameters: {modelname: halo.model, Lmax: 4, "
          "nmax: 10, numr: 2000, cmap: 1, rmapping: 1.0, backend: %s}\n")


def write_model(workdir):
    """The stanza's model file, `halo.model`, in `workdir`."""
    from exp_tpu_torch.basis.model import hernquist_model

    hernquist_model(rmin=1e-3, rmax=20.0).to_file(
        os.path.join(workdir, "halo.model"))


def orbit_energy(basis, coefs, x, v, steps=None, dt=DT):
    """IntegrateOrbits of the bodies (x, v) for `steps` (None: STEPS) steps
    of `dt` in the frozen field of `coefs` at t 0 (pyEXP Basis and Coefs);
    returns the float32 orbits and a dict of the orbits' |dE/E| and the host
    time a step."""
    import torch

    from exp_tpu_torch.pyexp.basis import IntegrateOrbits, SingleTimeAccel

    steps = STEPS if steps is None else steps
    c0 = coefs.getCoefStruct(0.0).getCoefs()
    dev = basis.native.device

    def energy(ps):
        pot = basis.native.get_fields(c0, ps[:, :3])[1]
        return 0.5 * np.sum(ps[:, 3:6] ** 2, axis=1) + pot

    ps = np.concatenate([x, v], axis=1).astype(np.float32).astype(float)
    e0 = energy(ps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    T, O = IntegrateOrbits(0.0, steps * dt, dt, ps, [(basis, coefs)],
                           SingleTimeAccel(0.0))
    step_s = (time.perf_counter() - t0) / steps
    de = np.abs(energy(O[-1].astype(float)) / e0 - 1.0)
    return O, {"orbits": len(x), "steps": steps, "dt": dt,
               "dE_mean": float(de.mean()), "dE_max": float(de.max()),
               "finite": bool(np.isfinite(O).all()),
               "step_s": step_s}


def orbits_case(device):
    """PX1's orbit case on `device`: the basis, the sample's coefficients
    through createFromArray and the orbits; returns orbit_energy's dict."""
    import exp_tpu_torch.pyexp as pyEXP
    from exp_tpu_torch.bench_sphere import equilibrium_sample

    with tempfile.TemporaryDirectory(prefix="bench_pyexp_") as wd:
        write_model(wd)
        basis = pyEXP.basis.Basis.factory(STANZA % "pallas", workdir=wd,
                                          device=device)
    t0 = time.perf_counter()
    x, v, m = equilibrium_sample(N, seed=0)
    sample_s = time.perf_counter() - t0
    st = basis.createFromArray(m, x, time=0.0)
    coefs = pyEXP.coefs.Coefs.makecoefs(st, "halo")
    coefs.add(st)
    _, out = orbit_energy(basis, coefs, x[:ORBITS], v[:ORBITS])
    return {"device": str(device), "n": N, "sample_s": sample_s, **out}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_pyexp", description=__doc__)
    ap.add_argument("mode", choices=["orbits"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch CPU threads (0: torch's default)")
    a = ap.parse_args(argv)
    import torch

    from exp_tpu_torch import resolve_device

    if a.threads:
        torch.set_num_threads(a.threads)
    print(json.dumps(orbits_case(resolve_device(a.device))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
