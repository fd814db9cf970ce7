"""The analysis path's host-to-card upload and its kernel rows, measured
apart from the rest of `chip_smoke.py`.

    python -m exp_tpu_torch.probe_analysis      (from the repo's root)

1. Upload: a snapshot of 2^20 particles, positions (N, 3) f64 and masses
   (N,) f64 from pageable host memory, moved to the card two ways in turns,
   `UPLOAD_REPS` times each: "packed" (the arrays side by side in one host
   buffer of their common dtype, one copy, split on the card) and
   "per_array" (`torch.as_tensor(a).to(device)` for each array).  Host
   clock, a synchronize before and after each upload.
2. Rows: `chip_smoke.analysis_path` (phases AN1-AN3) run `AN_RUNS` times
   in one process on the inputs `chip_smoke.main` gives it (phase 5's
   equilibrium sample, D1's EOF tables, CM1's DiskHalo ICs), so that the
   kernels-line rows of K1, K2, K4 and K5 at the analysis's shapes can be
   compared from run to run.  Each row carries `ms` (launches queued
   behind a spin kernel) and `event_ms` (CUDA events around launches in a
   row, which time the host's enqueue where a launch is shorter than it).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

UPLOAD_N = 1 << 20
UPLOAD_REPS = 7
AN_RUNS = 2


def _packed(device, *arrays):
    """The arrays side by side in one host buffer, one transfer, split on
    the device."""
    import numpy as np
    import torch

    cols = [a.reshape(len(a), -1) for a in arrays]
    buf = torch.as_tensor(np.concatenate(cols, axis=1)).to(device)
    out, k = [], 0
    for a, c in zip(arrays, cols):
        out.append(buf[:, k:k + c.shape[1]].reshape(a.shape))
        k += c.shape[1]
    return out


def _per_array(device, *arrays):
    import torch

    return [torch.as_tensor(a).to(device) for a in arrays]


def upload_ab(device, n=UPLOAD_N, reps=UPLOAD_REPS):
    """Seconds of each upload, the two ways in turns; their results are
    checked equal to the host arrays."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    x, m = rng.standard_normal((n, 3)), rng.random(n)
    out = {"packed": [], "per_array": []}
    for i in range(2 * reps):
        name = ("packed", "per_array")[i % 2]
        fn = _packed if name == "packed" else _per_array
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xd, md = fn(device, x, m)
        torch.cuda.synchronize()
        out[name].append(time.perf_counter() - t0)
        if not (np.array_equal(xd.cpu().numpy(), x)
                and np.array_equal(md.cpu().numpy(), m)):
            raise AssertionError(f"{name} upload changed the arrays")
    out.update({f"{k}_median_s": float(np.median(v))
                for k, v in list(out.items())})
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("probe_analysis: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch.bench_disk import disk_tables
    from exp_tpu_torch.bench_sphere import equilibrium_sample, sphere_tables
    from exp_tpu_torch.ops import _build

    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    _build.build_all()
    up = upload_ab(dev)
    print("upload: " + json.dumps(up), flush=True)
    xe, ve, me = equilibrium_sample(cs.N, seed=0)
    st, dt = sphere_tables(lmax=4, nmax=10), disk_tables()
    comp = bc.prepare(bc.N_HALO, bc.N_DISK, dev,
                      bc.composite_forces(dev, st, dt))
    runs = []
    for _ in range(AN_RUNS):
        rows = cs.analysis_path(dev, comp, dt, xe, ve, me)
        runs.append({r["name"]: {k: r[k] for k in
                                 ("launches", "ms", "event_ms", "plain_ms",
                                  "bound_ms")} for r in rows})
    print(json.dumps({"upload": up, "an_rows": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
