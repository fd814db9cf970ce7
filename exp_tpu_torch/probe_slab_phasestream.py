"""The slab phase-stream probe (port of scripts/probe_slab_phasestream.py):
does streaming a bf16 phase table from device memory beat K9, which makes
the phases inside the kernel?

  stream1: the producer (ops/slab_kernels.phase_table, plain torch) builds
           the (2 Cr, N) bf16 table [re | im] of e^{-2 pi i k.u}, Cr = C
           rounded up to 8; P1 (csrc/slab_phasestream.cu) reads it with the
           particles' z weights into G.
  stream2: the hi/lo bf16 split of the f32 phases, (4 Cr, N).

Producer + kernel are timed together, as the JAX probe times them (the
table is per-step data), and the kernel alone, the library yardstick (one
torch.matmul of the bf16 table with a prebuilt bf16 Wz^T (N, zrows), the
contraction alone, without building Wz; the port never calls it) and K9 on
the same particles.  Accuracy is checked against an f64 NumPy reference on
the first 32,768 particles.

    python -m exp_tpu_torch.probe_slab_phasestream check [--n N] [--device D]
    python -m exp_tpu_torch.probe_slab_phasestream bench [--n N] [--reps R]

Both take --nmax (4), --nzc (126) and --interp (spline), the JAX probe's
PROBE_NMAX, PROBE_NZC and PROBE_INTERP.  `check` prints each variant's error
on the named device (the CPU takes the plain versions); `bench` times on a
CUDA device (a CPU run is refused: its time is no device metric).  Each
prints one JSON line a variant and writes no file.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from exp_tpu_torch import resolve_device
from exp_tpu_torch.ops import slab_kernels as sk

N = 1_048_576
REPS = 30
NMAX = 4
NZC = 126
INTERP = "spline"
ZMAX = 0.1
SEED = 9
NACC = 32_768
VARIANTS = {"stream1_bf16": False, "stream2_bf16x2": True}


def probe_params(nmax=NMAX, nzc=NZC, interp=INTERP) -> sk.SlabKernelParams:
    return sk.SlabKernelParams(nmaxx=nmax, nmaxy=nmax, nzc=nzc, zmax=ZMAX,
                               interp=interp)


def probe_sample(n=N, seed=SEED):
    """The JAX probe's particles (probe_slab_phasestream.py:170-174), the
    same draws: x, y uniform on [0, 1), z ~ 0.02 N(0, 1), mass 1/n, f32.
    Returns (x (n, 3), mass (n,)) NumPy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, n).astype(np.float32)
    y = rng.uniform(0, 1, n).astype(np.float32)
    z = (0.02 * rng.normal(size=n)).astype(np.float32)
    return np.stack([x, y, z], -1), np.full(n, 1.0 / n, np.float32)


def ref_numpy(x, mass, prm: sk.SlabKernelParams):
    """f64 reference G (C, zrows) of particles x (n, 3), mass (n,) (the JAX
    probe's ref_numpy)."""
    x = np.asarray(x, np.float64)
    m = np.asarray(mass, np.float64)
    z = x[:, 2]
    w = np.where(np.abs(z) <= prm.zmax, m, 0.0)
    B2 = 2 * prm.nmaxy + 1
    ka = np.arange(prm.C) // B2 - prm.nmaxx
    kb = np.arange(prm.C) % B2 - prm.nmaxy
    u = x[:, :2] - np.floor(x[:, :2])
    ph = np.exp(-2j * np.pi * (ka[:, None] * u[None, :, 0]
                               + kb[:, None] * u[None, :, 1]))
    t = np.clip((z + prm.zmax) / prm.dz, 0.0, prm.nzc - 1.0)
    rows = np.arange(prm.zrows)
    if prm.interp == "spline":
        # quadratic B-spline against ghost-extended nodes
        uu = np.abs(rows[:, None] - 1.0 - t[None, :])
        Wz = np.where(uu <= 0.5, 0.75 - uu * uu,
                      np.where(uu <= 1.5, 0.5 * (1.5 - uu) ** 2, 0.0))
    else:
        Wz = np.maximum(0.0, 1.0 - np.abs(rows[:, None] - t[None, :]))
    return (ph * w[None, :]) @ Wz.T


def stream_pass(x, mass, prm, split):
    """Producer + P1: G (C, zrows) complex64 through a phase table."""
    return sk.stream_coef(sk.phase_table(x, prm, split), x, mass, prm)


def errors(x, mass, prm, nacc=NACC, variants=tuple(VARIANTS)):
    """max|G - G_ref| / max|G_ref| on the first nacc particles of K9
    ('v3_lattice', the JAX probe's name) and of each of `variants`."""
    xa, ma = x[:nacc].contiguous(), mass[:nacc].contiguous()
    ref = ref_numpy(xa.cpu().numpy(), ma.cpu().numpy(), prm)
    scale = np.abs(ref).max()
    out = {"v3_lattice": sk.slab_coef(xa, ma, prm)}
    out.update({k: stream_pass(xa, ma, prm, VARIANTS[k]) for k in variants})
    return {k: float(np.abs(g.cpu().numpy() - ref).max() / scale)
            for k, g in out.items()}


def check(n=NACC, nmax=NMAX, nzc=NZC, interp=INTERP, device=None):
    """The variants' errors against the f64 reference on `device`."""
    device = resolve_device(device)
    prm = probe_params(nmax, nzc, interp)
    xs, ms = probe_sample(n)
    x = torch.tensor(xs, device=device)
    m = torch.tensor(ms, device=device)
    return [{"variant": k, "n": n, "max_err": e, "device": str(device)}
            for k, e in errors(x, m, prm, n).items()]


def dense_wz_t(x, mass, prm):
    """The yardstick's operand: the mass-weighted z weights as a dense bf16
    (N, zrows) matrix Wz^T."""
    z = x[:, 2]
    w = torch.where(torch.abs(z) <= prm.zmax, mass, torch.zeros_like(mass))
    j0, ws = sk.z_nodes(sk.z_grid(z, prm), prm)
    W = torch.zeros((x.shape[0], prm.zrows), dtype=torch.float32,
                    device=x.device)
    for k, wk in enumerate(ws):
        W.scatter_add_(1, (j0 + k)[:, None], (w * wk)[:, None])
    return W.to(torch.bfloat16)


def bench(n=N, reps=REPS, nmax=NMAX, nzc=NZC, interp=INTERP, device=None,
          variants=tuple(VARIANTS)):
    """Times by CUDA events (mean ms over `reps` after two warm-up calls):
    each of `variants`' producer + kernel ('ms'), kernel alone
    ('kernel_ms'), producer alone and yardstick ('library_ms'), and K9,
    with the errors of `errors`."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the probe times the card: give it a CUDA device")
    prm = probe_params(nmax, nzc, interp)
    xs, ms = probe_sample(n)
    x = torch.tensor(xs, device=device)
    m = torch.tensor(ms, device=device)
    err = errors(x, m, prm, variants=variants)
    name = torch.cuda.get_device_name(device)
    base = {"n": n, "nmax": nmax, "nzc": nzc, "interp": interp,
            "device": name}
    rows = [{"variant": "v3_lattice", **base,
             "ms": cuda_ms(lambda: sk.slab_coef(x, m, prm), reps),
             "max_err": err["v3_lattice"]}]
    wzt = dense_wz_t(x, m, prm)
    for k in variants:
        split = VARIANTS[k]
        ph = sk.phase_table(x, prm, split)
        rows.append({
            "variant": k, **base,
            "ms": cuda_ms(lambda: stream_pass(x, m, prm, split), reps),
            "kernel_ms": cuda_ms(lambda: sk.stream_coef(ph, x, m, prm), reps),
            "producer_ms": cuda_ms(lambda: sk.phase_table(x, prm, split),
                                   reps),
            "library_ms": cuda_ms(lambda: torch.matmul(ph, wzt), reps),
            "max_err": err[k]})
        del ph
    return rows


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over `reps` calls, by CUDA events, after
    two warm-up calls."""
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


def _main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("check", "bench"))
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--nmax", type=int, default=NMAX)
    ap.add_argument("--nzc", type=int, default=NZC)
    ap.add_argument("--interp", default=INTERP, choices=sk.INTERPS)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    kw = dict(nmax=a.nmax, nzc=a.nzc, interp=a.interp, device=a.device)
    rows = (check(a.n or NACC, **kw) if a.mode == "check"
            else bench(a.n or N, a.reps, **kw))
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    _main()
