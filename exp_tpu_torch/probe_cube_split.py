"""What the time of the cube kernels K7 (coefficients, csrc/cube_coef.cu)
and K8 (force, csrc/cube_accel.cu) is made of, and how the tensor cores
round a long f32 accumulation.

    python -m exp_tpu_torch.probe_cube_split [--first DIR] [--accum-only]

It times builds of the kernels with one part of their work cut out, by
bench_kernels.py (device time a launch by CUDA events around launches
queued behind a spin kernel) on the cube bench's uniform sample at
4,194,304 rows, nmax 6:

  full        both kernels as they are (run first and last);
  no_stage    nothing is staged: K7's tiles and K8's warp stages hold
              whatever shared memory held (the first K7: its tiles alone);
  no_mma      the tensor-core kernels issue no mma (a cheap stand-in
              keeps their operands live);
  no_split    the tensor-core K7 takes its A operands unsplit (hi = x,
              lo = 0): what its splits cost;
  no_xy       the tensor-core K7's A operands are e_y alone (no e_x load,
              no complex product);
  no_epilogue the tensor-core K8 takes e = 1 (no e_x, e_y loads, no
              complex product) in its epilogue;
  no_fma      the first K7 stages its tiles and sums nothing;
  no_dead     the first K7 with its thread groups cut to the 46 threads
              its 91 (a, b) pairs need, not rounded up to 64 (one dead
              pair slot in 92, not 37 in 128);
  no_table    the first K8 reads every table row from the plane's first
              row: all rows equal, so the compiler hoists the kz sums out
              of the row loop and this times K8 without them;
  no_loads    the first K8's table values are constants (the same).

full - no_X bounds what part X costs.  Each variant is a copy of
exp_tpu_torch with its sources patched (probe_accel_split.make_variants),
under exp_tpu_torch/_build/cubesplit/ (git-ignored), timed in its own
process (`bench_kernels.py --root`).  `--first DIR` splits the first
kernels (as at c8c4e40 and before) of the checkout at DIR.

The accumulation probe (csrc/probe_tf32_accum.cu) sums K = 4,096, 16,384
and 65,536 products of 64 trials of a 16 x 8 output, for inputs whose sum
is known: TF32 values in [1, 2) (one pass: the products and their f64 sum
are exact), and f32 values in [1, 2) and in [-1, 1) (the three split
passes, into one accumulator or with the two small passes in a second;
the f64 sum errs by ~1e-16).  Each is run with no promotion and with the
accumulators added into an f32 register sum every 8, 16, 32 and 64
k-steps, and beside f32 FMAs in k order.  It prints each setting's largest
and mean error over the 8,192 outputs, relative to sum |a b|, and the mean
signed error (a rounding toward zero shows as a mean of one sign).
`--accum-only` runs the accumulation probe alone.

Prints one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

from exp_tpu_torch.probe_accel_split import make_variants, time_variants

PORT = Path(__file__).resolve().parent
SIZES = "4194304"
K7, K8 = "K7", "K8"

# ---------------------------------------------------------------------------
# the tensor-core kernels

_K7_NO_STAGE = ("cube_coef.cu",
                "  for (int task = threadIdx.x; task < 2 * kTile; task += blockDim.x) {",
                "  for (int task = threadIdx.x; task < 0; task += blockDim.x) {")
_K7_NO_MMA = ("cube_coef.cu",
              "          tf32::mma3(acc[j][q], xh, xl, bh[q], bl[q]);",
              "          acc[j][q][0] += __uint_as_float(xh[0] ^ xl[1] ^ bh[q][0] ^ bl[q][1]);")
_K7_NO_SPLIT = ("cube_coef.cu",
                "          const tf32::Split q = tf32::split(av[e]);",
                "          const tf32::Split q = {__float_as_uint(av[e]), 0u};")
_K7_NO_XY = ("cube_coef.cu",
             "        const float2 xy0 = cube::cmul(make_float2(ex.x, ex.y), make_float2(ey.x, ey.y));\n"
             "        const float2 xy1 = cube::cmul(make_float2(ex.z, ex.w), make_float2(ey.z, ey.w));",
             "        const float2 xy0 = make_float2(ey.x, ey.y), xy1 = make_float2(ey.z, ey.w);\n"
             "        (void)ex;")
_K8_NO_STAGE = ("cube_accel.cu",
                "    // stage: lane p makes particle p's elements\n    {",
                "    // stage: nothing\n    if (false) {")
_K8_NO_MMA = ("cube_accel.cu",
              "          for (int mt = 0; mt < kMTiles; ++mt) tf32::mma3(d[z][mt], ah[mt][s], al[mt][s], bh, bl);",
              "          for (int mt = 0; mt < kMTiles; ++mt)\n"
              "            d[z][mt][0] += __uint_as_float(ah[mt][s][0] ^ al[mt][s][1] ^ bh[0] ^ bl[1]);")
_K8_NO_EPILOGUE = ("cube_accel.cu",
                   "          const float2 ex = pr[ia], ey = pr[ib];\n"
                   "          const float2 e = cube::cmul(ex, ey);",
                   "          const float2 e = make_float2(1.0f, 0.0f);\n          (void)pr;")

#: variant: (the kernels bench_kernels.py times, the (source, old, new)
#: patches; a source under csrc/ unless it names a directory)
VARIANTS = {
    "full": (K7 + "," + K8, ()),
    "no_stage": (K7 + "," + K8, (_K7_NO_STAGE, _K8_NO_STAGE)),
    "no_mma": (K7 + "," + K8, (_K7_NO_MMA, _K8_NO_MMA)),
    "no_split": (K7, (_K7_NO_SPLIT,)),
    "no_xy": (K7, (_K7_NO_XY,)),
    "no_epilogue": (K8, (_K8_NO_EPILOGUE,)),
}

# ---------------------------------------------------------------------------
# the first kernels (as at c8c4e40), for --first

_F_K7_NO_STAGE = ("cube_coef.cu",
                  "    for (int task = threadIdx.x; task < 3 * ntile; task += blockDim.x) {",
                  "    for (int task = threadIdx.x; task < 0; task += blockDim.x) {")
_F_K7_NO_FMA = ("cube_coef.cu",
                "    for (int p = 0; p < cnt; ++p) {",
                "    for (int p = 0; p < 0; ++p) {")
_F_K7_NO_DEAD = ("cube_coef.cu",
                 "  g.tpg = (t + 31) / 32 * 32;",
                 "  g.tpg = t;")
_F_K8_NO_TABLE = ("cube_accel.cu",
                  "      const float2* plane = T + (long long)a * ky * KZ;",
                  "      const float2* plane = T - (long long)ny * KZ;")
_F_K8_NO_TABLE_NEG = ("cube_accel.cu",
                      "          row_term<KZ>(plane + (ny - kb) * KZ, ez, ezk,",
                      "          row_term<KZ>(plane + ny * KZ, ez, ezk,")
_F_K8_NO_TABLE_POS = ("cube_accel.cu",
                      "        row_term<KZ>(plane + (ny + kb) * KZ, ez, ezk, cube::cmul(px, py), wky, s);",
                      "        row_term<KZ>(plane + ny * KZ, ez, ezk, cube::cmul(px, py), wky, s);")
_F_K8_NO_LOADS = ("cube_accel.cu",
                  "    const float2 b = row[c];",
                  "    const float2 b = make_float2(0.25f * c + 1.0f, 0.5f - 0.125f * c);")
FIRST_VARIANTS = {
    "full": (K7 + "," + K8, ()),
    "no_stage": (K7, (_F_K7_NO_STAGE,)),
    "no_fma": (K7, (_F_K7_NO_FMA,)),
    "no_dead": (K7, (_F_K7_NO_DEAD,)),
    "no_table": (K8, (_F_K8_NO_TABLE, _F_K8_NO_TABLE_NEG,
                      _F_K8_NO_TABLE_POS)),
    "no_loads": (K8, (_F_K8_NO_LOADS,)),
}


# ---------------------------------------------------------------------------
# the accumulation probe

ACCUM_K = (4096, 16384, 65536)
ACCUM_PERIODS = (0, 8, 16, 32, 64)
ACCUM_TRIALS = 64
#: mode: (name, the data it is run on)
ACCUM_MODES = {0: ("tf32_1pass", ("pos_tf32",)),
               1: ("split3_one_acc", ("pos_f32", "signed_f32")),
               2: ("split3_two_acc", ("pos_f32", "signed_f32")),
               3: ("fp32_fma", ("pos_tf32", "pos_f32", "signed_f32"))}


def tf32_round(x):
    """x (f32 tensor) rounded to TF32 as cvt.rna.tf32.f32 rounds it:
    nearest, ties away from zero, 13 low mantissa bits cleared."""
    import torch

    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def accum_data(kind, K, trials, gen, dev):
    """(A (trials, 16, K), B (trials, K, 8)) f32 of one kind of data."""
    import torch

    def draw(*shape):
        u = torch.rand(*shape, generator=gen, dtype=torch.float32)
        x = 2.0 * u - 1.0 if kind == "signed_f32" else 1.0 + u
        return (tf32_round(x) if kind == "pos_tf32" else x).to(dev)

    return draw(trials, 16, K), draw(trials, K, 8)


def accum_probe(dev):
    """Each (data, K, mode, period): the largest and mean |D - exact| /
    sum |a b| over the outputs, and the mean signed error."""
    import torch

    from exp_tpu_torch.ops import _build

    fn, err = _build.bind("probe_tf32_accum", [ctypes.c_void_p] * 3
                          + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    gen = torch.Generator().manual_seed(11)
    out = []
    for kind in ("pos_tf32", "pos_f32", "signed_f32"):
        for K in ACCUM_K:
            A, B = accum_data(kind, K, ACCUM_TRIALS, gen, dev)
            exact = torch.bmm(A.double(), B.double())
            scale = torch.bmm(A.double().abs(), B.double().abs())
            D = torch.empty((ACCUM_TRIALS, 16, 8), dtype=torch.float32,
                            device=dev)
            for mode, (name, kinds) in ACCUM_MODES.items():
                if kind not in kinds:
                    continue
                for period in (ACCUM_PERIODS if mode != 3 else (0,)):
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    code = fn(A.data_ptr(), B.data_ptr(), D.data_ptr(),
                              ACCUM_TRIALS, K, mode, period, stream)
                    _build.raise_on(code, err, "probe_tf32_accum")
                    rel = (D.double() - exact) / scale
                    out.append({"data": kind, "K": K, "mode": name,
                                "period": period,
                                "max_rel": float(rel.abs().max()),
                                "mean_rel": float(rel.abs().mean()),
                                "mean_signed": float(rel.mean())})
                    print("probe_cube_split accum: " + json.dumps(out[-1]),
                          file=sys.stderr, flush=True)
            del A, B, exact, scale
    return out


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first", metavar="DIR", default=None,
                    help="split the first kernels instead: a checkout of a "
                         "commit before their redesign (c8c4e40 or older)")
    ap.add_argument("--accum-only", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_cube_split: no CUDA device; it times the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(dev),
           "accum": accum_probe(dev)}
    if not a.accum_only:
        if a.first:
            variants = FIRST_VARIANTS
            roots = make_variants(PORT / "_build" / "cubesplit_first",
                                  variants,
                                  Path(a.first).resolve() / "exp_tpu_torch")
        else:
            variants = VARIANTS
            roots = make_variants(PORT / "_build" / "cubesplit", variants)
        out["runs"] = time_variants(roots, variants, SIZES,
                                    "probe_cube_split")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
