"""What the time of P1 (slab phase-stream, csrc/slab_phasestream.cu) and
K3 (sphere coefficients from the recurrences, csrc/sphere_coef_rec.cu) is
made of.

    python -m exp_tpu_torch.probe_rec_split [--first DIR]

It times builds of the kernels with one part of their work cut out, by
bench_kernels.py's sweep (device time a launch by CUDA events around
launches queued behind a spin kernel) at 224, 49,152 and 1,048,576 rows:
P1 stream1 and stream2 on the probe's sample, K3 on the sphere bench's
sample under 'spline' and 'hat' at lmax 4 and under 'spline' at lmax 10.

  full        both kernels as they are (run first and last);
  no_scatter  P1's sums ignore the particle's first z node j0: every
              particle adds into the same z rows, so the binning by j0
              (sort or scatter) does nothing useful;
  no_stage    P1 reads its table rows from device memory where it uses
              them, not from a tile staged in shared memory (nothing is
              staged);
  no_walk     the redesigned P1 stages and sorts its tiles but walks
              none (its sums stay 0);
  one_block   P1 with another count of blocks an SM: the first
              kernels' z accumulator trimmed to 64 rows, so 3 (stream1)
              or 2 (stream2) blocks fit where 2 or 1 did; the redesigned
              kernel's plan held to one block an SM (tiles of 128);
  no_rows     K3's angular rows are the mass alone (no recurrences);
  no_adds     K3 adds nothing into its accumulator (the rows are still
              made);
  one_group   K3 launches only its first group of rows (the first
              kernels split lmax 10 into 4 groups of 32 rows, each block
              running every recurrence; at lmax 4 K3 has one group, so
              this is the full kernel there).

full - no_X bounds what part X costs.  Each variant is a copy of
exp_tpu_torch with its sources patched, made under
exp_tpu_torch/_build/recsplit/ (git-ignored) and timed in its own process
(`bench_kernels.py --root`).  `--first DIR` splits the first kernels (as
at c2d02af) of the checkout at DIR the same way.  Prints one JSON line:
each run's kernel ms a launch by rows and its fitted fixed cost and cost
a row.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from exp_tpu_torch.probe_accel_split import make_variants

PORT = Path(__file__).resolve().parent
SIZES = "224,49152,1048576"
P1 = "P1s1,P1s2"
K3 = "K3,K3hat,K3L10"

# ---------------------------------------------------------------------------
# the redesigned kernels

_P1_NO_SCATTER = ("slab_phasestream.cu",
                  "      walk_bin<KZ, SPLIT>(s[j], s[j + 1], s[j + KZ - 1],",
                  "      walk_bin<KZ, SPLIT>(s[0], s[1], s[KZ - 1],")
_P1_NO_STAGE = ("slab_phasestream.cu",
                "    const uint16_t* hrow = sh16 + (buf * g.nst + a) * (2 * W);\n"
                "    const uint16_t* lrow = hrow + g.A * (2 * W);",
                "    const uint16_t* hrow = ph + rowoff[a] + base;\n"
                "    const uint16_t* lrow = ph + rowoff[g.A + a] + base;")
_P1_NO_COPY = ("slab_phasestream.cu",
               "  constexpr int H = TILE / 2, W = H + 1;\n  if (async) {",
               "  constexpr int H = TILE / 2, W = H + 1;\n  return;\n  if (async) {")
_P1_NO_WALK = ("slab_phasestream.cu",
               "    if (a >= g.A) continue;", "    continue;")
_P1_ONE_BLOCK = ("ops/slab_kernels.py",
                 "    for per_sm in (2, 1):\n        for tile in P1_TILES:",
                 "    for per_sm in (1,):\n        for tile in P1_TILES:")
_K3_NO_ROWS = ("sphere_coef_rec.cu",
               "          plm = __fmul_rn(__fsub_rn(__fmul_rn(__fmul_rn(xc, (float)(2 * l - 1)), pl1),\n"
               "                                    __fmul_rn((float)(l + m - 1), pl2)),\n"
               "                          K.rk[l - m]);",
               "          plm = 1.0f;")
# K3's adds (add_chunk) are in the header it shares with K1's split form
_K3_NO_ADDS = ("sphere_coef_sums.cuh",
               "  if (lane < cnt) {\n    const int qq = qc + lane;",
               "  if (lane < 0) {\n    const int qq = qc + lane;")
_K3_ONE_GROUP = ("sphere_coef_rec.cu",
                 "  const dim3 grid(nblocks, ngroups);",
                 "  const dim3 grid(nblocks, 1);")

#: variant: (the kernels bench_kernels.py times, the (source, old, new)
#: patches; a source under csrc/ unless it names a directory)
VARIANTS = {
    "full": (P1 + "," + K3, ()),
    "no_scatter": (P1, (_P1_NO_SCATTER,)),
    "no_stage": (P1, (_P1_NO_STAGE, _P1_NO_COPY)),
    "no_walk": (P1, (_P1_NO_WALK,)),
    "one_block": (P1, (_P1_ONE_BLOCK,)),
    "no_rows": (K3, (_K3_NO_ROWS,)),
    "no_adds": (K3, (_K3_NO_ADDS,)),
    "one_group": (K3, (_K3_ONE_GROUP,)),
}

# ---------------------------------------------------------------------------
# the first kernels (as at c2d02af), for --first

_F_P1_SUMS = ("slab_phasestream.cu",
              "  const int ntask = g.nst * kChunks;",
              "  const int ntask = g.nst * kChunks;\n"
              "  float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;")
_F_P1_WALK = ("slab_phasestream.cu",
              "      scatter<KZ>(acc + a, g.A, zrec[p], v0);\n"
              "      if (p + 1 < cnt) scatter<KZ>(acc + a, g.A, zrec[p + 1], v1);",
              "      r0 += v0 * zrec[p].x, r1 += v0 * zrec[p].y, r2 += v0 * zrec[p].z;\n"
              "      if (p + 1 < cnt)\n"
              "        r0 += v1 * zrec[p + 1].x, r1 += v1 * zrec[p + 1].y,\n"
              "        r2 += v1 * zrec[p + 1].z;")
_F_P1_FOLD = ("slab_phasestream.cu",
              "  __syncthreads();\n  float* out = partial + (long long)blockIdx.x * accn;",
              "  if (threadIdx.x < g.A) {\n"
              "    acc[threadIdx.x] += r0;\n"
              "    acc[g.A + threadIdx.x] += r1;\n"
              "    acc[2 * g.A + threadIdx.x] += r2;\n"
              "  }\n"
              "  __syncthreads();\n  float* out = partial + (long long)blockIdx.x * accn;")
_F_P1_NO_STORE = ("slab_phasestream.cu",
                  "      dst[0] = in[t].x;\n      dst[1] = in[t].y;\n"
                  "      dst[2] = in[t].z;\n      dst[3] = in[t].w;",
                  "      (void)dst;")
_F_P1_GLOBAL = ("slab_phasestream.cu",
                "    const uint32_t* hrow = stage + a * kStride;\n"
                "    const uint32_t* lrow = stage + (g.A + a) * kStride;",
                "    const uint32_t* hrow = reinterpret_cast<const uint32_t*>(\n"
                "        ph + table_row(a, g) * n + base);\n"
                "    const uint32_t* lrow = reinterpret_cast<const uint32_t*>(\n"
                "        ph + table_row(g.A + a, g) * n + base);")
_F_P1_TRIM_ACC = ("slab_phasestream.cu",
                  "  const int accn = g.q.zrows * g.A;\n"
                  "  for (int e = threadIdx.x; e < accn; e += blockDim.x) acc[e] = 0.0f;",
                  "  const int accn = 64 * g.A;\n"
                  "  for (int e = threadIdx.x; e < accn; e += blockDim.x) acc[e] = 0.0f;")
_F_P1_TRIM_ROW = ("slab_phasestream.cu",
                  "  float* dst = acc + __float_as_int(r.w) * A;",
                  "  float* dst = acc + (__float_as_int(r.w) & 61) * A;")
_F_P1_TRIM_SMEM = ("slab_phasestream.cu",
                   "                      sizeof(float) * (size_t)g.q.zrows * g.A;",
                   "                      sizeof(float) * (size_t)64 * g.A;")
_F_P1_TRIM_PLAN = ("ops/slab_kernels.py",
                   "    return 16 * P1_TILE + 4 * nst * P1_STRIDE + 4 * prm.zrows * A",
                   "    return 16 * P1_TILE + 4 * nst * P1_STRIDE + 4 * 64 * A")
_F_P1_TRIM_PER_SM = ("ops/slab_kernels.py",
                     "    per_sm = 2 if 2 * (smem + 1024) <= props.shared_memory_per_multiprocessor \\\n"
                     "        else 1",
                     "    per_sm = max(1, min(3, props.shared_memory_per_multiprocessor\n"
                     "                        // (smem + 1024)))")
_F_K3_NO_ROWS = ("sphere_coef_rec.cu",
                 "        group_rows(ysh + lane * GS, p0, g, L, fs, wm, pz / r, px / R, py / R);",
                 "        for (int k = 0; k < g; ++k) ysh[lane * GS + k] = wm;")
_F_K3_NO_ADDS = ("sphere_coef_rec.cu",
                 "      for (int src = 0; src < kWarp; ++src) {",
                 "      for (int src = 0; src < 0; ++src) {")
_F_K3_ONE_GROUP = ("sphere_coef_rec.cu",
                   "  const dim3 grid(nbx, (P + G - 1) / G);",
                   "  const dim3 grid(nbx, 1);")
FIRST_VARIANTS = {
    "full": (P1 + "," + K3, ()),
    "no_scatter": (P1, (_F_P1_SUMS, _F_P1_WALK, _F_P1_FOLD)),
    "no_stage": (P1, (_F_P1_NO_STORE, _F_P1_GLOBAL)),
    "one_block": (P1, (_F_P1_TRIM_ACC, _F_P1_TRIM_ROW, _F_P1_TRIM_SMEM,
                       _F_P1_TRIM_PLAN, _F_P1_TRIM_PER_SM)),
    "no_rows": (K3, (_F_K3_NO_ROWS,)),
    "no_adds": (K3, (_F_K3_NO_ADDS,)),
    "one_group": (K3, (_F_K3_ONE_GROUP,)),
}


def run(roots, variants, sizes=SIZES):
    """Time each of `variants` from its copy in `roots`, "full" first and
    last: a list of {variant, kernel, ms: {n: ms}, fixed_ms, ms_per_row}."""
    out = []
    for name in ["full", *(v for v in variants if v != "full"), "full"]:
        kernels = variants[name][0]
        res = subprocess.run([sys.executable, str(PORT / "bench_kernels.py"),
                              "--root", str(roots[name]), "--kernels",
                              kernels, "--sizes", sizes],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"probe_rec_split {name}: bench_kernels.py "
                               f"failed:\n{res.stderr[-3000:]}")
        sweep = json.loads(res.stdout.strip().splitlines()[-1])["sweep"]
        for key in kernels.split(","):
            out.append({"variant": name, "kernel": key,
                        "ms": {r["n"]: r["device_ms"] for r in sweep["rows"]
                               if r["kernel"] == key},
                        **sweep["fit"][key]})
            print(f"probe_rec_split {name}: " + json.dumps(out[-1]),
                  file=sys.stderr, flush=True)
    return out


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first", metavar="DIR", default=None,
                    help="split the first kernels instead: a checkout of a "
                         "commit before their redesign (c2d02af or older)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_rec_split: no CUDA device; it times the card",
              file=sys.stderr)
        return 1
    if a.first:
        variants = FIRST_VARIANTS
        roots = make_variants(PORT / "_build" / "recsplit_first", variants,
                              Path(a.first).resolve() / "exp_tpu_torch")
    else:
        variants = VARIANTS
        roots = make_variants(PORT / "_build" / "recsplit", variants)
    out = {"device": torch.cuda.get_device_name(0),
           "runs": run(roots, variants)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
