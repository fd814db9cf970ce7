"""What the time of K6 (sphere force from the poly harmonics,
csrc/sphere_accel_poly.cu) and K9 (slab coefficients, csrc/slab_coef.cu)
is made of.

    python -m exp_tpu_torch.probe_poly_slab_split [--first DIR]

It times builds of the kernels with one part of their work cut out, by
bench_kernels.py (device time a launch by CUDA events around launches
queued behind a spin kernel) at 1,048,576 rows: K6 and K6hat on the
sphere bench's Hernquist sample (lmax 4, 'poly'), K9 on the slab bench's
sheet ('spline').  The variants, each against `full` (the kernels as
they are, run first and last):

  no_ms      K6's products with the stack's nonzeros take a constant of
             the entry in place of its value (no read of Ms);
  no_table   K6 reads every particle's rows at node 0 (the loads and the
             arithmetic stay; every load hits the same lines), the node
             hidden behind a run-time test the compiler cannot fold, so
             it hoists nothing out of the particle loop;
  no_walk    K9's groups walk nothing (sort, staging, side buffer and
             reduction stay);
  no_ends    K9 skips adding the side buffer's rows after the walk;
  no_rows    K9 stages no phase rows (the walk reads stale ones);
  no_reduce  K9 launches no second kernel (its output is left unset);
  no_slide   K9's windows move without adding the rows they leave.

The results of all but `full` are wrong: they time a part.  `--first
DIR` splits the first K6 (Ms in shared memory, every entry degree and
parity allow) and K9 (read-modify-writes in a group's shared columns) of
the checkout at DIR, as at 0db109b and before:

  no_ms      the products take a constant of the row and the monomial;
  no_table   as above;
  no_rmw     K9 sums each thread's rows in registers and writes them once
             a tile (this times the shared read-modify-writes);
  no_stage   K9 stages only its first tile and walks its records again;
  no_phase   K9's phase is e = 1 (no e_x, e_y loads, no complex product).

Each variant is a copy of exp_tpu_torch with its sources patched
(probe_accel_split.make_variants), under exp_tpu_torch/_build/
polyslabsplit/ (git-ignored), timed in its own process (`bench_kernels.py
--root`).  Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from exp_tpu_torch.probe_accel_split import make_variants, time_variants

PORT = Path(__file__).resolve().parent
SIZES = "1048576"
K6, K9 = "K6,K6hat", "K9"

# ---------------------------------------------------------------------------
# the first kernels (as at 0db109b), for --first

_F_K6_ROW = ("sphere_accel_poly.cu",
             "template <int D>\n__device__ __forceinline__ float poly_row(",
             "template <int D, int R = 0>\n__device__ __forceinline__ float poly_row(")
_F_K6_MAC = ("sphere_accel_poly.cu",
             "s += Mrow[k] * mono[k];",
             "s += (float)(R * 64 + k + 1) * 0.0078125f * mono[k];")
_F_K6_CALLS = ("sphere_accel_poly.cu",
               """  const float y = poly_row<l>(Ms + Pr * NM, a.mono);
  s.pot += y * g;
  s.r += y * dg;
  s.tx += poly_row<l - 1>(Ms + (P + Pr) * NM, a.mono) * g;
  s.ty += poly_row<l - 1>(Ms + (2 * P + Pr) * NM, a.mono) * g;
  s.tz += poly_row<l - 1>(Ms + (3 * P + Pr) * NM, a.mono) * g;""",
               """  const float y = poly_row<l, Pr>(Ms + Pr * NM, a.mono);
  s.pot += y * g;
  s.r += y * dg;
  s.tx += poly_row<l - 1, P + Pr>(Ms + (P + Pr) * NM, a.mono) * g;
  s.ty += poly_row<l - 1, 2 * P + Pr>(Ms + (2 * P + Pr) * NM, a.mono) * g;
  s.tz += poly_row<l - 1, 3 * P + Pr>(Ms + (3 * P + Pr) * NM, a.mono) * g;""")
_F_K6_TABLE = ("sphere_accel_poly.cu",
               "const Point a{mono, att, twT + j0, rows,",
               "const Point a{mono, att, twT + j0 * (int)(q.nc < 0), rows,")
_F_K9_RMW_LOOP = ("slab_coef.cu",
                  """    for (int p = p0; p < p0 + cnt; ++p) {
      const float2 e = cube::cmul(ea, eb);
      const float wk[3] = {r.x, r.y, r.z};
      float2* dst = acc + (size_t)__float_as_int(r.w) * g.H;
      float2 v[KZ];
#pragma unroll
      for (int k = 0; k < KZ; ++k) v[k] = dst[k * g.H];""",
                  """    float2 v[KZ];
#pragma unroll
    for (int k = 0; k < KZ; ++k) v[k] = make_float2(0.0f, 0.0f);
    float2* dst = acc;
    for (int p = p0; p < p0 + cnt; ++p) {
      const float2 e = cube::cmul(ea, eb);
      const float wk[3] = {r.x, r.y, r.z};
      dst = acc + (size_t)__float_as_int(r.w) * g.H;""")
_F_K9_RMW_STORE = ("slab_coef.cu",
                   """#pragma unroll
      for (int k = 0; k < KZ; ++k) dst[k * g.H] = v[k];
    }
""",
                   """    }
#pragma unroll
    for (int k = 0; k < KZ; ++k) dst[k * g.H] = v[k];
""")
_F_K9_STAGE_OPEN = ("slab_coef.cu",
                    "    float in[kMaxTasks], ms[kMaxTasks];",
                    "    if (base == (long long)blockIdx.x * ntile) {\n"
                    "    float in[kMaxTasks], ms[kMaxTasks];")
_F_K9_STAGE_CLOSE = ("slab_coef.cu",
                     "    __syncthreads();\n\n    const long long left",
                     "    }\n    __syncthreads();\n\n    const long long left")
_F_K9_PHASE = ("slab_coef.cu",
               "      const float2 e = cube::cmul(ea, eb);",
               "      const float2 e = make_float2(1.0f, 0.0f);")
FIRST_VARIANTS = {
    "full": (K6 + "," + K9, ()),
    "no_ms": (K6, (_F_K6_ROW, _F_K6_MAC, _F_K6_CALLS)),
    "no_table": (K6, (_F_K6_TABLE,)),
    "no_rmw": (K9, (_F_K9_RMW_LOOP, _F_K9_RMW_STORE)),
    "no_stage": (K9, (_F_K9_STAGE_OPEN, _F_K9_STAGE_CLOSE)),
    "no_phase": (K9, (_F_K9_PHASE,)),
}

# ---------------------------------------------------------------------------
# the redesigned kernels

_K6_NO_MS = ("sphere_accel_poly.cu",
             "((s += M.v[E0 + e] * mono[Col<L, E0 + e>::value]), ...);",
             "((s += (float)(E0 + e + 1) * 0.0078125f * mono[Col<L, E0 + e>::value]), ...);")
_K6_NO_TABLE = ("sphere_accel_poly.cu",
                "const Point a{mono, att, twT + j0, sphere::table_rows(q),",
                "const Point a{mono, att, twT + j0 * (int)(q.nc < 0), sphere::table_rows(q),")
_K9_NO_WALK = ("slab_coef.cu",
               "    if (walker && k0 < k1) {\n      // particle by particle",
               "    if (walker && k0 < k1 && g.q.nzc < 0) {\n      // particle by particle")
_K9_NO_ENDS = ("slab_coef.cu",
               "    if (walker && nexts[grp] >= 0) {",
               "    if (walker && nexts[grp] >= 0 && g.q.nzc < 0) {")
_K9_NO_ROWS = ("slab_coef.cu",
               """      cube::powers(cube::unit_phase(cube::wrap(x[3 * i]), -1.0f), g.q.nx, row);
      cube::axis_row(cube::unit_phase(cube::wrap(x[3 * i + 1]), -1.0f), g.q.ny, 1.0f,
                     row + g.ax);""",
               "      (void)row;")
_K9_NO_REDUCE = ("slab_coef.cu",
                 "  coef_reduce<<<(M2 + 31) / 32, 32 * kReduceWarps, 0, stream>>>(partial, nblocks, g, out);",
                 "  (void)M2;")

_K9_NO_SLIDE = ("slab_coef.cu",
                "        if (j != col.c) col.slide(j, acc, g.H);",
                "        col.c = j;")
#: variant: (the kernels bench_kernels.py times, the (source, old, new)
#: patches; a source under csrc/ unless it names a directory)
VARIANTS = {
    "full": (K6 + "," + K9, ()),
    "no_ms": (K6, (_K6_NO_MS,)),
    "no_table": (K6, (_K6_NO_TABLE,)),
    "no_walk": (K9, (_K9_NO_WALK,)),
    "no_ends": (K9, (_K9_NO_ENDS,)),
    "no_rows": (K9, (_K9_NO_ROWS,)),
    "no_reduce": (K9, (_K9_NO_REDUCE,)),
    "no_slide": (K9, (_K9_NO_SLIDE,)),
}


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first", metavar="DIR", default=None,
                    help="split the first kernels instead: a checkout of a "
                         "commit before their redesign (0db109b or older)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_poly_slab_split: no CUDA device; it times the card",
              file=sys.stderr)
        return 1
    if a.first:
        variants = FIRST_VARIANTS
        roots = make_variants(PORT / "_build" / "polyslabsplit_first",
                              variants,
                              Path(a.first).resolve() / "exp_tpu_torch")
    else:
        variants = VARIANTS
        roots = make_variants(PORT / "_build" / "polyslabsplit", variants)
    out = {"device": torch.cuda.get_device_name(0),
           "runs": time_variants(roots, variants, SIZES,
                                 "probe_poly_slab_split")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
