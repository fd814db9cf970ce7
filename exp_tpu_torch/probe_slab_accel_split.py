"""What the time of K10 (slab force, csrc/slab_accel.cu) is made of.

    python -m exp_tpu_torch.probe_slab_accel_split [--first DIR]

It times builds of the kernel with one part of its work cut out, by
bench_kernels.py (device time a launch by CUDA events around launches
queued behind a spin kernel) at 1,048,576 rows of the slab bench's sheet
('spline').  The variants, each against `full` (the kernel as it is, run
first and last):

  no_table  every particle reads its table rows at node 0 (the loads and
            the arithmetic stay; every load of a warp hits the same
            lines), the node hidden behind a run-time test the compiler
            cannot fold, so it hoists nothing out of the particle loop;
  sorted    the kernel as it is on the sheet sorted by z on the host
            (bench_kernels.py's K10sort): every warp's particles on one or
            two z nodes, what warp-coherent rows would save without a
            sort in the kernel;
  tiles     the same on the sheet sorted by z within each 1,024 rows
            (K10tile): what a sort of the kernel's own tiles would give;
  no_phase  the phase is e = 1, with no phase recurrence;
  no_store  the outputs are not written, behind a run-time test.

The redesigned kernel sorts its tiles itself; its split adds

  no_sort   every particle in one bin, so that each tile's records keep
            about the input's order (the counts, the scan and the staging
            stay): what the kernel's sort saves;
  no_walk   the walk skipped behind a run-time test (each output a copy
            of its record): the sort, the staging, the copies of x and the
            stores alone.

The results of all but `full`, `sorted` and `tiles` are wrong: they time
a part.  `--first DIR` splits the first K10 (one thread a particle in the
input's order, as at 153d877 and before; no `no_sort`) of the checkout at
DIR; the default splits this checkout's kernel.

Each variant is a copy of exp_tpu_torch with its source patched
(probe_accel_split.make_variants), under exp_tpu_torch/_build/
slabaccelsplit/ (git-ignored), timed in its own process (`bench_kernels.py
--root`).  Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from exp_tpu_torch.probe_accel_split import make_variants, time_variants

PORT = Path(__file__).resolve().parent
SIZES = "1048576"

# ---------------------------------------------------------------------------
# the first kernel (as at 153d877), for --first

_F_TABLE = ("slab_accel.cu",
            "const float4* rows = tab + (size_t)j0 * H;",
            "const float4* rows = tab + (size_t)j0 * H * (int)(q.nzc < 0);")
_F_PHASE = ("slab_accel.cu",
            """      f(a * B2 + b, a, b, cube::cmul(px, py));
      if (a > 0 && b > 0) f(a * B2 - b, a, -b, cube::cmul(px, cube::conj(py)));
      py = cube::cmul(py, e1y);
    }
    px = cube::cmul(px, e1x);""",
            """      f(a * B2 + b, a, b, make_float2(1.0f, 0.0f));
      if (a > 0 && b > 0) f(a * B2 - b, a, -b, make_float2(1.0f, 0.0f));
    }""")
_F_STORE = ("slab_accel.cu",
            """    acc[3 * i] = s.fx;
    acc[3 * i + 1] = s.fy;
    acc[3 * i + 2] = s.fz;
    pot[i] = s.pot;""",
            """    if (q.nzc < 0) {
    acc[3 * i] = s.fx;
    acc[3 * i + 1] = s.fy;
    acc[3 * i + 2] = s.fz;
    pot[i] = s.pot;
    }""")
FIRST_VARIANTS = {
    "full": ("K10", ()),
    "no_table": ("K10", (_F_TABLE,)),
    "sorted": ("K10sort", ()),
    "tiles": ("K10tile", ()),
    "no_phase": ("K10", (_F_PHASE,)),
    "no_store": ("K10", (_F_STORE,)),
}

# ---------------------------------------------------------------------------
# the redesigned kernel

_TABLE = ("slab_accel.cu",
          "const float4* rows = tab + (size_t)j0 * g.H * KZ;",
          "const float4* rows = tab + (size_t)j0 * g.H * KZ * (int)(q.nzc < 0);")
_SORT = ("slab_accel.cu",
         "const int bin = p < count ? bin_of<KZ>(sm.xs[3 * p + 2], g.q) : -1;",
         "const int bin = p < count ? (g.q.nzc < 0 ? bin_of<KZ>(sm.xs[3 * p + 2], g.q)"
         " : 0) : -1;")
_PHASE_Y = ("slab_accel.cu",
            "for (int b = 1; b <= NY; ++b) py[j][b] = cube::cmul(py[j][b - 1], e1y[j]);",
            "for (int b = 1; b <= NY; ++b) py[j][b] = py[j][b - 1];")
_PHASE_X0 = ("slab_accel.cu",
             "for (int j = 0; j < P; ++j) px[j] = e1x[j];",
             "for (int j = 0; j < P; ++j) px[j] = make_float2(1.0f, 0.0f);")
_PHASE_X = ("slab_accel.cu",
            "      px[j] = cube::cmul(px[j], e1x[j]);\n",
            "")
_STORE = ("slab_accel.cu",
          """    for (int e = tid; e < 3 * count; e += nthreads) acc[3 * base + e] = sm.oacc[e];
    for (int e = tid; e < count; e += nthreads) pot[base + e] = sm.opot[e];""",
          """    if (g.q.nzc < 0) {
    for (int e = tid; e < 3 * count; e += nthreads) acc[3 * base + e] = sm.oacc[e];
    for (int e = tid; e < count; e += nthreads) pot[base + e] = sm.opot[e];
    }""")

_WALK = ("slab_accel.cu",
         "      walk<NY, KZ>(r, tab, aux, g, o);",
         "      if (g.q.nzc < 0) walk<NY, KZ>(r, tab, aux, g, o);\n"
         "      else { o[0] = r[0]; o[1] = r[1]; }")

#: variant: (the kernels bench_kernels.py times, the (source, old, new)
#: patches; a source under csrc/ unless it names a directory)
VARIANTS = {
    "full": ("K10", ()),
    "no_table": ("K10", (_TABLE,)),
    "no_sort": ("K10", (_SORT,)),
    "sorted": ("K10sort", ()),
    "tiles": ("K10tile", ()),
    "no_phase": ("K10", (_PHASE_Y, _PHASE_X0, _PHASE_X)),
    "no_store": ("K10", (_STORE,)),
    "no_walk": ("K10", (_WALK,)),
}


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first", metavar="DIR", default=None,
                    help="split the first kernel instead: a checkout of a "
                         "commit before its redesign (153d877 or older)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_slab_accel_split: no CUDA device; it times the card",
              file=sys.stderr)
        return 1
    if a.first:
        variants = FIRST_VARIANTS
        roots = make_variants(PORT / "_build" / "slabaccelsplit_first",
                              variants,
                              Path(a.first).resolve() / "exp_tpu_torch")
    else:
        variants = VARIANTS
        roots = make_variants(PORT / "_build" / "slabaccelsplit", variants)
    out = {"device": torch.cuda.get_device_name(0),
           "runs": time_variants(roots, variants, SIZES,
                                 "probe_slab_accel_split")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
