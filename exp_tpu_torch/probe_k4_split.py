"""What K4's time is made of, and so what sharing each particle's geometry
across its row groups could save.

    python -m exp_tpu_torch.probe_k4_split

K4 (csrc/cyl_coef.cu) computes each particle's geometry (cylindrical maps,
arcsinh, trig rows, x and y weights) once in each of its row-group blocks.
A thread-block cluster of a chunk's group blocks could compute it once and
share it through distributed shared memory; this probe bounds that gain
before anyone builds it.  It times four builds of K4 on the disk bench's
sample by bench_kernels.py's sweep (device time a launch by CUDA events
around launches queued behind a spin kernel, 224 ... 1,048,576 rows):

  full         csrc/cyl_coef.cu as it is (run first and last);
  no_adds      the shared-memory adds never fire (their loads stay);
  no_geometry  nodes from a hash of x and fixed weights in place of the
               geometry (the staging and the adds stay);
  neither      both.

full - no_geometry is the geometry's time over all row groups; a cluster
could save at most (groups - 1) / groups of it.  Each variant is a copy of
exp_tpu_torch with its cyl_coef.cu patched, made under
exp_tpu_torch/_build/k4split/ (git-ignored) and timed in its own process
(`bench_kernels.py --root`).  Prints one JSON line: each variant's K4 ms a
launch by rows and its fitted fixed cost and cost a row.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

PORT = Path(__file__).resolve().parent

_GEOMETRY = ('''      float R_, r;
      cyl::cyl_maps(px, py, pz, R_, r);
      const float w = r <= q.rmax_grid ? pm : 0.0f;
      if (w != 0.0f) {
        float c[M1], s[M1];
        cyl::trig_rows<MMAX>(px / R_, py / R_, c, s);
        float tx, ty;
        cyl::grid_coords(R_, pz, q, tx, ty);
        int jx[KX], jy[2];
        float wx[KX], wy[2];
        cyl::x_weights<SPLINE>(tx, q.ncx, jx, wx);
        cyl::y_weights(ty, ncy, jy, wy);''', '''      const float w = pm;
      if (w != 0.0f) {
        float c[M1], s[M1];
#pragma unroll
        for (int k = 0; k < M1; ++k) { c[k] = px; s[k] = py; }
        int jx[KX], jy[2];
        float wx[KX], wy[2];
        const unsigned hsh = __float_as_uint(px) * 2654435761u;
        jx[0] = (int)(hsh % (unsigned)(xrows - KX + 1));
        jy[0] = (int)((hsh >> 12) % (unsigned)(ncy - 1));
#pragma unroll
        for (int k = 0; k < KX; ++k) wx[k] = 0.3f;
        wy[0] = 0.5f; wy[1] = 0.5f;''')
_ADD = " atomicAdd(acc + bs[k] + lofs, val[k]);"
_ADDS = ("if (bs[k] >= 0 && val[k] != 0)" + _ADD,
         "if (bs[k] == -7 && val[k] == 12345)" + _ADD)
VARIANTS = {"full": (), "no_adds": (_ADDS,), "no_geometry": (_GEOMETRY,),
            "neither": (_GEOMETRY, _ADDS)}


def patched_source(source, patches):
    """cyl_coef.cu's text with each (old, new) patch applied once; raises
    when a patch no longer matches the source."""
    for old, new in patches:
        if source.count(old) != 1:
            raise ValueError("probe_k4_split: a patch no longer matches "
                             "csrc/cyl_coef.cu; update it with the kernel")
        source = source.replace(old, new)
    return source


def make_variants(dest):
    """A copy of exp_tpu_torch under dest/<variant>/ for each variant, its
    cyl_coef.cu patched; returns {variant: root}."""
    source = (PORT / "csrc" / "cyl_coef.cu").read_text()
    roots = {}
    for name, patches in VARIANTS.items():
        root = Path(dest) / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PORT, root / "exp_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        (root / "exp_tpu_torch" / "csrc" / "cyl_coef.cu").write_text(
            patched_source(source, patches))
        roots[name] = root
    return roots


def main():
    import torch

    if not torch.cuda.is_available():
        print("probe_k4_split: no CUDA device; it times the card",
              file=sys.stderr)
        return 1
    roots = make_variants(PORT / "_build" / "k4split")
    out = {"device": torch.cuda.get_device_name(0), "runs": []}
    for name in ("full", "no_adds", "no_geometry", "neither", "full"):
        res = subprocess.run([sys.executable, str(PORT / "bench_kernels.py"),
                              "--root", str(roots[name]), "--kernels", "K4"],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"probe_k4_split {name}: bench_kernels.py "
                               f"failed:\n{res.stderr[-3000:]}")
        sweep = json.loads(res.stdout.strip().splitlines()[-1])["sweep"]
        out["runs"].append({
            "variant": name,
            "ms": {r["n"]: r["device_ms"] for r in sweep["rows"]
                   if r["kernel"] == "K4"},
            **sweep["fit"]["K4"]})
        print(f"probe_k4_split {name}: " + json.dumps(out["runs"][-1]),
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
