"""What the two force kernels' time is made of: K2 (sphere force,
csrc/sphere_accel.cu) and K5 (cylinder force, csrc/cyl_accel.cu).

    python -m exp_tpu_torch.probe_accel_split [--first DIR]

It times builds of the kernels with one part of their work replaced by a
cheap stand-in, on the benches' samples, by bench_kernels.py's sweep
(device time a launch by CUDA events around launches queued behind a spin
kernel, 224 ... 1,048,576 rows):

  full           both kernels as they are (run first and last);
  no_table       K2 reads every table row of every particle from one
                 128-byte line (the interpolation's loads and arithmetic
                 stay; only where they read changes);
  no_recurrence  K2's P_lm and dP_lm are cheap functions of cos theta and
                 the index (the m-chain, the table rows and the sums
                 stay);
  no_gather      K5 reads its 6 (x, y) nodes from 6 fixed nodes, the same
                 for every particle (the weights and the arithmetic stay).

full - no_table bounds what the table's layout and locality cost K2,
full - no_recurrence what its serial Legendre chain costs, full -
no_gather what K5's gather of 6 table rows costs.  Each variant is a copy
of exp_tpu_torch with its kernels patched, made under
exp_tpu_torch/_build/accelsplit/ (git-ignored) and timed in its own
process (`bench_kernels.py --root`).  `--first DIR` splits the first
kernels (one thread a particle, as at e0a537e) of the checkout at DIR the
same way.  Prints one JSON line: each run's kernel ms a launch by rows and
its fitted fixed cost and cost a row.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

PORT = Path(__file__).resolve().parent

_K2_TABLE = (
    "  a.tw = twT + j0;",
    "  a.tw = twT;")
_K2_TABLE_ROW = (
    "      const float* t = a.tw + row * tb.rows;",
    "      const float* t = a.tw + (row & 7);")
_K2_TABLE_D = (
    "        const float* d = t + tb.P * tb.rows;",
    "        const float* d = t + 8;")
_K2_RECURRENCE = (
    """    float plm;
    if (l == m) plm = ch.pmm;
    else if (l == m + 1) plm = __fmul_rn(__fmul_rn(a.xc, (float)(2 * m + 1)), pl1);
    else plm = __fmul_rn(__fsub_rn(__fmul_rn(__fmul_rn(a.xc, (float)(2 * l - 1)), pl1),
                                   __fmul_rn((float)(l + m - 1), pl2)),
                         tb.rk[l - m]);""",
    """    const float plm = __fmaf_rn(a.xc, (float)(l + 1), ch.pmm);""")
_K2_DERIV = (
    """    float dplm;
    if (l == 0) dplm = 0.0f;
    else if (l == m) dplm = __fmul_rn(a.inv, lxp);
    else dplm = __fmul_rn(a.inv, __fsub_rn(lxp, __fmul_rn((float)(l + m), pl1)));""",
    """    const float dplm = __fmaf_rn(lxp, a.inv, (float)m);""")
_K5_GATHER = (
    """  a.nd.row0 = Ct4 + (long long)(jx[0] * q.ncy + jy[0]) * SP4;
  a.nd.xstep = (jx[1] - jx[0]) * q.ncy * SP4;
  a.nd.ystep = (jy[1] - jy[0]) * SP4;""",
    """  a.nd.row0 = Ct4;
  a.nd.xstep = 2 * SP4;
  a.nd.ystep = SP4;""")

# the same stand-ins in the first kernels (one thread a particle, as at
# e0a537e), for --first
_F_TABLE = (
    "    const float* t = tw + (long long)k * rows + j0;",
    "    const float* t = tw + (k & 7);")
_F_TABLE_D = (
    "      const float* d = t + (long long)P * rows;",
    "      const float* d = t + 8;")
_F_RECURRENCE = (
    """        float plm;
        if (l == m) plm = pmm;
        else if (l == m + 1) plm = xc * (float)(2 * m + 1) * pmm;
        else plm = (xc * (float)(2 * l - 1) * pl1 - (float)(l + m - 1) * pl2)
                   / (float)(l - m);
        const float lxp = __fmul_rn(__fmul_rn((float)l, xc), plm);
        float dplm;
        if (l == 0) dplm = 0.0f;
        else if (l == m) dplm = __fmul_rn(inv, lxp);
        else dplm = __fmul_rn(inv, __fsub_rn(lxp, __fmul_rn((float)(l + m), pl1)));""",
    """        const float plm = fmaf(xc, (float)(l + 1), pmm);
        const float dplm = fmaf(xc, inv, (float)m);""")
_F_GATHER = (
    "      const float4* r0 = reinterpret_cast<const float4*>(Ct + ((long long)jx[a] * ncy + jy[0]) * SP);\n"
    "      const float4* r1 = reinterpret_cast<const float4*>(Ct + ((long long)jx[a] * ncy + jy[1]) * SP);",
    "      const float4* r0 = reinterpret_cast<const float4*>(Ct + (long long)(2 * a) * SP);\n"
    "      const float4* r1 = reinterpret_cast<const float4*>(Ct + (long long)(2 * a + 1) * SP);")
FIRST_VARIANTS = {
    "full": ("K2,K5", ()),
    "no_table": ("K2", (("sphere_accel.cu",) + _F_TABLE,
                        ("sphere_accel.cu",) + _F_TABLE_D)),
    "no_recurrence": ("K2", (("sphere_accel.cu",) + _F_RECURRENCE,)),
    "no_gather": ("K5", (("cyl_accel.cu",) + _F_GATHER,)),
}

#: variant: (the kernels bench_kernels.py times, the (source, old, new)
#: patches)
VARIANTS = {
    "full": ("K2,K5", ()),
    "no_table": ("K2", tuple(("sphere_accel.cu",) + p for p in
                             (_K2_TABLE, _K2_TABLE_ROW, _K2_TABLE_D))),
    "no_recurrence": ("K2", (("sphere_accel.cu",) + _K2_RECURRENCE,
                             ("sphere_accel.cu",) + _K2_DERIV)),
    "no_gather": ("K5", (("cyl_accel.cu",) + _K5_GATHER,)),
}
ORDER = ("full", "no_table", "no_recurrence", "no_gather", "full")


def _source(src):
    """A patch's file in the package: under csrc/ unless it names a
    directory."""
    return src if "/" in src else f"csrc/{src}"


def patched_sources(patches, port=PORT):
    """{source: text} of the files of the package at `port` that `patches`
    touch, each (source, old, new) patch applied once; raises when a patch
    no longer matches its source."""
    out = {}
    for src, old, new in patches:
        text = out.get(src, (Path(port) / _source(src)).read_text())
        if text.count(old) != 1:
            raise ValueError(f"probe_accel_split: a patch no longer matches "
                             f"{_source(src)}; update it with the kernel")
        out[src] = text.replace(old, new)
    return out


def make_variants(dest, variants=VARIANTS, port=PORT):
    """A copy of the package at `port` (this exp_tpu_torch by default)
    under dest/<variant>/ for each of `variants`, its kernels patched;
    returns {variant: root}."""
    roots = {}
    for name, (_, patches) in variants.items():
        root = Path(dest) / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(port, root / "exp_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for src, text in patched_sources(patches, port).items():
            (root / "exp_tpu_torch" / _source(src)).write_text(text)
        roots[name] = root
    return roots


def time_variants(roots, variants, sizes, tag):
    """Time each of `variants` from its copy in `roots` by bench_kernels.py
    at `sizes` (a comma list), "full" first and last: a list of {variant,
    kernel, ms: {n: ms}, digest: {n: digest}}, each also printed to stderr
    after `tag`."""
    out = []
    for name in ["full", *(v for v in variants if v != "full"), "full"]:
        kernels = variants[name][0]
        res = subprocess.run([sys.executable, str(PORT / "bench_kernels.py"),
                              "--root", str(roots[name]), "--kernels",
                              kernels, "--sizes", sizes],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{tag} {name}: bench_kernels.py failed:\n"
                               f"{res.stderr[-3000:]}")
        sweep = json.loads(res.stdout.strip().splitlines()[-1])["sweep"]
        for key in kernels.split(","):
            rows = [r for r in sweep["rows"] if r["kernel"] == key]
            out.append({"variant": name, "kernel": key,
                        "ms": {r["n"]: r["device_ms"] for r in rows},
                        "digest": {r["n"]: r["digest"] for r in rows}})
            print(f"{tag} {name}: " + json.dumps(out[-1]), file=sys.stderr,
                  flush=True)
    return out


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first", metavar="DIR", default=None,
                    help="split the first kernels instead: a checkout of a "
                         "commit before their redesign (e0a537e or older)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_accel_split: no CUDA device; it times the card",
              file=sys.stderr)
        return 1
    if a.first:
        roots = make_variants(PORT / "_build" / "accelsplit_first",
                              FIRST_VARIANTS,
                              Path(a.first).resolve() / "exp_tpu_torch")
    else:
        roots = make_variants(PORT / "_build" / "accelsplit")
    out = {"device": torch.cuda.get_device_name(0), "runs": []}
    for name in ORDER:
        kernels = VARIANTS[name][0]
        res = subprocess.run([sys.executable, str(PORT / "bench_kernels.py"),
                              "--root", str(roots[name]), "--kernels",
                              kernels], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"probe_accel_split {name}: bench_kernels.py "
                               f"failed:\n{res.stderr[-3000:]}")
        sweep = json.loads(res.stdout.strip().splitlines()[-1])["sweep"]
        for key in kernels.split(","):
            out["runs"].append({
                "variant": name, "kernel": key,
                "ms": {r["n"]: r["device_ms"] for r in sweep["rows"]
                       if r["kernel"] == key},
                **sweep["fit"][key]})
            print(f"probe_accel_split {name}: "
                  + json.dumps(out["runs"][-1]), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
