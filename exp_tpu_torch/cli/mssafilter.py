"""mssafilter — M-SSA noise filtering of coefficient file(s)
(utils/MSSA/exp_halo_noise.cc, exp_disk_noise.cc, exp_haloN.cc):
decompose the coefficient series with M-SSA, keep the leading
eigentriples (by count `--npc` and/or the cumulative-variance cut
`--evtol`, exp_halo_noise.cc:517-528), and write

  <prefix>[.k].recon       — the filtered (signal) coefficient series
  <prefix>[.k].recon_diff  — the residual (noise) series

both in the coefficient file format of the input (exp_halo_noise.cc:679-693
writes EXP native format; here the HDF5 schema round-trips through
exp_tpu_torch.io.coefs, which needs h5py).  `--zero` zeroes channels
excluded from the analysis in the reconstruction (the reference's -z).  Passing SEVERAL -d files is the
exp_haloN multi-simulation mode: one joint M-SSA over the union of every
run's channels (shared temporal PCs), with per-run output files.  Port
of exp_tpu/cli/mssafilter.py (host NumPy)."""

import sys

import numpy as np

from exp_tpu_torch.cli._common import make_parser


def main(argv=None):
    ap = make_parser("mssafilter", __doc__)
    ap.add_argument("-d", "--datafile", required=True, action="append",
                    help="coefficient file (HDF5 or EXP native); repeat "
                         "for the exp_haloN multi-run joint analysis")
    ap.add_argument("-o", "--output", default="noise",
                    help="output file prefix")
    ap.add_argument("-W", "--numW", type=int, default=10,
                    help="embedding window")
    ap.add_argument("-P", "--npc", type=int, default=99999,
                    help="max eigenvectors kept")
    ap.add_argument("-e", "--evtol", type=float, default=0.01,
                    help="cumulative-variance tail cut: keep PCs until "
                         "1 - cum/tot < evtol fails")
    ap.add_argument("-t", "--tmin", type=float, default=-np.inf)
    ap.add_argument("-T", "--tmax", type=float, default=np.inf)
    ap.add_argument("-z", "--zero", action="store_true",
                    help="zero channels outside the analysis window")
    ap.add_argument("-E", "--ev", action="store_true",
                    help="print eigenvalues and exit")
    a = ap.parse_args(argv)

    from exp_tpu_torch.analysis.coefs import Coefs
    from exp_tpu_torch.analysis.mssa import expMSSA

    # epochs are matched after rounding to 10 significant decimals —
    # exact float equality would split grids whose times differ in the
    # last bit (dt-accumulated vs stored exactly)
    def _keyed(times):
        return np.round(np.asarray(times, np.float64), 10)

    runs, raw_times = {}, {}
    common = None
    for k, path in enumerate(a.datafile):
        coefs = Coefs.from_file(path)
        times = np.asarray(coefs.times())
        keep_t = (times >= a.tmin) & (times <= a.tmax)
        times = times[keep_t]
        key = f"c{k}"
        raw_times[key] = times
        common = _keyed(times) if common is None else \
            np.intersect1d(common, _keyed(times))
        runs[key] = coefs
    # restrict every run to the common (windowed) epoch grid — the
    # exp_haloN joint analysis needs one shared time axis
    for key, coefs in list(runs.items()):
        times = raw_times[key]
        sel = times[np.isin(_keyed(times), common)]
        if len(sel) != len(np.asarray(coefs.times())):
            sub = Coefs(coefs.geometry, coefs.name, coefs.meta)
            for t in sel:
                sub.add(float(t), coefs(float(t)))
            runs[key] = sub
    if len(common) < 2 * a.numW:
        print(f"mssafilter: only {len(common)} samples for window "
              f"{a.numW}; need >= {2 * a.numW}")
        return 1

    m = expMSSA(runs, window=a.numW, numpc=min(a.npc, a.numW))
    ev = m.eigenvalues()
    cum = np.cumsum(ev) / np.sum(ev)
    if a.ev:
        for j, (l, c) in enumerate(zip(ev, cum)):
            print(f"{j:4d} {l:16.8e} {c:12.6f}")
        return 0
    # cumulative-variance cut (exp_halo_noise.cc:526-528)
    ncomp = int(np.searchsorted(1.0 - cum < a.evtol, True)) + 1
    ncomp = min(ncomp, a.npc, len(ev))
    groups = [[j] for j in range(ncomp)]
    print(f"mssafilter: keeping {ncomp}/{len(ev)} eigentriples "
          f"(cumvar {cum[ncomp - 1]:.4f})")

    multi = len(runs) > 1
    for k, (key, coefs) in enumerate(runs.items()):
        # this run's OWN stored times (the rounded `common` keys need
        # not be exact dict keys of the coefficient container)
        rts = list(coefs.times())
        recon = m.reconstruct_coefs(coefs, groups=groups, name=key)
        diff = coefs.deepcopy()
        for t in rts:
            diff._data[float(t)] = coefs(float(t)) - recon(float(t))
        if a.zero:
            # channels never entered the MSSA analysis keep their
            # original values in reconstruct_coefs; --zero zeroes them
            analyzed = {j for (nm, j) in m.keys if nm == key}
            for t in rts:
                flat = recon(float(t)).reshape(-1).copy()
                mask = np.ones(flat.size, bool)
                mask[list(analyzed)] = False
                flat[mask] = 0.0
                recon._data[float(t)] = flat.reshape(
                    coefs(float(t)).shape)
        tag = f"{a.output}.{k}" if multi else a.output
        recon.to_file(f"{tag}.recon")
        diff.to_file(f"{tag}.recon_diff")
        print(f"mssafilter: wrote {tag}.recon and {tag}.recon_diff")
    return 0


if __name__ == "__main__":
    sys.exit(main())
