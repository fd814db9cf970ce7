"""expmssa — standalone M-SSA analysis of a coefficient series
(utils/MSSA/expmssa.cc): decompose the channels with multichannel SSA
and write the reference's text products —

  <prefix>.data      the detrended channel series that entered the
                     analysis (expmssa.cc:413)
  <prefix>.ev        eigenvalues + cumulative fraction (:546)
  <prefix>.evec      leading eigenvectors (:581)
  <prefix>.pc        principal-component time series (:612)
  <prefix>.f_contrib PC contributions to each channel (:752)
  <prefix>.wcorr     the w-correlation matrix (wcorrPNG analogue)
  <prefix>.g<N>.recon  per-group reconstructed coefficient files when
                     -G/--group or --kmeans supplies a grouping (:941)

Grouping: `-G file` reads one group of PC indices per line;
`--kmeans K` clusters the eigentriples by w-correlation distance
(expmssa.cc kmeans/allchan/distance flags).

Port of exp_tpu/cli/expmssa.py (host NumPy; the coefficient files are
HDF5 and need h5py)."""

import sys

import numpy as np

from exp_tpu_torch.cli._common import make_parser


def _read_groups(path):
    groups = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#")[0].strip()
            if line:
                groups.append([int(tok) for tok in line.split()])
    return groups


def main(argv=None):
    ap = make_parser("expmssa", __doc__)
    ap.add_argument("-d", "--datafile", required=True,
                    help="coefficient file (HDF5 or EXP native)")
    ap.add_argument("-o", "--output", default="exp_mssa",
                    help="output file prefix")
    ap.add_argument("-W", "--numW", type=int, default=10,
                    help="embedding window")
    ap.add_argument("-P", "--npc", type=int, default=99999,
                    help="maximum number of principal components")
    ap.add_argument("-t", "--evtol", type=float, default=0.01,
                    help="cumulative-variance cut for the eigenvalue sum")
    ap.add_argument("-G", "--group", default=None,
                    help="group file: one line of PC indices per group")
    ap.add_argument("--kmeans", type=int, default=0,
                    help="k-means grouping of eigentriples (0: off)")
    ap.add_argument("--distance", action="store_true",
                    help="k-means on w-corr distance instead of "
                         "correlation")
    ap.add_argument("-C", "--coefs", action="store_true",
                    help="also write the PC series (the .pc file)")
    ap.add_argument("-H", "--histo", action="store_true",
                    help="also write PC contributions (.f_contrib)")
    a = ap.parse_args(argv)

    from exp_tpu_torch.analysis.coefs import Coefs
    from exp_tpu_torch.analysis.mssa import expMSSA

    coefs = Coefs.from_file(a.datafile)
    times = np.asarray(coefs.times())
    if len(times) < 2 * a.numW:
        print(f"expmssa: only {len(times)} samples for window {a.numW}; "
              f"need >= {2 * a.numW}")
        return 1
    m = expMSSA({"c": coefs}, window=a.numW, numpc=min(a.npc, a.numW))

    # .data: the channel series that entered the analysis (mean re-added)
    pts = np.column_stack(
        [times] + [m._series[k] + m._mean[k] for k in m.keys])
    np.savetxt(f"{a.output}.data", pts,
               header="time then one column per channel "
                      f"(keys: {[k[1] for k in m.keys]})")

    ev = m.eigenvalues()
    cum = np.cumsum(ev) / np.sum(ev)
    np.savetxt(f"{a.output}.ev", np.column_stack([ev, cum]),
               header="eigenvalue  cumulative_fraction")
    ncomp = int(np.searchsorted(1.0 - cum < a.evtol, True)) + 1
    ncomp = min(ncomp, a.npc, len(ev))
    print(f"expmssa: {len(ev)} eigentriples; {ncomp} pass the "
          f"evtol={a.evtol} cut (cumvar {cum[ncomp - 1]:.4f})")

    np.savetxt(f"{a.output}.evec", m.U[:, :ncomp],
               header="leading eigenvectors (columns)")
    if a.coefs:
        pc = m.pcs()
        np.savetxt(f"{a.output}.pc",
                   np.column_stack([times[:pc.shape[0]], pc[:, :ncomp]]),
                   header="time then one column per PC")
    if a.histo:
        # PC-into-channel energy: lambda_j * ||Vt_j over the channel's
        # window block||^2, normalized per channel (f_contrib table)
        w_ = m.window
        contrib = np.array(
            [[m.S[j] ** 2 * (m.Vt[j, c * w_:(c + 1) * w_] ** 2).sum()
              for c in range(m.nkeys)] for j in range(ncomp)])
        tot = contrib.sum(axis=0, keepdims=True)
        np.savetxt(f"{a.output}.f_contrib",
                   contrib / np.where(tot > 0, tot, 1.0),
                   header="rows: PCs; columns: channels")

    w = m.wcorr(ncomp=ncomp)
    np.savetxt(f"{a.output}.wcorr", w, header="w-correlation matrix")

    groups = None
    if a.group:
        groups = _read_groups(a.group)
    elif a.kmeans > 0:
        assign, _, _ = m.kmeans(a.kmeans, stride=1)
        assign = np.asarray(assign)
        groups = [list(np.nonzero(assign == g)[0])
                  for g in range(a.kmeans)]
        groups = [g for g in groups if g]
    if groups:
        for gi, g in enumerate(groups):
            recon = m.reconstruct_coefs(coefs, groups=[g], name="c")
            path = f"{a.output}.g{gi}.recon"
            recon.to_file(path)
            print(f"expmssa: group {gi} (PCs {g}) -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
