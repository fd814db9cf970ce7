"""Standalone command-line tools (the reference's utils/ toolbox; port of
exp_tpu/cli).

Each tool runs as `python -m exp_tpu_torch.cli.<tool>` or through the
umbrella, `python -m exp_tpu_torch.cli <tool> ...`, with exp_tpu's flags,
printed lines, output files and exit codes, on the CUDA card unless
`--cpu` is given (with no card and no --cpu a tool refuses with a usage
error before it does any work).  The tools ported so far:

  ICs:         gensph (utils/ICs/gensph; --qp QPDistF, --ebar ellipsoidal
               bar, --adddisk, --addsphere), gendisk2d (the Disk2dHalo
               path via --nhalo), zangics (tapered-Mestel Zang disk)
  Analysis:    diskprof (+--coef), haloprof, sphprof (coefficient-based
               field profiles), slabprof, mssaprof, viewcoefs, h5compare,
               h5power, diskfreqs, diskeof (empirical basis
               re-orthogonalization), makecoefs, coefstoh5 (native
               coefficient file converter), scalarprod, crossval, kldiv,
               yamldiff
  MSSA:        mssafilter (exp_halo_noise / exp_disk_noise), expmssa
               (standalone M-SSA analysis + grouped reconstruction)
  SL/basis:    slcheck, orthochk, cylcache, eofinfo, slshift

Coefficient files, EOF caches and HDF5 outputs need h5py; a tool that reads
or writes one raises ImportError without it.  exp_tpu's PhaseSpace tools and
its other IC tools are ROADMAP item 14b.2.
"""

TOOLS = [
    "gensph", "gendisk2d", "zangics",
    "diskprof", "haloprof", "sphprof", "slabprof", "mssaprof", "viewcoefs",
    "h5compare", "h5power",
    "slcheck", "orthochk", "cylcache", "eofinfo", "crossval",
    "diskfreqs", "kldiv", "yamldiff",
    "mssafilter", "slshift", "scalarprod",
    "diskeof", "makecoefs", "coefstoh5", "expmssa",
]
