"""Standalone command-line tools (the reference's utils/ toolbox; port of
exp_tpu/cli, all 58 of its tools).

Each tool runs as `python -m exp_tpu_torch.cli.<tool>` or through the
umbrella, `python -m exp_tpu_torch.cli <tool> ...`, with exp_tpu's flags,
printed lines, output files and exit codes, on the CUDA card unless
`--cpu` is given (with no card and no --cpu a tool refuses with a usage
error before it does any work).  Coverage of the reference's utils/
inventory (SURVEY section 2.5):

  ICs:         gensph (utils/ICs/gensph; --qp QPDistF, --ebar ellipsoidal
               bar, --adddisk, --addsphere), cubeics, genslab, gendisk
               (full DiskHalo path via --nhalo), gendisk2d (Disk2dHalo
               path via --nhalo), shrinkics, modelfit, addring, addsphmod,
               forcetest, bonnerebert, zangics (tapered-Mestel Zang
               disk), hdf52accel
  PhaseSpace:  pspinfo, pspstat, psp2ascii, ascii2psp, snap2ascii, diffpsp,
               pspinterp, psp2hdf5, psphisto, pspbox, snapconvert,
               snap2vtk, psporbv, pspmono (monopole model table),
               psp2bess/psp2lagu/psp2rings (kinematic Fourier series),
               psp2range, pspreal, spl2psp (split-PSP assembly),
               tipstd2psp (+ snapconvert --to tipsy writer), psp2vtu
  Analysis:    diskprof (+--coef), haloprof, sphprof (coefficient-based
               field profiles), slabprof, mssaprof, viewcoefs, h5compare,
               h5power, diskfreqs, diskeof (empirical basis
               re-orthogonalization), makecoefs, coefstoh5 (native
               coefficient file converter), scalarprod, crossval, kldiv,
               yamldiff
  MSSA:        mssafilter (exp_halo_noise / exp_disk_noise), expmssa
               (standalone M-SSA analysis + grouped reconstruction)
  SL/basis:    slcheck, orthochk, cylcache, eofinfo, slshift

Coefficient files, EOF caches and HDF5 inputs or outputs need h5py; a tool
that reads or writes one (psp2hdf5, hdf52accel, snapconvert's gadgethdf5)
raises ImportError without it.
"""

TOOLS = [
    "gensph", "cubeics", "gendisk", "genslab", "gendisk2d",
    "pspinfo", "pspstat", "psp2ascii", "ascii2psp", "snap2ascii", "diffpsp",
    "psp2hdf5", "shrinkics", "psphisto", "pspbox", "snapconvert", "snap2vtk",
    "diskprof", "haloprof", "sphprof", "slabprof", "mssaprof", "viewcoefs",
    "h5compare", "h5power",
    "slcheck", "orthochk", "cylcache", "eofinfo", "crossval",
    "diskfreqs", "kldiv", "yamldiff",
    "modelfit", "addring", "addsphmod", "forcetest",
    "psporbv", "bonnerebert", "mssafilter", "slshift",
    "scalarprod", "pspinterp",
    "zangics", "pspmono",
    "psp2bess", "psp2lagu", "psp2rings", "psp2range", "pspreal", "spl2psp",
    "diskeof", "hdf52accel", "makecoefs", "coefstoh5",
    "tipstd2psp", "psp2vtu", "expmssa",
]
