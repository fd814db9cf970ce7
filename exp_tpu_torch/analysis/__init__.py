"""Analysis package (port of exp_tpu/analysis) — the pyEXP-equivalent API
over the port's forces.

Submodule layout mirrors pyEXP (reference pyEXP/PyWrappers.cc:103-135):
  basis  — Basis factory + coefficient generation from snapshots
  coefs  — time-keyed coefficient containers (HDF5-backed)
  field  — FieldGenerator: density/potential/force on slices/volumes/points
  mssa   — multivariate singular spectrum analysis (expMSSA)
  edmd   — Koopman / extended DMD
  util   — centers (COM, density center), version info

Beyond the pyEXP surface:
  kincoefs — kinematic Fourier series vs Bessel/Laguerre/ring radial
             sets (psp2bess/psp2lagu/psp2rings formats)
  diskeof  — empirical re-orthogonalization of a disk basis from
             snapshots (diskeof.cc)
and, imported by name: field_basis (FieldBasis, behind OutVel), crossval,
wake (BiorthWake), orbit (SphericalOrbit) and units.

basis, field_basis, crossval, wake and diskeof run on the force's device
(CUDA unless the basis was built with another `device`); the others are
host NumPy/SciPy, as in exp_tpu.
"""

from exp_tpu_torch.analysis import basis, coefs, field, mssa, edmd, util  # noqa: F401
from exp_tpu_torch.analysis import kincoefs, diskeof  # noqa: F401
