"""pyEXP-compatible API surface (port of exp_tpu/pyexp).

Drop-in namespace mirroring the reference's pybind11 module layout
(pyEXP/PyWrappers.cc:103-135: submodules read, basis, coefs, field,
mssa, edmd, util) with the reference's METHOD NAMES (camelCase),
delegating to the port's snake_case analysis library:

    import exp_tpu_torch.pyexp as pyEXP

    reader = pyEXP.read.ParticleReader.createReader('PSPout', files)
    basis  = pyEXP.basis.Basis.factory(yaml_config)
    coefs  = basis.createFromReader(reader)
    ssa    = pyEXP.mssa.expMSSA({'halo': (coefs, keys, [])}, 100, 10)
    fields = pyEXP.field.FieldGenerator(times, pmin, pmax, grid)

The snake_case exp_tpu_torch.analysis / exp_tpu_torch.io modules remain
the primary API; this layer exists so reference users can port scripts
with minimal edits.  Where the reference semantics are MPI-specific the
compat functions are no-ops with docstrings saying so (e.g. util.setMPI).

The boundary is NumPy, as the reference's pybind11 API is: arguments and
results are NumPy arrays and Python scalars, and the user's callables
(setSelector's functor, addPSFunction, makeFromFunction's density,
AccelFunc.F) get NumPy arrays.  Tensors live inside the analysis layer,
which uploads each array once to the basis's device and downloads each
result once.  A basis runs on the CUDA card unless `device=` names
another (Basis.factory, FieldBasis, VelocityBasis); with no card and no
device named it raises.  Under `backend: pallas` a projection launches
the coefficient kernel (K1 sphere, K4 cylinder) and a field evaluation
the force kernel (K2, K5).

HDF5 paths (Coefs.factory / WriteH5Coefs / ExtendH5Coefs,
Basis.cacheInfo / writeCoefCovariance, CovarianceReader) import h5py when
called, and expMSSA.wcorrPNG imports matplotlib when called; without the
package they raise ImportError.
"""

from . import read, basis, coefs, field, mssa, edmd, util  # noqa: F401

__all__ = ["read", "basis", "coefs", "field", "mssa", "edmd", "util"]
