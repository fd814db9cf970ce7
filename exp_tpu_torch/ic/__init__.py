"""Initial conditions: host NumPy draws with exp_tpu's seeds, and the
projections, field grids and DF evaluations that need tensors on the
caller's device (the exports of exp_tpu/ic/__init__.py)."""

from exp_tpu_torch.ic.eddington import EddingtonDF, sample_spherical_model
from exp_tpu_torch.ic.diskhalo import (diskhalo_ics, build_disk_tables,
                                       sample_multimass_halo, virial_ratio)
from exp_tpu_torch.ic.qpdistf import QPDistF, sample_qp_model
from exp_tpu_torch.ic.zang import TaperedMestelDF, sample_zang_disk
from exp_tpu_torch.ic.ellip import EllipForce, add_ellip_to_model
from exp_tpu_torch.ic.diskhalo2d import diskhalo2d_ics, add_disk2d_to_model
