"""The distribution layer of the port (port of exp_tpu/parallel/).

One process per device, joined in a torch.distributed process group (NCCL
between cards, gloo on the CPU or for several ranks on one card).  Each
rank holds one contiguous row block of every component's particle array
and keeps its particles; every global quantity (coefficients, diagnostics,
level counts, the relevel's figures) is one all-reduce (SUM) over the
group, the reference's MPI_Allreduce (SphericalBasis.cc:871-896).

`World` is the counterpart of exp_tpu's `particle_mesh` / `axis_name`: the
port passes it where exp_tpu passes a mesh.  `world_coefficients` sums a
force's coefficients over it; the direct force's `acceleration` takes it
as its `group` for the ring.  A world of one rank, or None, reduces
nothing.
"""

from __future__ import annotations

from exp_tpu_torch.parallel.distributed import (  # noqa: F401
    World, all_reduce, allgather_ps, allgather_rows, broadcast_object,
    current_world, finalize_distributed, init_distributed, is_primary,
    pad_global_count, primary_build, ps_from_local, read_bodies_distributed,
    row_block, sum_host, world_coefficients)
