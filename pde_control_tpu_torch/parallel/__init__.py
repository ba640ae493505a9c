"""Data parallelism and spatial domain decomposition over torch.distributed.

Counterpart of `pde_control_tpu/parallel/`: `mesh.py` (the batch split
over ranks), `spatial.py` (one 2D grid split along H over ranks, forward
and backward), `spatial_opt.py` (the adjoint through the split step) and
`spatial3d.py` (one volume split along z over ranks, forward and
backward).
"""

from pde_control_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate,
    shard_batch,
    shard_batch_multi,
)
