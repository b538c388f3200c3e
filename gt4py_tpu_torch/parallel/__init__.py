"""Distributed domain decomposition over the ranks of a ``torch.distributed``
job.

Counterpart of ``gt4py_tpu.parallel``, with one rank a process (how
PyTorch runs SPMD) in place of the JAX package's devices of one process:

- ``CartesianMesh``: the job's ranks as a (px, py) mesh ("x" -> I,
  "y" -> J), with the wire chosen explicitly (NCCL, or gloo);
- explicit path: ``halo_exchange`` swaps halos with point-to-point
  messages; ``shard_map_stencil`` and ``overlapped_shard_map_stencil``
  wrap a local step over the rank's blocks;
- global view: ``distribute`` gives each rank its ``DistributedField``
  block, stencils called on them compute the global domain's result, and
  ``gather`` assembles the whole array.

K (vertical) stays on each rank: serial scans need the whole column.
"""

from .mesh import CartesianMesh, initialize_multihost  # noqa: F401
from .halo import (  # noqa: F401
    LAST_EXCHANGE,
    from_extended,
    halo_comm_bytes,
    halo_exchange,
    overlapped_shard_map_stencil,
    shard_map_stencil,
    to_extended,
)
from .distributed import DistributedField, FieldSharding, distribute, gather  # noqa: F401
