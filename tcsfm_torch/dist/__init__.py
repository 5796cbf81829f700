"""Data parallelism over ranks (counterpart of ``tcsfm/dist``): the mesh
and batch sharding (``mesh``), the weak-scaling curve (``scaling``) and
the multi-rank dry run (``dryrun``)."""

from tcsfm_torch.dist.mesh import (  # noqa: F401
    Mesh,
    initialize_distributed,
    make_mesh,
    process_info,
    shard_batch,
    shard_process_local_batch,
)
