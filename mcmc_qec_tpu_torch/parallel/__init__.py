"""Multi-device runs of the port (counterpart of ``mcmc_qec_tpu/parallel``):
a device mesh over the syndrome batch (``mesh.py``) and one rank per card
on ``torch.distributed`` (``multihost.py``)."""

from .mesh import Mesh, make_mesh, map_shards, pad_to_multiple, replicate, shard_batch
from .multihost import (
    allgather_rows,
    distributed_generate,
    global_sum,
    host_shard,
    init_distributed,
)
