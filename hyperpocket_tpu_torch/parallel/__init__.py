"""Parallelism over a ``torch.distributed`` group, one process per device:
DP over the batch, optional TP over the hypernetwork's widest matmul pair,
and a ring that shards the point axis of the NN distance."""

from hyperpocket_tpu_torch.parallel.distributed import (
    initialize_multihost,
    local_batch_slice,
    rank,
    rank_device,
    world_size,
)
from hyperpocket_tpu_torch.parallel.mesh import (
    make_mesh,
    param_shardings,
    replicate,
    shard_batch,
)
from hyperpocket_tpu_torch.parallel.point_sharding import (
    chamfer_loss_point_sharded,
    nn_distance_point_sharded,
)

__all__ = [
    "make_mesh",
    "param_shardings",
    "shard_batch",
    "replicate",
    "chamfer_loss_point_sharded",
    "nn_distance_point_sharded",
    "initialize_multihost",
    "local_batch_slice",
    "rank",
    "rank_device",
    "world_size",
]
