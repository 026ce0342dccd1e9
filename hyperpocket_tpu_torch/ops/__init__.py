"""Point-cloud ops of the port: Chamfer, NN distance, approximate EMD, sampling, decode.

The counterparts of ``hyperpocket_tpu/ops/__init__.py``'s public names, plus
``chamfer_loss_fused`` and ``decode_batch``. CUDA tensors go to the
hand-written kernels (built at their first launch, not at import), CPU
tensors to their plain versions.
"""

from hyperpocket_tpu_torch.ops.chamfer import (
    batch_pairwise_sqdist,
    chamfer_loss,
    chamfer_per_cloud,
    nn_distance,
)
from hyperpocket_tpu_torch.ops.decoder import decode_batch
from hyperpocket_tpu_torch.ops.emd import approx_match, earth_mover_distance, match_cost
from hyperpocket_tpu_torch.ops.nn import (
    chamfer_loss_auto,
    chamfer_loss_fused,
    chamfer_loss_streaming,
    nn_distance_pallas,
)
from hyperpocket_tpu_torch.ops.sampling import progressive_normalize

__all__ = [
    "batch_pairwise_sqdist",
    "chamfer_loss",
    "chamfer_per_cloud",
    "nn_distance",
    "approx_match",
    "match_cost",
    "earth_mover_distance",
    "chamfer_loss_auto",
    "chamfer_loss_streaming",
    "chamfer_loss_fused",
    "nn_distance_pallas",
    "progressive_normalize",
    "decode_batch",
]
