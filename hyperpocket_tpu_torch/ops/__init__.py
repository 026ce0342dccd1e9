"""Point-cloud ops of the port: Chamfer, NN distance, approximate EMD, sampling, decode.

The counterparts of ``hyperpocket_tpu/ops/__init__.py``'s public names, plus
``chamfer_loss_fused``, ``decode_batch``, ``decode_batch_grad`` (the
training decode's backward) and ``adam_lowp_update`` (the optimizer's pass,
``ops/adam_lowp.py``). CUDA tensors go to the
hand-written kernels (built at their first launch, not at import), CPU
tensors to their plain versions. ``launch_counters`` (not a JAX name, so
not in ``__all__``) lists every kernel wrapper's launch count.
"""

from hyperpocket_tpu_torch.ops.adam_lowp import adam_lowp_update
from hyperpocket_tpu_torch.ops.chamfer import (
    batch_pairwise_sqdist,
    chamfer_loss,
    chamfer_per_cloud,
    nn_distance,
)
from hyperpocket_tpu_torch.ops.decoder import decode_batch, decode_batch_grad
from hyperpocket_tpu_torch.ops.emd import (
    approx_match,
    earth_mover_distance,
    match_cost,
    match_cost_bwd_kernel,
    match_cost_fwd_kernel,
)
from hyperpocket_tpu_torch.ops.head_adam import head_adam_update
from hyperpocket_tpu_torch.ops.nn import (
    chamfer_loss_auto,
    chamfer_loss_fused,
    chamfer_loss_grad,
    chamfer_loss_streaming,
    nn_distance_pallas,
    nn_fused_planes,
    nn_min_fused,
    nn_one_direction,
)
from hyperpocket_tpu_torch.ops.sampling import (
    generate_target_network_input,
    progressive_normalize,
    sample_uniform_ball,
)
from hyperpocket_tpu_torch.ops.trunk_pool import trunk_pooled, trunk_pooled_argmax


def launch_counters() -> list[tuple[object, str]]:
    """Every kernel wrapper's launch count, as (wrapper, attribute): each
    wrapper adds one where it launches its kernel (a launch recorded into a
    CUDA graph included; ``train/epoch_scan.py`` takes those back and adds
    them per replay)."""
    counters = [(k, "launches") for k in (
        trunk_pooled, trunk_pooled_argmax, nn_one_direction, nn_min_fused, nn_fused_planes,
        chamfer_loss_grad, match_cost_fwd_kernel, match_cost_bwd_kernel, head_adam_update,
        decode_batch, decode_batch_grad, adam_lowp_update)]
    return [*counters, (decode_batch, "launches_bf16_simt")]


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
    "sample_uniform_ball",
    "progressive_normalize",
    "generate_target_network_input",
    "decode_batch",
]
