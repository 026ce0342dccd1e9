"""Experiments mode: the generative metrics and the experiment registry.

The names ``hyperpocket_tpu/eval/__init__.py`` exports.
"""

from hyperpocket_tpu_torch.eval.metrics import (
    EMD_CD,
    compute_all_metrics,
    jsd_between_point_cloud_sets,
    mmd_cov,
    pairwise_emd_cd,
)

__all__ = [
    "EMD_CD",
    "compute_all_metrics",
    "jsd_between_point_cloud_sets",
    "mmd_cov",
    "pairwise_emd_cd",
]
