"""Datasets, loader, slicer and PLY I/O (numpy, no framework).

The names ``hyperpocket_tpu/data/__init__.py`` exports, where the port has
them: the name-dispatched dataset factory, the batch loader, PLY I/O of
clouds and of whole files of elements, the plane slicer and the category
mapping.
"""

from hyperpocket_tpu_torch.data.base import get_datasets
from hyperpocket_tpu_torch.data.category_mapping import (
    category_to_synth_id,
    synth_id_to_category,
    synth_id_to_number,
)
from hyperpocket_tpu_torch.data.loader import BatchLoader
from hyperpocket_tpu_torch.data.plyio import (
    ListProperty,
    load_ply,
    load_ply_elements,
    save_ply,
    save_ply_elements,
)
from hyperpocket_tpu_torch.data.slicer import HyperPlane, slice_point_cloud

__all__ = [
    "get_datasets",
    "BatchLoader",
    "ListProperty",
    "load_ply",
    "load_ply_elements",
    "save_ply",
    "save_ply_elements",
    "HyperPlane",
    "slice_point_cloud",
    "synth_id_to_category",
    "category_to_synth_id",
    "synth_id_to_number",
]
