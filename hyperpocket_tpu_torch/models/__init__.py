"""Encoder, HyperNetwork, target network and FullModel as torch modules.

The names ``hyperpocket_tpu/models/__init__.py`` exports, where the port
has them: its functional ``init_*``/``*_forward`` pairs are the modules
``Encoder`` and ``HyperNetwork`` here.
"""

from hyperpocket_tpu_torch.models.encoder import Encoder, reparameterize
from hyperpocket_tpu_torch.models.full_model import FullModel
from hyperpocket_tpu_torch.models.hyper_network import HyperNetwork, target_weight_count
from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward

__all__ = [
    "Encoder",
    "reparameterize",
    "HyperNetwork",
    "target_weight_count",
    "batched_target_network_forward",
    "FullModel",
]
